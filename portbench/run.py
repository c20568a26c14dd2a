"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (CUDA, the kernels from the build cache, inputs and weights made
from ``--seed``, warm-up of the cell's shapes) runs first; then the window
measures whole units of work for ``--seconds``; with ``--trace 1`` a few
more units run under ``torch.profiler``.  Then the program's state is
freed and what the run produced is held against the plain reference.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which also close standard error).  Without a CUDA device, or with
fewer than the cell needs, it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def evaluate(checks: dict) -> bool:
    return all(harness.finite(v) and v <= lim for v, lim in checks.values())


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Set-up, window, profiled segment and check of one cell on
    ``device``; returns the result line's fields.  The command line runs
    it on the card; the CPU tests run it at a tiny size."""
    import torch
    spans = harness.Spans()
    before_driver = time.perf_counter() - t_start
    driver = cell.driver().Driver(cell, seed, device, spans)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: setup before the driver {before_driver:.3f} s; " +
          ", ".join(f"{k} {v:.3f} s" for k, v in spans.seconds.items()
                    if k.startswith("setup.")), file=sys.stderr)
    first = driver.units_done
    spans_before = spans.snapshot()
    units, elapsed = harness.run_window(driver.unit, seconds, first=first)
    window = {"units": units, "seconds": elapsed,
              "spans": harness.span_delta(spans_before, spans.snapshot()),
              **driver.window_work(first, units)}
    trace_out = None
    if trace:
        before = driver.counters()
        driver.begin_trace()
        trace_out = harness.profiled(driver.unit, driver.units_done,
                                     driver.traced_units, spans)
        after = driver.counters()
        trace_out["counters"] = {k: after[k] - before[k] for k in after}
        trace_out["calls"] = driver.end_trace()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    driver.finish()
    t_check = time.perf_counter()
    checks, attempted, failed = driver.check()
    print(f"portbench: setup_s {setup_s:.3f} window_s {elapsed:.3f} units "
          f"{units} check_s {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    correct = evaluate(checks)
    if trace:
        ctx = types.SimpleNamespace(cell=cell, config=cell.config,
                                    model=cell.model(), mix=cell.mix,
                                    window=window,
                                    trace=trace_out, spans=spans.snapshot())
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(driver.end_to_end(units, elapsed), setup_s=setup_s)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise harness.BenchError(f"{cell.name} does not report "
                                         f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "peak": peak, "trace": trace_out,
            "checks": checks}


def result_line(out: dict, kind: str, chips: int, card: str) -> dict:
    """The result line's object from :func:`run_cell`'s fields: the keys
    the contract names, ``checks`` last."""
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": kind, "count": chips,
                         "memory_peak_bytes": out["peak"], "card": card}}
    if out["trace"] is not None:
        result["device"].update(busy_s=out["trace"]["busy_s"],
                                window_s=out["trace"]["window_s"])
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = {k: {"value": v if harness.finite(v) else None,
                            "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    harness.set_cache_dirs()
    import torch
    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {cell.name} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT / "src"))
    import repro_torch  # noqa: F401  (fails where the program is absent)
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result = result_line(out, torch.cuda.get_device_name(device), chips,
                         card_power_limit())
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
