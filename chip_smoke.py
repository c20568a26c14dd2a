#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases kernel  # environment + kernel phase only

Phases, each printing one JSON line:

1. ``env``: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel from ``src/repro_torch/csrc`` (nvcc for sm_90a).
2. ``kernel``: each kernel against its plain PyTorch version on the card,
   exact, at the shapes the main path gives it plus ragged and edge shapes,
   with CUDA-event times and the least time the card could take (bound).
3. ``parity``: the single-table loop at 20,000 rows x 8 columns and 1,500
   queries under OREO, Static, Greedy and Regret, on the card and on the
   CPU; the traces must be bitwise equal.
4. ``full``: the ``tpch-sf10-oreo`` cell -- OREO and Static over a
   59,986,052-row x 32-column TPC-H-like table (lineitem at scale factor 10)
   on the card, 12,000 queries of 16 templates, alpha = 80, P = 32.  Kernel
   launch counts are reset just before and read just after.

Then the kernels' summary line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits 2 before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP64_OPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores

FULL_ROWS = 59_986_052        # TPC-H lineitem cardinality at SF 10
FULL_COLUMNS = 32
FULL_QUERIES = 12_000
MIN_QUERIES = 3_000
SEGMENTS = 12
TEMPLATES = 16
ALPHA = 80.0
PARTITIONS = 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def scan_bound(q: int, p: int, c: int) -> dict:
    """Least time for a (Q, P, C) scan: each input read once, the output
    written once, 3 float64 operations (two compares, one AND) per
    (q, p, c)."""
    nbytes = (2 * q * c + 2 * p * c) * 8 + q * p
    ops = 3 * q * p * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_operands(rng, q: int, p: int, c: int, device, row_pad: int = 0):
    """Zone maps and query bounds with +-inf, empty partitions and bounds
    equal to zone-map ends; ``row_pad`` > 0 makes the partition operands a
    row-strided view of a wider plane."""
    import numpy as np
    import torch
    mins = rng.uniform(0, 100, (p, c))
    maxs = mins + rng.uniform(0, 30, (p, c))
    empty = rng.random(p) < 0.1
    mins[empty], maxs[empty] = np.inf, -np.inf
    lo = rng.uniform(-10, 110, (q, c))
    hi = lo + rng.uniform(0, 40, (q, c))
    if p and c:
        pick = rng.integers(0, p, (q, c))
        cols = np.broadcast_to(np.arange(c), (q, c))
        at_min = rng.random((q, c)) < 0.15
        at_max = rng.random((q, c)) < 0.15
        hi[at_min] = mins[pick, cols][at_min]
        lo[at_max] = maxs[pick, cols][at_max]
    lo[rng.random((q, c)) < 0.4] = -np.inf
    hi[rng.random((q, c)) < 0.4] = np.inf

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    if row_pad:
        wide_min = torch.zeros((p, c + row_pad), dtype=torch.float64,
                               device=device)
        wide_max = torch.zeros_like(wide_min)
        wide_min[:, :c], wide_max[:, :c] = dev(mins), dev(maxs)
        return dev(lo), dev(hi), wide_min[:, :c], wide_max[:, :c]
    return dev(lo), dev(hi), dev(mins), dev(maxs)


def phase_kernel(device) -> dict:
    """Kernel against plain version over the listed shapes; returns the
    summary of the main path's dominant shape (1 x 9*32 x 32)."""
    import numpy as np
    import torch
    from repro_torch.kernels.pruning import pruning, ref
    rng = np.random.default_rng(0)
    shapes = [  # (name, Q, P, C, row_pad)
        ("state_matrix 1 x n*P_cap", 1, 288, 32, 0),
        ("serve 1 x P", 1, 32, 32, 0),
        ("cost_vectors 64 x P", 64, 32, 32, 0),
        ("greedy window 200 x P", 200, 32, 32, 0),
        ("serve_block 1000 x P", 1000, 32, 32, 0),
        ("batch 2048 x P", 2048, 32, 32, 0),
        ("ragged", 1000, 37, 5, 0),
        ("zero columns", 16, 40, 0, 0),
        ("row-strided plane view", 64, 288, 32, 3),
    ]
    fn = pruning._kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    results = []
    for name, q, p, c, pad in shapes:
        lo, hi, mins, maxs = scan_operands(rng, q, p, c, device, pad)
        got = pruning.scan_matrix(lo, hi, mins, maxs)
        want = ref.scan_matrix(lo, hi, mins, maxs)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        if not torch.equal(got, want):
            raise AssertionError(f"pruning kernel disagrees at {name} "
                                 f"({q}, {p}, {c}): max abs err {err}")
        out = torch.empty((q, p), dtype=torch.bool, device=device)
        stride = mins.stride(0) if p > 1 and c else c

        def raw():
            fn(lo.data_ptr(), hi.data_ptr(), c, mins.data_ptr(),
               maxs.data_ptr(), stride, out.data_ptr(), q, p, c, stream)
        row = {"shape": name, "q": q, "p": p, "c": c,
               "row_stride": stride, "equal": True, "max_abs_err": err,
               "ms": cuda_time_ms(raw, 200),
               "wrapper_ms": cuda_time_ms(
                   lambda: pruning.scan_matrix(lo, hi, mins, maxs), 200),
               "plain_ms": cuda_time_ms(
                   lambda: ref.scan_matrix(lo, hi, mins, maxs), 200),
               **scan_bound(q, p, c)}
        results.append(row)
        emit("kernel", kernel="pruning.scan_matrix", **row)
    main = results[0]
    return {"name": "pruning.scan_matrix", "route": "cuda",
            "source": "src/repro_torch/csrc/pruning.cu",
            "replaces": "src/repro/kernels/pruning/pruning.py:86",
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None}


class TimedGenerator:
    """A layout generator that sums the wall seconds of its builds (each
    build ends in a device-to-host copy, so the time is the device's too)."""

    def __init__(self, gen):
        self.gen, self.seconds, self.calls = gen, 0.0, 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        layout = self.gen(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return layout


class EstimateAudit:
    """Checks every ``every``-th state estimate of a run, inside the run.

    The scan that the main path's own launch returned for the plane's
    ``(n * P_cap, C)`` row-strided view is held against the plain version
    on CPU copies of the same plane rows, and the costs against a per-state
    numpy reduction of it.  It launches nothing itself, so the kernel's
    launch count stays the main path's.
    """

    def __init__(self, matrix, every: int):
        self.matrix, self.every = matrix, every
        self.calls = self.checked = 0
        self._last = None
        self._inner_scanned, self._inner_estimate = (matrix._scanned,
                                                     matrix.estimate)
        matrix._scanned, matrix.estimate = self._scanned, self._estimate

    def _scanned(self, q_lo, q_hi):
        self._last = self._inner_scanned(q_lo, q_hi)
        return self._last

    def _estimate(self, q_lo, q_hi):
        self._last = None
        got = self._inner_estimate(q_lo, q_hi)
        self.calls += 1
        if self.calls % self.every == 0 and self._last is not None:
            self.check(q_lo, q_hi, self._last, got)
            self.checked += 1
        return got

    def check(self, q_lo, q_hi, scanned, got) -> None:
        import numpy as np
        import torch
        from repro_torch.kernels.pruning import ref
        m = self.matrix
        n, c = len(m), m.num_columns
        want = ref.scan_matrix(
            torch.as_tensor(q_lo)[None], torch.as_tensor(q_hi)[None],
            m._mins[:n].cpu().reshape(-1, c),
            m._maxs[:n].cpu().reshape(-1, c)).reshape(n, -1).numpy()
        if not np.array_equal(scanned, want):
            raise AssertionError(f"full: kernel scan of the {n}-state plane "
                                 f"differs from the plain version at "
                                 f"estimate {self.calls}")
        costs = np.empty(n)
        for s, sid in enumerate(m.state_ids):
            meta = m.metadata(sid)
            costs[s] = (np.einsum("p,p->", want[s, :meta.num_partitions],
                                  meta.rows_host)
                        / max(meta.total_rows, 1))
        if not np.array_equal(got, costs):
            raise AssertionError(f"full: state estimates differ from numpy "
                                 f"at estimate {self.calls}: "
                                 f"{np.abs(got - costs).max()}")


def policies(data, stream, alpha, parts, gen=None):
    """Makers of the four online methods over ``data`` (a tensor on its
    device)."""
    from repro_torch import core, engine
    gen = gen or core.make_generator("qdtree")
    mgr = core.LayoutManagerConfig(target_partitions=parts)
    cfg = core.OreoConfig(alpha=alpha, manager=mgr)
    initial = core.build_default_layout
    return {
        "OREO": lambda: engine.OreoPolicy(
            data, initial(0, data, parts), gen, cfg),
        "Static": lambda: engine.StaticPolicy(
            data, stream, gen, alpha, target_partitions=parts),
        "Greedy": lambda: engine.GreedyPolicy(
            data, initial(0, data, parts), gen, alpha, mgr_cfg=mgr),
        "Regret": lambda: engine.RegretPolicy(
            data, initial(0, data, parts), gen, alpha, mgr_cfg=mgr),
    }


def phase_parity(device) -> None:
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.pruning import pruning
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 100, size=(20_000, 8))
    templates = core.make_templates(4, 8, rng)
    stream = core.generate_workload(templates, table.min(0), table.max(0),
                                    total_queries=1500, seed=1,
                                    segment_length=(300, 500))
    traces = {}
    launches = 0
    for dev in (device, torch.device("cpu")):
        data = torch.as_tensor(table, device=dev)
        pruning.scan_matrix.launches = 0
        for name, make in policies(data, stream, 40.0, 16).items():
            t0 = time.perf_counter()
            res = engine.LayoutEngine(make(), engine.InMemoryBackend(data)
                                      ).run(stream)
            traces[dev.type, name] = (res, time.perf_counter() - t0)
        if dev.type == "cuda":
            launches = pruning.scan_matrix.launches
            if launches <= 0:
                raise AssertionError("parity: the card run never launched "
                                     "the pruning kernel")
    for name in ("OREO", "Static", "Greedy", "Regret"):
        (a, ta), (b, tb) = traces["cuda", name], traces["cpu", name]
        same = (np.array_equal(a.query_costs, b.query_costs)
                and a.reorg_indices == b.reorg_indices
                and np.array_equal(a.state_seq, b.state_seq))
        emit("parity", policy=name, bitwise_equal=same,
             total_cost=a.total_cost, moves=a.num_reorgs,
             card_seconds=ta, cpu_seconds=tb)
        if not same:
            raise AssertionError(f"parity: {name} trace differs card vs CPU")
    emit("parity", kernel_launches_card=launches)


def phase_full(device, total_queries: int, rows: int = FULL_ROWS) -> int:
    """The tpch-sf10-oreo cell; returns the kernel launches of its run."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.data import build_table
    from repro_torch.kernels.pruning import pruning, ref
    if total_queries < MIN_QUERIES:
        raise ValueError(f"--queries below {MIN_QUERIES}")
    if total_queries != FULL_QUERIES:
        emit("full", cut=f"queries {FULL_QUERIES} -> {total_queries}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    data = build_table(rows, FULL_COLUMNS, seed=0, device=device)
    torch.cuda.synchronize()
    table_seconds = time.perf_counter() - t0
    rng = np.random.default_rng(10)
    templates = core.make_templates(TEMPLATES, FULL_COLUMNS, rng,
                                    cols_per_template=(1, 2),
                                    selectivity_range=(0.02, 0.10))
    stream = core.generate_workload(
        templates, data.amin(dim=0).cpu().numpy(),
        data.amax(dim=0).cpu().numpy(), total_queries=total_queries,
        seed=20, num_segments=SEGMENTS)
    emit("full", cell="tpch-sf10-oreo", rows=rows, columns=FULL_COLUMNS,
         queries=total_queries, alpha=ALPHA, partitions=PARTITIONS,
         table_bytes=data.numel() * 8, table_seconds=table_seconds,
         peak_bytes=torch.cuda.max_memory_allocated(device))
    peaks = [torch.cuda.max_memory_allocated(device)]
    results, bound = {}, {}
    pruning.scan_matrix.launches = 0
    for name in ("OREO", "Static"):
        gen = TimedGenerator(core.make_generator("qdtree"))
        make = policies(data, stream, ALPHA, PARTITIONS, gen=gen)[name]
        torch.cuda.reset_peak_memory_stats(device)
        before = pruning.scan_matrix.launches
        t0 = time.perf_counter()
        policy = make()
        backend = engine.InMemoryBackend(data)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        audit = EstimateAudit(backend.state_matrix, every=100)
        t0 = time.perf_counter()
        res = engine.LayoutEngine(policy, backend).run(stream)
        run_wall = time.perf_counter() - t0
        launches = pruning.scan_matrix.launches - before
        costs = res.query_costs
        if not (len(costs) == total_queries and np.isfinite(costs).all()
                and (costs >= 0).all() and (costs <= 1).all()
                and len(res.state_seq) == total_queries):
            raise AssertionError(f"full: {name} trace malformed")
        if name == "OREO" and audit.checked < total_queries // 100:
            raise AssertionError(f"full: only {audit.checked} of OREO's "
                                 f"estimates were checked")
        results[name] = res
        bound[name] = policy
        peaks.append(torch.cuda.max_memory_allocated(device))
        emit("full", policy=name, total_cost=res.total_cost,
             query_cost=res.total_query_cost,
             reorg_cost=res.total_reorg_cost, moves=res.num_reorgs,
             setup_seconds=setup, decide_seconds=res.decide_seconds,
             reorg_seconds=res.reorg_seconds,
             serve_seconds=res.serve_seconds, run_wall_seconds=run_wall,
             kernel_launches=launches,
             launches_per_query=launches / total_queries,
             estimates=audit.calls, estimates_checked=audit.checked,
             qdtree_builds=gen.calls, qdtree_build_seconds=gen.seconds,
             peak_bytes=torch.cuda.max_memory_allocated(device),
             info={k: v for k, v in res.info.items()
                   if isinstance(v, (int, float))})
        if name == "Static":
            # Every query was served by the one materialized layout:
            # recompute its costs with the plain version on the host.
            meta = backend.serving_layout.true_meta
            q_lo, q_hi = core.stack_queries(stream.queries)
            scanned = ref.scan_matrix(torch.as_tensor(q_lo),
                                      torch.as_tensor(q_hi),
                                      meta.mins.cpu(), meta.maxs.cpu())
            want = (core.layouts.scanned_dot(scanned.numpy(),
                                             meta.rows_host)
                    / max(meta.total_rows, 1))
            if not np.array_equal(want, costs):
                raise AssertionError("full: Static serve costs differ from "
                                     "the host recomputation")
    launches = pruning.scan_matrix.launches
    emit("full", stage_peaks=stage_peaks(device, data, stream,
                                         bound["OREO"]))
    oreo, static = results["OREO"], results["Static"]
    emit("full", oreo_vs_static_pct=100.0 * (static.total_cost
                                             - oreo.total_cost)
         / static.total_cost,
         kernel_launches=launches,
         max_memory_allocated=max(peaks), card=card_line())
    if launches <= 0:
        raise AssertionError("full: the main path never launched the "
                             "pruning kernel")
    return launches


def stage_peaks(device, data, stream, oreo_policy) -> dict:
    """Device memory above the resident table, and seconds, of each stage
    a run adds to it, measured alone: one candidate build, and one move
    (routing the full table through OREO's deepest tree, then its zone
    maps); and the largest partition of OREO's materialized layouts, as a
    share of the table's rows."""
    import torch
    from repro_torch.core import layouts, make_generator

    def measure(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"bytes": torch.cuda.max_memory_allocated(device) - base,
                     "seconds": time.perf_counter() - t0}
    window = stream.queries[:200]
    _, build = measure(lambda: make_generator("qdtree")(
        10_000, data, window, PARTITIONS))
    deepest = max((lay for lay in oreo_policy.manager.store.values()
                   if lay.technique == "qdtree"),
                  key=lambda lay: lay.route.depth)
    assignment, route = measure(lambda: deepest.route(data))
    _, zone_maps = measure(lambda: layouts.metadata_from_assignment(
        data, assignment, deepest.num_partitions))
    shares = [float(lay.true_meta.rows_host.max() / len(data))
              for lay in oreo_policy.manager.store.values()
              if lay.true_meta is not None]
    return {"qdtree_build": build, "route": {**route,
                                              "depth": deepest.route.depth},
            "zone_maps": zone_maps,
            "largest_partition_share": max(shares, default=None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernel,parity,full",
                    help="comma-separated subset of kernel,parity,full")
    ap.add_argument("--queries", type=int, default=FULL_QUERIES,
                    help=f"full-width query count (>= {MIN_QUERIES})")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _backend

    device = torch.device("cuda", 0)
    card = card_line()
    _backend.build()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         build_seconds=_backend.build_seconds,
         build_dir=str(_backend.build_dir().relative_to(ROOT)),
         ptxas={k: [ln for ln in v.splitlines() if "ptxas" in ln]
                for k, v in _backend.build_logs.items()})

    kernel = phase_kernel(device)
    if "parity" in phases:
        phase_parity(device)
    launches = None
    if "full" in phases:
        launches = phase_full(device, args.queries)
    kernel["launches"] = launches
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
