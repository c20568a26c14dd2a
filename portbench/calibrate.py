"""Readings that set a cell's limits (see ``README.md``, "How the limits
were set"): the numbers the check compares, read on sound runs of the
program over many seeds, on the control (the program's own lower-precision
path, or the reference computed a step below the configuration's
precision) and on planted faults, all at the cell's own size and in one
process so that each seed pays one set-up.  The benchmark's runs never run
this.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] --out <file.jsonl>

Each line of ``--out`` (and of standard output) is one reading:
``{"workload", "seed", "variant", "checks": {name: value}}``; variants
are ``program``, ``control`` and, for training cells, ``half_batch`` (the
loss taken over half of each batch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def memo_reference(cell: harness.Cell):
    """The cell's reference module with ``train_readings`` remembered per
    set of batches, so that the variants of one seed share one reference
    run."""
    module = cell.reference()
    if hasattr(module, "train_readings"):
        inner, memo = module.train_readings, {}

        def train_readings(cfg, w0, batches, *args, **kwargs):
            key = b"".join(b["tokens"].tobytes() for b in batches)
            if key not in memo:
                memo[key] = inner(cfg, w0, batches, *args, **kwargs)
            return memo[key]
        module.train_readings = train_readings
    return lambda: module


def half_batch():
    """Plants the fault "half of the batch left out, the mean taken over
    the rest" in the port's model bundle; returns the undo."""
    import repro_torch.models as models
    inner = models.build_model

    def build_model(*args, **kwargs):
        bundle = inner(*args, **kwargs)
        loss = bundle.loss_fn

        def half(params, batch):
            return loss(params, {k: v[:v.shape[0] // 2]
                                 for k, v in batch.items()})
        return dataclasses.replace(bundle, loss_fn=half)
    models.build_model = build_model
    return lambda: setattr(models, "build_model", inner)


def readings(cell, seed: int, variant: str, seconds: float, device) -> dict:
    """One run's compared numbers under ``variant``."""
    spans = harness.Spans()
    undo = half_batch() if variant == "half_batch" else (lambda: None)
    mix = cell.mix
    try:
        if variant == "control" and mix["driver"] == "train":
            cell.mix = dict(mix, options=dict(mix["options"],
                                              compress_grads=True))
        driver = cell.driver().Driver(cell, seed, device, spans)
    finally:
        cell.mix = mix
        undo()
    if seconds > 0 and mix["driver"] != "train":
        harness.run_window(driver.unit, seconds, first=driver.units_done)
    driver.finish()
    if variant == "control" and mix["driver"] == "prefill":
        driver.check()
        ctrl, _ = driver.served_logits("fp8")
        picked = driver.ref_logits.gather(
            -1, ctrl.argmax(-1, keepdim=True))[..., 0]
        gap = float((driver.ref_logits.amax(-1) - picked).max())
        checks = {"logit_gap": (gap, None)}
    else:
        checks = driver.check()[0]
    return {k: v for k, (v, _) in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                        args.workload)
    cell.reference = memo_reference(cell)
    runs = [(int(s), "program") for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = ["half_batch"] if cell.mix["driver"] == "train" else []
    for s in controls:
        runs += [(s, "control")] + [(s, f) for f in faults]
    with open(args.out, "a") as out:
        for seed, variant in runs:
            t0 = time.perf_counter()
            line = {"workload": cell.name, "seed": seed, "variant": variant,
                    "checks": readings(cell, seed, variant, args.seconds,
                                       device),
                    "seconds": time.perf_counter() - t0}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
