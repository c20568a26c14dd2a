#!/usr/bin/env python3
"""Where the chip script's kernel and family phases spend their seconds.

    python3 tools/phase_cost.py > phase_cost.json     # from the repo root

Needs one CUDA card.  Builds the kernels, then runs ``chip_smoke.py``'s
kernel phases (pruning, the fleet kernels, move_score, flash_attention and
its backward, zorder) and ``family_full`` with ``profile_window``,
``device_ms``, ``cuda_time_ms``, ``release``, ``profile_serve``,
``cell_embed_serve`` and ``cell_serve`` wrapped in timers.  Prints one
JSON object: each kernel phase's seconds with the running calls and
seconds of every timed helper, ``family_full``'s seconds, every profiler
window's seconds (``profile_window_each``), and one profiled loop of 200
small launches with the host's and the device's activities and with the
device's alone (its seconds and its first rows).  The phases print their
own JSON lines first, as the chip script does.
"""
import json
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "src")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _backend  # noqa: E402

stats = {}


def timed(name, fn):
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            stats.setdefault(name, []).append(time.perf_counter() - t0)
    return run


def main() -> int:
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("phase_cost: needs a CUDA device", file=sys.stderr)
        return 2
    _backend.build()
    dev = torch.device("cuda", 0)
    for name in ("profile_window", "device_ms", "cuda_time_ms", "release",
                 "profile_serve", "cell_embed_serve", "cell_serve"):
        setattr(cs, name, timed(name, getattr(cs, name)))
    out = {}
    for label, fn in (("pruning", cs.phase_kernel),
                      ("fleet", cs.phase_fleet_kernels),
                      ("move", cs.phase_move_score_kernel),
                      ("flash", cs.phase_flash_kernel),
                      ("bwd", cs.phase_flash_bwd_kernel),
                      ("zorder", cs.phase_zorder_kernel)):
        t0 = time.perf_counter()
        fn(dev)
        out[label] = time.perf_counter() - t0
        out[label + "_stats"] = {k: (len(v), sum(v))
                                 for k, v in stats.items()}
    cs.release(dev)
    t0 = time.perf_counter()
    cs.phase_family_full(dev)
    out["family_full"] = time.perf_counter() - t0
    out["final_stats"] = {k: (len(v), sum(v)) for k, v in stats.items()}
    out["profile_window_each"] = stats.get("profile_window", [])
    a = torch.randn(256, 256, device=dev)
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 [ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(200):
                a.add_(1.0)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, getattr(e, "self_device_time_total", None),
                 str(getattr(e, "device_type", "")))
                for e in prof.key_averages()]
        out[str([x.name for x in acts])] = {
            "seconds": time.perf_counter() - t0, "rows": rows[:6]}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
