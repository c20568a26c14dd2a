"""What every cell shares: finding a cell's files by name, seeds, the
benchmark's own spans, the measured window, the profiled segment and its
reading, and the check on what a run imported.

The benchmark times only from outside the program: a span is a host clock
around a call into one of the port's layers (and, in a traced run, a
``torch.profiler.record_function`` range of the same name), a window is a
host clock around whole units of work that each end in a synchronize.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: Top-level module names a run may not hold once its window has closed:
#: JAX and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: The label of the profiled segment's outer range.
SEGMENT = "traced_segment"


class BenchError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """The Python file ``path`` as a module of its own (its name may hold
    ``-`` and ``.``, so it is loaded by path, not imported by name)."""
    if not path.is_file():
        raise BenchError(f"{path.relative_to(ROOT)} is missing")
    name = "portbench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with its configuration, its traffic mix
    and the metrics ``BENCHMARK.json`` asks of it."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                             f"(there are {', '.join(sorted(cells))})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.mix = load_json(BENCH_DIR / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def driver(self):
        return load_file(BENCH_DIR / "drivers" / f"{self.mix['driver']}.py")

    def model(self):
        """The configuration's own file of the model as the benchmark
        builds it for the port (weights, parameters, model FLOPs)."""
        return load_file(BENCH_DIR / "configs"
                         / f"{self.workload['config']}.py")

    def reference(self):
        return load_file(BENCH_DIR / "reference"
                         / f"{self.workload['config']}.py")

    def reader(self, metric: str):
        return load_file(BENCH_DIR / "metrics" / f"{metric}.py")


def seed_words(seed: int, stream: int) -> List[int]:
    """Entropy for ``numpy.random.SeedSequence``: any whole number as
    32-bit words, and the index of the stream drawn from it."""
    seed = int(seed)
    words = [stream, 1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    import numpy as np
    return int(np.random.SeedSequence(seed_words(seed, stream))
               .generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] & np.uint64((1 << 63) - 1))


def numpy_rng(seed: int, stream: int):
    import numpy as np
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, stream)))


class Spans:
    """Seconds and calls of the benchmark's spans around the port's layers.
    In a traced run a span is also a profiler range of the same name, so
    the trace can say what the host was doing while the device idled."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = contextlib.nullcontext()
        if self.tracing:
            import torch
            rng = torch.profiler.record_function(name)
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1

    def wrap(self, name: str, fn: Callable) -> Callable:
        def spanned(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return spanned

    def snapshot(self) -> Dict[str, tuple]:
        return {k: (self.seconds[k], self.calls[k]) for k in self.seconds}


def span_delta(before: Dict[str, tuple], after: Dict[str, tuple]
               ) -> Dict[str, tuple]:
    """Seconds and calls of each span between two snapshots."""
    return {k: (s - before.get(k, (0.0, 0))[0], c - before.get(k, (0.0, 0))[1])
            for k, (s, c) in after.items()}


def run_window(unit: Callable[[int], None], seconds: float,
               first: int = 0) -> tuple:
    """Whole units of work from ``first`` on until ``seconds`` have passed:
    (units run, seconds from the first unit's start to the last one's
    end).  Each unit ends in a synchronize, so the rate is of finished
    work over all the time of the window."""
    t0 = time.perf_counter()
    i = first
    while True:
        unit(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            return i - first, time.perf_counter() - t0


def profiled(unit: Callable[[int], None], first: int, count: int,
             spans: Spans) -> dict:
    """``count`` units from ``first`` under ``torch.profiler`` (CPU and
    CUDA activity), the spans turned into ranges; returns the reading of
    the trace (:func:`read_trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    spans.tracing = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(SEGMENT):
                for i in range(first, first + count):
                    unit(i)
                torch.cuda.synchronize()
    finally:
        spans.tracing = False
    return read_trace(prof.events(), set(spans.seconds))


def _union(intervals: List[tuple]) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def read_trace(events, labels: set) -> dict:
    """Device busy seconds (the union of every device activity's interval:
    kernels, copies and fills), the segment's seconds, seconds by device
    operation, and the idle gaps between device work, each labelled with
    the innermost benchmark span the host was in at the gap's middle
    (``host`` where it was in none)."""
    from torch.autograd import DeviceType
    device, ranges, segment = [], [], None
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name == SEGMENT:
            if e.device_type != DeviceType.CUDA:
                segment = (start, end)
        elif e.name in labels:
            # A range is also mirrored on the device's timeline (a user
            # annotation there): it is no device work.
            if e.device_type != DeviceType.CUDA:
                ranges.append((start, end, e.name))
        elif e.device_type == DeviceType.CUDA:
            device.append((start, end, e.name))
    if segment is None:
        raise BenchError("the profiled segment has no range in the trace")
    lo, hi = segment
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in device
              if e > lo and s < hi]
    busy = _union([(s, e) for s, e, _ in inside])
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        by_op[n] += (e - s) / 1e6
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        around = [(e - s, n) for s, e, n in ranges if s <= mid <= e]
        gaps[min(around)[1] if around else "host"] += (g1 - g0) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "device_s_by_op": dict(by_op),
            "breakdown": {
                "device_ops": [[n[:120], s] for n, s in top[:10]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}}


def device_seconds(trace: dict, names) -> Optional[float]:
    """Device seconds of the operations whose names hold one of ``names``
    (kernel function names); None where the trace holds none."""
    total = sum(s for op, s in trace["device_s_by_op"].items()
                if any(n in op for n in names))
    return total if total > 0 else None


class Recorder:
    """Stands in for a function of the port (a module attribute its
    callers look up at call time), calls it and, while ``on``, records
    ``shape(*args)`` of each call.  It keeps the attributes the function
    carries (its launch counters, which the function updates through its
    module's name for itself).  Installed once per module and name."""

    def __init__(self, inner: Callable, shape: Callable):
        self.__dict__.update(inner.__dict__)
        self.inner, self.shape = inner, shape
        self.on, self.calls = False, []

    def __call__(self, *args, **kwargs):
        if self.on:
            self.calls.append(self.shape(*args, **kwargs))
        return self.inner(*args, **kwargs)

    @classmethod
    def install(cls, module, name: str, shape: Callable) -> "Recorder":
        current = getattr(module, name)
        if not isinstance(current, cls):
            current = cls(current, shape)
            setattr(module, name, current)
        return current


def attention_shape(q, k, v, **kwargs) -> tuple:
    """(batch, queries, keys, query heads, kv heads, head dim) of a call of
    the port's ``layers.flash_attention`` (q, k, v as (B, T, H, dh))."""
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is one the benchmark may not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program in fixed directories
    inside the checkout, so that only a checkout's first run builds."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
