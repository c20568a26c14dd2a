"""Device selection and the build of the hand-written CUDA kernels.

Entry points of :mod:`repro_torch` run on the card unless the caller asks
for the CPU: :func:`resolve_device` turns ``device=None`` into ``cuda`` and
raises when no card is present, so nothing silently carries on on the host.

The kernels under ``repro_torch/csrc/`` have a plain C interface and are
bound through :mod:`ctypes`.  At first use every source is compiled by its
own ``nvcc`` process (all started together) into a shared library under
``build/repro_torch/<hash>/`` at the root of the checkout, where ``<hash>``
covers the sources and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Set ``REPRO_TORCH_BUILD_DIR`` to build
elsewhere.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Wall seconds the last :func:`build` spent compiling (0.0 when every
#: library was already built), and each compiled source's nvcc output
#: (registers, shared memory and spills per kernel, from ``-Xptxas -v``).
build_seconds = 0.0
build_logs: Dict[str, str] = {}


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card; a CUDA request without a card raises,
    except under a :class:`FakeTensorMode` (the dry run), whose CUDA
    tensors have no memory and launch nothing."""
    from torch._guards import detect_fake_mode
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and \
            detect_fake_mode() is None:
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev


def to_device(array, device: Union[None, str, torch.device] = None
              ) -> torch.Tensor:
    """A host array (or tensor) as a float64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(array, dtype=np.float64),
                           device=resolve_device(device))


def sources() -> list:
    """The sources ``nvcc`` compiles, one library each."""
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """The hash-keyed directory the current sources and headers build
    into."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = (Path(root) if root
            else CSRC.parents[2] / "build" / "repro_torch")
    return base / digest.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")]:
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile every source that has no library yet; returns the directory.

    One ``nvcc`` per source, all running at once; each writes a temporary
    file renamed into place, so concurrent builders never load a torn one.
    """
    global build_seconds
    out_dir = build_dir()
    todo = [s for s in sources()
            if not (out_dir / f"lib{s.stem}.so").exists()]
    build_seconds = 0.0
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        build_logs[src.name] = log
        if proc.returncode:
            failures.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
                _libs[name] = lib
    return lib


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

