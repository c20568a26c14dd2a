"""Mesh context and activation sharding constraints for model code; the
counterpart of ``repro.models.sharding``.

Model code annotates activations with *logical* kinds (``"batch"``,
``"model"``, ``"fsdp"``, None); the launcher installs a mesh context over a
:class:`~torch.distributed.device_mesh.DeviceMesh` mapping batch-like dims
to the data axes (``"data"``, or ``("pod", "data")`` multi-pod) and the
tensor dim to ``"model"``.  Without a context (every path on one card, and
the CPU tests) each function here returns its input unchanged.

With a mesh, parameters and inputs are :class:`DTensor` s (2-D fsdp x
tensor sharding of the weights, as in the reference) and :func:`constrain`
redistributes an activation to the resolved placements, where the
reference calls ``with_sharding_constraint`` (and reduces the partial sums
of its gradient, as that constraint holds the cotangent).  A dimension
whose size its axes do not divide keeps the longest trailing run of them
that does (:func:`repro_torch.launch.mesh.placements`); the reference's
compiler pads it instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class MeshContext:
    mesh: Optional[object] = None          # a DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"      # param FSDP axis (None = off)
    seq_parallel: bool = False             # Megatron-style sequence parallelism


_CTX = MeshContext()


def set_mesh(mesh, batch_axes: Sequence[str] = ("data",),
             model_axis: str = "model",
             fsdp_axis: Optional[str] = "data",
             seq_parallel: bool = False) -> None:
    global _CTX
    _CTX = MeshContext(mesh, tuple(batch_axes), model_axis, fsdp_axis,
                       seq_parallel)


def get_ctx() -> MeshContext:
    return _CTX


@contextlib.contextmanager
def mesh_context(mesh, batch_axes: Sequence[str] = ("data",),
                 model_axis: str = "model",
                 fsdp_axis: Optional[str] = "data",
                 seq_parallel: bool = False):
    """The mesh context for the block.  With a mesh, a plain tensor that
    meets a :class:`DTensor` in an operation (positions, masks) counts as
    replicated (``implicit_replication``)."""
    global _CTX
    prev = _CTX
    set_mesh(mesh, batch_axes, model_axis, fsdp_axis, seq_parallel)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
    finally:
        _CTX = prev


def _resolve(kind) -> object:
    if kind is None:
        return None
    if kind == "batch":
        axes = _CTX.batch_axes
        return axes if len(axes) > 1 else axes[0]
    if kind == "model":
        return _CTX.model_axis
    if kind == "fsdp":
        return _CTX.fsdp_axis
    raise ValueError(f"unknown sharding kind {kind!r}")


def spec(*kinds) -> tuple:
    """A physical spec from logical kinds ('batch'|'model'|'fsdp'|None)."""
    return tuple(_resolve(k) for k in kinds)


def named(spec_: tuple, shape=None) -> Optional[tuple]:
    """The placements of the physical ``spec_`` on the context's mesh (the
    reference's ``NamedSharding``), None without a mesh."""
    if _CTX.mesh is None:
        return None
    from repro_torch.launch.mesh import placements
    return placements(spec_, _CTX.mesh, shape)


def is_sharded(x) -> bool:
    """Whether ``x`` is a :class:`DTensor` under a mesh context."""
    if _CTX.mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(x: torch.Tensor):
    """``x`` as a :class:`DTensor` on the context's mesh: a plain tensor
    is taken as replicated on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, _CTX.mesh,
                              [Replicate()] * _CTX.mesh.ndim,
                              run_check=False)


def zeros(shape, kinds, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``; under a mesh a :class:`DTensor` laid out by
    the logical ``kinds``."""
    if _CTX.mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros as dzeros
    return dzeros(shape, dtype=dtype, device_mesh=_CTX.mesh,
                  placements=named(spec(*kinds), shape))


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient comes back laid out as its input
    was, with every partial sum reduced.  (DTensor's own backward passes a
    partial-sum gradient on as it is, and a product behind it then gathers
    its whole weight to take it.)"""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        from torch.distributed.tensor import Replicate
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.back:
            grad = grad.redistribute(ctx.mesh, ctx.back)
        return grad, None, None


def constrain(x: torch.Tensor, *kinds) -> torch.Tensor:
    """Redistribute ``x`` to the placements of the logical ``kinds`` (its
    gradient comes back with every partial sum reduced, :class:`_Constrain`);
    returns ``x`` unchanged without a mesh."""
    if _CTX.mesh is None:
        return x
    x = as_dtensor(x)
    target = named(spec(*kinds), x.shape)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, _CTX.mesh, target)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(_CTX.mesh, target)


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream (B, T, d) constraint.  With sequence parallelism the
    T dim is sharded on the tensor axis (Megatron SP)."""
    if _CTX.mesh is None:
        return x
    return constrain(x, "batch", "model" if _CTX.seq_parallel else None,
                     None)


def split_last(x: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``x`` (..., n * size) as (..., n, size).  Under a mesh a last dim
    sharded over more devices than divide ``n`` is gathered first (the
    reference's compiler pads it instead)."""
    if is_sharded(x):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(x.ndim - 1)
        ways = 1
        for p, k in zip(x.placements, x.device_mesh.shape):
            ways *= k if p == last else 1
        if n % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == last else p for p in x.placements])
    return x.reshape(*x.shape[:-1], n, size)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, size) as (..., n * size).  Under a mesh the view runs
    through ``local_map``, so its gradient arrives laid out as the view's
    output is and never has to split a sharded dim (which DTensor refuses
    when the devices do not divide ``n``)."""
    if not is_sharded(x):
        return x.reshape(*x.shape[:-2], -1)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if Shard(x.ndim - 1) in x.placements:
        x = x.redistribute(x.device_mesh, [
            Replicate() if p == Shard(x.ndim - 1) else p
            for p in x.placements])
    pl = list(x.placements)
    f = local_map(lambda t: t.reshape(*t.shape[:-2], -1), out_placements=pl,
                  in_placements=(pl,), device_mesh=x.device_mesh)
    return f(x)


def batch_local(fn, batched: tuple, *rest, outputs: int = 2):
    """``fn(*batched, *rest)`` for an ``fn`` that treats the rows of a
    batch independently (a recurrence): every tensor of ``batched`` and
    each of its ``outputs`` outputs has the batch on dim 0.  Under a mesh
    it runs through ``local_map`` on each device's rows, every other dim
    whole and the tensors of ``rest`` replicated."""
    if not any(is_sharded(t) for t in batched):
        return fn(*batched, *rest)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = _CTX.mesh
    batched = [constrain(t, "batch", *[None] * (t.ndim - 1))
               for t in batched]
    pl = list(batched[0].placements)
    rep = [Replicate()] * mesh.ndim
    rest = [constrain(t, *[None] * t.ndim) if isinstance(t, torch.Tensor)
            else t for t in rest]
    in_pl = tuple([pl] * len(batched) + [
        rep if isinstance(t, torch.Tensor) else None for t in rest])
    f = local_map(fn, out_placements=tuple([pl] * outputs),
                  in_placements=in_pl, device_mesh=mesh)
    return f(*batched, *rest)


def sharded_embed_lookup(table: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather with a (vocab, d/|model|)-sharded table.

    Every device gathers full-vocab rows for its own d-slice through
    :func:`~torch.distributed.tensor.experimental.local_map`: no
    collective.  The output is (B, T, d) sharded (batch, None, model); a
    batch the data axes do not divide (long-context B = 1) is replicated.
    """
    if _CTX.mesh is None:
        return table[tokens.long()]
    from torch.distributed.tensor.experimental import local_map
    mesh = _CTX.mesh
    tokens = as_dtensor(tokens)
    batch = "batch"
    n_batch = 1
    for ax in _CTX.batch_axes:
        n_batch *= mesh.size(mesh.mesh_dim_names.index(ax))
    if tokens.shape[0] % n_batch:
        batch = None
    tok_pl = named(spec(batch, None))
    table_pl = named(spec(None, "model"))
    out_pl = named(spec(batch, None, "model"))
    f = local_map(lambda tbl, tok: tbl[tok.long()],
                  out_placements=list(out_pl),
                  in_placements=(table_pl, tok_pl), device_mesh=mesh,
                  redistribute_inputs=True)
    return f(as_dtensor(table), tokens)


def local_shard_range(x, dim: int) -> Tuple[int, int]:
    """The [start, stop) of ``x``'s global indices along ``dim`` that this
    rank holds (host bookkeeping: no dispatch mode sees it)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, x.placements)
    return offset[dim], offset[dim] + shape[dim]


def write_seq(cache: torch.Tensor, new: torch.Tensor, index: int,
              dim: int = 1) -> None:
    """``cache[:, index:index + T] = new`` along ``dim`` in place; on a
    :class:`DTensor` cache whose ``dim`` is sharded each rank writes the
    positions it holds (the reference's ``dynamic_update_slice``)."""
    if not is_sharded(cache):
        idx = (slice(None),) * dim + (slice(index, index + new.shape[dim]),)
        cache[idx] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(dim) else p for p in cache.placements]
    new = as_dtensor(new).redistribute(cache.device_mesh, pl).to_local()
    lo, hi = local_shard_range(cache, dim)
    start, stop = max(index, lo), min(index + new.shape[dim], hi)
    if start < stop:
        local = cache.to_local()
        dst = (slice(None),) * dim + (slice(start - lo, stop - lo),)
        src = (slice(None),) * dim + (slice(start - index, stop - index),)
        with torch.no_grad():
            local[dst] = new[src]
