"""Production meshes and logical -> physical sharding-spec resolution; the
counterpart of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model); the pod
axis extends data parallelism.

A logical spec is a plain tuple with one entry per tensor dimension, each
``None``, a logical axis (``"model"``, ``"fsdp"``, ``"batch"``,
``"seq2"``) or a tuple of them; :func:`resolve_spec` maps it onto the
physical mesh axes as the reference maps its ``PartitionSpec``\\ s, and
:func:`placements` turns a resolved spec into one
:class:`~torch.distributed.tensor.Shard` or
:class:`~torch.distributed.tensor.Replicate` per mesh dimension (where the
reference builds a ``NamedSharding``).

Importing this module touches no process group.  :func:`fake_world` opens
a ``fake`` process group of 256 or 512 ranks (no devices, no
communication: collectives return at once) and destroys it on exit;
:func:`make_production_mesh` builds a :class:`DeviceMesh` over the group
that is open, so the dry run enters ``fake_world`` first.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def mesh_shape(multi_pod: bool) -> Tuple[int, ...]:
    return MULTI_POD if multi_pod else SINGLE_POD


def mesh_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def world_size(multi_pod: bool) -> int:
    n = 1
    for s in mesh_shape(multi_pod):
        n *= s
    return n


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A ``fake`` process group of ``size`` ranks as the default group,
    this process rank 0, for the span of the block.  Refuses to replace a
    group that is already open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False, device=None):
    """A :class:`DeviceMesh` of :data:`SINGLE_POD` or :data:`MULTI_POD`
    named ``("data", "model")`` or ``("pod", "data", "model")`` over the
    open process group (:func:`fake_world` for the dry run); ``device``
    is the mesh's device type, the card's by default."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    return init_device_mesh(dev.type, mesh_shape(multi_pod),
                            mesh_dim_names=mesh_axes(multi_pod))


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


# ---------------------------------------------------------------------------
# Logical spec resolution.  Model code emits specs over the logical
# vocabulary {"model", "fsdp", "batch", "seq2", None}; this maps them onto
# the physical mesh axes.
#   model -> "model"                         (tensor/expert parallel)
#   fsdp  -> "data"                          (ZeRO-3 param sharding, in-pod)
#   batch -> ("pod","data") | "data"         (data parallel)
#   seq2  -> ("data","model")                (long-context KV sequence shard)
# ---------------------------------------------------------------------------

def _resolve_element(el, multi_pod: bool):
    if el is None:
        return None
    if isinstance(el, (tuple, list)):
        out = []
        for e in el:
            r = _resolve_element(e, multi_pod)
            if r is None:
                continue
            out.extend(r if isinstance(r, tuple) else (r,))
        return tuple(out) if out else None
    if el == "model":
        return "model"
    if el == "fsdp":
        return "data"
    if el == "batch":
        return ("pod", "data") if multi_pod else "data"
    if el == "seq2":
        return ("data", "model")
    raise ValueError(f"unknown logical axis {el!r}")


def resolve_spec(spec: tuple, multi_pod: bool) -> tuple:
    return tuple(_resolve_element(el, multi_pod) for el in spec)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def resolve_tree(tree, multi_pod: bool):
    """:func:`resolve_spec` over every spec of a tree of dicts."""
    if _is_spec(tree):
        return resolve_spec(tree, multi_pod)
    return {k: resolve_tree(v, multi_pod) for k, v in tree.items()}


def _axes(el) -> Tuple[str, ...]:
    if el is None:
        return ()
    return tuple(el) if isinstance(el, (tuple, list)) else (el,)


def placements(spec: tuple, mesh, shape=None) -> tuple:
    """One placement per dimension of ``mesh`` for the resolved ``spec``:
    ``Shard(d)`` on each mesh axis that tensor dimension ``d`` names,
    ``Replicate()`` on the others.  A dimension's axes shard it in the
    mesh's order (the first named is the major one, as in the reference).
    With ``shape``, a dimension whose size the product of its axes does
    not divide keeps only the longest trailing run of them that does,
    down to none (the reference's compiler pads such a dimension
    instead)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.mesh.shape))
    out = [Replicate()] * len(names)
    for d, el in enumerate(spec):
        axes = _axes(el)
        if shape is not None:
            while axes and shape[d] % _prod(sizes[a] for a in axes):
                axes = axes[1:]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"placements: mesh axis {names[i]!r} "
                                 f"shards two dims of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n

