"""Per-device FLOP, byte and collective counts of one step, counted op by
op; the counterpart of ``repro.launch.hlo_cost``.

The reference compiles a step with XLA and re-derives the roofline inputs
from the partitioned HLO text, because XLA's own ``cost_analysis`` visits
a loop body once.  Here there is no compiled module: a step runs eagerly
(on real tensors, or on fake ones with no memory behind them), and
:class:`OpCost`, a :class:`~torch.utils._python_dispatch.TorchDispatchMode`,
sees every operator it runs, every loop trip included:

* FLOPs from :mod:`torch.utils.flop_counter`'s registry of formulas
  (matmuls, convolutions, attention; the hand-written flash kernels
  register theirs, 4 dh and 10 dh a visible (query, key) pair);
* bytes = the bytes of each operator's tensor operands plus those of its
  outputs; view and alias operators (:data:`SKIP_BYTES_OPS`) move nothing
  and count 0, as the reference skips its bitcasts and tuples;
* collectives: the ``_c10d_functional`` operators that DTensor issues for
  each redistribution, by type in the reference's names, each counted as
  its output's bytes (the reference's convention).

On a mesh the mode lets :class:`DTensor` run first and counts the
operators that DTensor runs on the local shards: every count is per
device.  A kernel launched through ``ctypes`` is visible only as the
operator that wraps it (``torch.ops.repro_torch.*``), so the operators
inside a wrapper are not counted twice.  The same step counted on real
and on fake tensors gives the same numbers.
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: Operators that only view or alias their input (or allocate without
#: writing), counted as moving no bytes.
SKIP_BYTES_OPS = frozenset({
    "view", "_unsafe_view", "expand", "t", "transpose", "slice", "select",
    "unsqueeze", "squeeze", "alias", "detach", "permute", "as_strided",
    "split", "split_with_sizes", "unbind", "view_as_real", "view_as_complex",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "lift_fresh", "_to_copy_view", "wait_tensor",
})

#: ``_c10d_functional`` operators and the reference's names for them.
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shapes(tree) -> str:
    return ",".join(f"{str(t.dtype).removeprefix('torch.')}"
                    f"{list(t.shape)}" for t in _tensors(tree))


def _exclude_propagation() -> None:
    """Runs DTensor's output-shape propagation (each operator once on fake
    tensors of the global shapes, cached per signature) with every
    dispatch mode off, so neither :class:`OpCost` nor a memory tracker
    counts it: bookkeeping, not the step's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    f = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(f, "outside_dispatch_modes", False):
        return

    def outside(self, op_schema):
        with _disable_current_modes():
            return f(self, op_schema)
    outside.outside_dispatch_modes = True
    ShardingPropagator._propagate_tensor_meta_non_cached = outside


class OpCost(TorchDispatchMode):
    """Counts every operator run inside the ``with`` block.  With
    ``keep_ops`` it also keeps a table of (operator, operand shapes) ->
    calls, FLOPs and bytes (:attr:`ops`), which
    :mod:`repro_torch.launch.breakdown` reads."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.keep_ops = keep_ops
        self.flops = 0
        self.bytes = 0
        self.calls = collections.Counter()
        self.coll_bytes: Dict[str, int] = collections.Counter()
        self.coll_counts: Dict[str, int] = collections.Counter()
        self.ops: Dict[tuple, list] = {}

    def __enter__(self):
        _exclude_propagation()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor run first: its local operators come back here.
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or any(
                t.device.type == "meta" for t in _tensors((args, kwargs))):
            # Device queries and work on meta tensors: bookkeeping, not the
            # step's work.
            return out
        packet = func._overloadpacket
        name = packet.__name__
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if name not in SKIP_BYTES_OPS:
            nbytes = sum(map(tensor_bytes, _tensors((args, kwargs)))) + sum(
                map(tensor_bytes, _tensors(out)))
        self.flops += flops
        self.bytes += nbytes
        op = f"{func.namespace}.{name}"
        self.calls[op] += 1
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            self.coll_bytes[kind] += sum(map(tensor_bytes, _tensors(out)))
            self.coll_counts[kind] += 1
        if self.keep_ops:
            key = (op, _shapes(args))
            row = self.ops.setdefault(key, [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out

    def record(self) -> Dict:
        """The reference's ``hlo_cost.analyze`` keys, plus ``num_ops`` and
        each operator's calls."""
        return {
            "flops_per_device": float(self.flops),
            "bytes_per_device": float(self.bytes),
            "collective_bytes_per_device": float(sum(
                self.coll_bytes.values())),
            "collective_bytes_by_type": {k: float(v) for k, v in
                                         self.coll_bytes.items()},
            "collective_counts_by_type": {k: float(v) for k, v in
                                          self.coll_counts.items()},
            "num_ops": int(sum(self.calls.values())),
            "calls": dict(self.calls),
        }

    def table(self) -> list:
        """Rows ``(op, operand shapes, calls, flops, bytes)``."""
        return [(op, shapes, *row) for (op, shapes), row in
                self.ops.items()]

