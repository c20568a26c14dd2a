"""Carry layouts across from their numpy form.

A layout of the reference package is numpy arrays: zone maps
(``meta.mins``, ``meta.maxs``, ``meta.rows``) and a router — a qd-tree's
packed node arrays (``cols``, ``thresholds``, ``lefts``, ``rights``,
``leaf_ids``), the default router's fields (``k``, ``sort_col``,
``boundaries``) or a Z-order router's (``zcols``, ``col_lo``, ``col_hi``,
``boundaries``, ``k``).  These functions rebuild the zone maps and the
router in this package, on a given device (the card by default), from
those arrays alone; ``repro_torch.core.layouts.Layout`` joins them into a
layout.

:func:`model_params` carries a model's parameter tree across the same
way (:func:`transformer_params`, :func:`rwkv6_params`,
:func:`hybrid_params` by family): nested dicts of numpy arrays in the
reference's layout, and :func:`train_state` a whole train state
(parameters, AdamW moments and step, and the error-feedback residual when
present).  All of them, the optimizer's weight decay and the checkpoint's
on-disk format place the port's parameter names through :func:`ref_path`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import layouts, qdtree, zorder
from repro_torch.kernels._backend import resolve_device, to_device
from repro_torch.kernels.zorder import ref as zref
from repro_torch.models import layers as L
from repro_torch.models import hybrid, mamba2, rwkv6, transformer

Device = Union[None, str, torch.device]


def metadata(mins: np.ndarray, maxs: np.ndarray, rows: np.ndarray,
             device: Device = None) -> layouts.PartitionMetadata:
    """Zone maps (P, C), (P, C) and row counts (P,) on ``device``."""
    dev = resolve_device(device)
    rows_host = np.array(rows, dtype=np.float64)
    return layouts.PartitionMetadata(
        mins=to_device(mins, dev), maxs=to_device(maxs, dev),
        rows=to_device(rows_host, dev), rows_host=rows_host)


def tree_router(cols: np.ndarray, thresholds: np.ndarray, lefts: np.ndarray,
                rights: np.ndarray, leaf_ids: np.ndarray,
                device: Device = None) -> qdtree._TreeRouter:
    """A qd-tree router from its packed node arrays."""
    return qdtree._TreeRouter(np.asarray(cols), np.asarray(thresholds),
                              np.asarray(lefts), np.asarray(rights),
                              np.asarray(leaf_ids), resolve_device(device))


def default_router(k: int, sort_col: Optional[int],
                   boundaries: Optional[np.ndarray],
                   device: Device = None) -> qdtree._DefaultRouter:
    """The arrival-order (or sort-column quantile) router."""
    dev = resolve_device(device)
    return qdtree._DefaultRouter(
        int(k), None if sort_col is None else int(sort_col),
        None if boundaries is None else to_device(boundaries, dev))


def zorder_router(zcols: np.ndarray, col_lo: np.ndarray, col_hi: np.ndarray,
                  boundaries: np.ndarray, k: int,
                  device: Device = None) -> zorder._ZOrderRouter:
    """A Z-order router from its column indices, float64 bounds and uint64
    key boundaries (held on the device as int64 with bit 63 flipped)."""
    dev = resolve_device(device)
    keys = np.ascontiguousarray(boundaries, dtype=np.uint64).view(np.int64)
    return zorder._ZOrderRouter(
        np.asarray(zcols, dtype=np.int64), to_device(col_lo, dev),
        to_device(col_hi, dev), zref.flip(torch.as_tensor(keys, device=dev)),
        int(k))


def _weight(a, device: torch.device, dtype) -> torch.Tensor:
    """A numpy array (bfloat16 arrays included) as a tensor on ``device``,
    cast to ``dtype`` unless it is None."""
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


#: The reference's trees whose leaves stack the layers on axis 0: the
#: transformer's and RWKV-6's ``layers``, the hybrid's ``mamba``.  The
#: hybrid's ``shared_attn`` is one block, not stacked.
STACKED = ("layers", "mamba")


def ref_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference's leaf path of the port's parameter ``name`` and the
    index of its layer on that leaf's stacked axis 0 (None outside the
    ``STACKED`` trees): ``layers.3.attn.wq`` is ``("layers", "attn",
    "wq")``, 3, ``mamba.3.A_log`` is ``("mamba", "A_log")``, 3, and
    ``shared_attn.ln1`` is ``("shared_attn", "ln1")``, None."""
    parts = tuple(name.split("."))
    if parts[0] in STACKED:
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def ref_leaf(tree, name: str):
    """The part of the reference's tree that the port's parameter ``name``
    holds: a leaf, or one layer of a stacked leaf."""
    path, layer = ref_path(name)
    for key in path:
        tree = tree[key]
    return tree if layer is None else tree[layer]


def ref_groups(names) -> Dict[Tuple[str, ...], List[str]]:
    """The reference's leaf paths of the port's parameter ``names``, in
    ``jax.tree.flatten``'s order (sorted), each with the names it holds:
    one, or a stacked leaf's layers from 0 on."""
    groups: Dict[Tuple[str, ...], list] = {}
    for name in names:
        path, layer = ref_path(name)
        groups.setdefault(path, []).append((layer, name))
    out = {}
    for path in sorted(groups):
        layers, members = zip(*sorted(groups[path],
                                      key=lambda m: m[0] or 0))
        if layers != (None,) and layers != tuple(range(len(layers))):
            raise ValueError(f"convert: {'/'.join(path)} holds layers "
                             f"{list(layers)}, not 0 .. n - 1")
        out[path] = list(members)
    return out


def transformer_params(tree, cfg, device: Device = None,
                       dtype: Optional[torch.dtype] = None
                       ) -> transformer.Transformer:
    """The port's transformer (dense, MoE, VLM or audio) with the weights
    of ``tree``.

    ``tree`` is the reference's parameter tree as nested dicts of numpy
    arrays: ``embed`` (V, d), ``layers`` with every leaf stacked on axis 0
    (``attn`` {wq, wk, wv, wo, q_norm, k_norm}, ``ln1``, ``ln2``, and
    ``mlp`` or ``moe`` {router, w_gate, w_up, w_down}), ``final_norm``
    (d,) and ``head`` (d, V).  Each leaf keeps its dtype unless ``dtype``
    is given.
    """
    dev = resolve_device(device)
    transformer.check_family(cfg)
    w = _reader(tree, dev, dtype)
    blocks = [_block(w, f"layers.{i}.", cfg, tree["layers"])
              for i in range(cfg.n_layers)]
    return transformer.Transformer(w("embed"), blocks, w("final_norm"),
                                   w("head"))


def _reader(tree, device: torch.device, dtype):
    """The port's parameter ``name`` read from ``tree``."""
    def w(name):
        return _weight(ref_leaf(tree, name), device, dtype)
    return w


def _block(w, at: str, cfg, leaves) -> transformer.Block:
    """The transformer block whose parameters are named ``at`` + ...;
    ``leaves`` is its part of the reference's tree (its MLP's names)."""
    norms = ((w(at + "attn.q_norm"), w(at + "attn.k_norm")) if cfg.qk_norm
             else (None, None))
    if cfg.moe is not None:
        ffn = L.MoE(*(w(at + "moe." + k)
                      for k in ("router", "w_gate", "w_up", "w_down")))
    else:
        ffn = L.MLP(**{k: w(at + "mlp." + k) for k in leaves["mlp"]})
    return transformer.Block(
        L.Attention(*(w(at + "attn." + k) for k in ("wq", "wk", "wv", "wo")),
                    *norms),
        ffn, w(at + "ln1"), w(at + "ln2"))


def rwkv6_params(tree, cfg, device: Device = None,
                 dtype: Optional[torch.dtype] = None
                 ) -> transformer.Transformer:
    """The port's RWKV-6 model with the weights of ``tree``: ``embed``,
    ``layers`` (every leaf of ``rwkv6.init_layer`` stacked on axis 0),
    ``final_norm`` and ``head``."""
    w = _reader(tree, resolve_device(device), dtype)
    layers = [rwkv6.Layer(**{k: w(f"layers.{i}.{k}")
                             for k in tree["layers"]})
              for i in range(cfg.n_layers)]
    return transformer.Transformer(w("embed"), layers, w("final_norm"),
                                   w("head"))


def hybrid_params(tree, cfg, device: Device = None,
                  dtype: Optional[torch.dtype] = None) -> hybrid.Hybrid:
    """The port's hybrid model with the weights of ``tree``: ``embed``,
    ``mamba`` (every Mamba-2 leaf stacked on axis 0), ``shared_attn`` (one
    transformer block, not stacked), ``final_norm`` and ``head``."""
    w = _reader(tree, resolve_device(device), dtype)
    mamba = [mamba2.Layer(**{k: w(f"mamba.{i}.{k}") for k in tree["mamba"]})
             for i in range(cfg.n_layers)]
    return hybrid.Hybrid(w("embed"), mamba,
                         _block(w, "shared_attn.", cfg, tree["shared_attn"]),
                         w("final_norm"), w("head"))


def model_params(tree, cfg, device: Device = None,
                 dtype: Optional[torch.dtype] = None):
    """The port's model of ``cfg``'s family with the weights of ``tree``."""
    build = {"ssm": rwkv6_params, "hybrid": hybrid_params}.get(
        cfg.family, transformer_params)
    return build(tree, cfg, device, dtype)


def train_state(tree, cfg, device: Device = None,
                dtype: Optional[torch.dtype] = None) -> dict:
    """The port's train state from the reference's, as nested dicts of
    numpy arrays: ``params`` (cast to ``dtype`` unless it is None, with grad
    on), ``opt`` {``m``, ``v``: parameter-shaped trees, ``step``} and, when
    present, ``ef_residual``.  Moments and residual keep their dtypes and
    are keyed by the parameters' names, as
    :func:`repro_torch.train.optimizer.init_opt_state` keys them."""
    dev = resolve_device(device)
    params = transformer.trainable(
        model_params(tree["params"], cfg, dev, dtype))
    names = [n for n, _ in params.named_parameters()]

    def named(sub):
        return {n: _weight(ref_leaf(sub, n), dev, None) for n in names}

    state = {"params": params,
             "opt": {"m": named(tree["opt"]["m"]),
                     "v": named(tree["opt"]["v"]),
                     "step": torch.tensor(
                         int(np.asarray(tree["opt"]["step"])),
                         dtype=torch.int32, device=dev)}}
    if "ef_residual" in tree:
        state["ef_residual"] = named(tree["ef_residual"])
    return state
