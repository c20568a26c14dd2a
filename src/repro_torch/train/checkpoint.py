"""Checkpointing: one file per state tensor plus a manifest, atomic commit;
``repro.train.checkpoint``'s on-disk format.

Layout on disk::

    <dir>/step_<N>/manifest.json        step, leaf count, leaf paths,
                                         dtypes, shapes
    <dir>/step_<N>/leaf_<i>.npy         one file per leaf

The leaves are ``repro``'s train state's, in the order ``jax.tree.flatten``
gives it: mappings in sorted key order, and a parameter tree (a module, or
a mapping keyed by parameter names as the moments are) as ``repro`` holds
it, every layer leaf stacked on axis 0 (``convert.ref_groups``).  The
manifest's ``treedef`` lists each leaf's path.  bfloat16 is stored as
uint16.  So either package restores the other's checkpoints, and the leaf
files are byte for byte ``repro``'s.  Commit is atomic (tmp dir + rename),
so a failure mid-save never corrupts the latest checkpoint.  ``restore``
builds a new state shaped as ``like`` on ``like``'s devices, unstacking
the layers.

:func:`_leaves` is another walk: the state's tensors as the port holds
them (a module's parameters in ``named_parameters()`` order), for comparing
two states.
"""
from __future__ import annotations

import copy
import json
import os
import re
import shutil
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import convert


def _leaves(state: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(state, nn.Module):
        return [(prefix + n, p) for n, p in state.named_parameters()]
    if isinstance(state, Mapping):
        out = []
        for key in sorted(state):
            out += _leaves(state[key], f"{prefix}{key}/")
        return out
    if isinstance(state, torch.Tensor):
        return [(prefix.rstrip("/"), state)]
    raise TypeError(f"checkpoint: cannot store a {type(state)} at {prefix}")


def _named(state: Any) -> Optional[Mapping[str, torch.Tensor]]:
    """The parameter tree ``state`` holds, by name, or None: a module, or a
    non-empty mapping of tensors (moments and residual are keyed by the
    parameters' names)."""
    if isinstance(state, nn.Module):
        return dict(state.named_parameters())
    if isinstance(state, Mapping) and state and all(
            isinstance(t, torch.Tensor) for t in state.values()):
        return state
    return None


def _disk_leaves(state: Any, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], List[torch.Tensor], bool]]:
    """``repro``'s leaves of ``state`` in ``jax.tree.flatten``'s order:
    (path, tensors, stacked), where a stacked leaf's tensors are its
    layers from 0 on."""
    named = _named(state)
    if named is not None:
        return [(prefix + path, [named[n] for n in names],
                 convert.ref_path(names[0])[1] is not None)
                for path, names in convert.ref_groups(named).items()]
    if isinstance(state, Mapping):
        out = []
        for key in sorted(state):
            out += _disk_leaves(state[key], prefix + (key,))
        return out
    if isinstance(state, torch.Tensor):
        return [(prefix, [state], False)]
    raise TypeError(f"checkpoint: cannot store a {type(state)} at "
                    f"{'/'.join(prefix)}")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def _shape(parts: List[torch.Tensor], stacked: bool) -> List[int]:
    return ([len(parts)] if stacked else []) + list(parts[0].shape)


def save(state: Any, directory: str, step: int, keep_last: int = 3) -> str:
    leaves = _disk_leaves(state)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for i, (_, parts, stacked) in enumerate(leaves):
        host = [p.detach().cpu() for p in parts]
        t = torch.stack(host) if stacked else host[0]
        if t.dtype == torch.bfloat16:        # persist as uint16
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": ["/".join(path) for path, _, _ in leaves],
        "dtypes": [_dtype_name(parts[0]) for _, parts, _ in leaves],
        "shapes": [_shape(parts, stacked) for _, parts, stacked in leaves],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    _cleanup(directory, keep_last)
    return final


def _cleanup(directory: str, keep_last: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _part(loaded: dict, prefix: Tuple[str, ...], name: str) -> torch.Tensor:
    """The parameter ``name`` of the tree at ``prefix``: a loaded leaf or
    its layer's slice."""
    path, layer = convert.ref_path(name)
    t = loaded[prefix + path]
    return t if layer is None else t[layer]


def _like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor of its own on ``like``'s device, with its
    ``requires_grad``."""
    return t.to(like.device, copy=True).requires_grad_(like.requires_grad)


def _rebuild(like: Any, loaded: dict, prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(like, nn.Module):
        out = copy.deepcopy(like)
        with torch.no_grad():
            for n, p in out.named_parameters():
                p.copy_(_part(loaded, prefix, n))
        return out
    if _named(like) is not None:
        return {n: _like(_part(loaded, prefix, n), t) for n, t in like.items()}
    if isinstance(like, Mapping):
        return {key: _rebuild(like[key], loaded, prefix + (key,))
                for key in like}
    return _like(loaded[prefix], like)


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: a new state whose tensors
    sit on the devices of ``like``'s, from a checkpoint written by either
    package.  The port's earlier format, one leaf a layer, is refused."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    treedef = manifest["treedef"]
    names = treedef if isinstance(treedef, list) else None
    if names and any(re.search(r"(^|/)layers\.\d", n) for n in names):
        raise ValueError(f"checkpoint {path} is in the port's per-layer "
                         f"format, which is no longer read: leaves are "
                         f"repro's, with layers stacked on axis 0")
    leaves = _disk_leaves(like)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint {path} holds {manifest['num_leaves']} "
                         f"tensors, the state {len(leaves)}")
    loaded = {}
    for i, (key, parts, stacked) in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        name = "/".join(key)
        shape = _shape(parts, stacked)
        if ((names is not None and names[i] != name)
                or t.dtype != parts[0].dtype or list(t.shape) != shape):
            raise ValueError(f"checkpoint leaf {i}: "
                             f"{names[i] if names else '?'} {t.dtype} "
                             f"{tuple(t.shape)} does not match {name} "
                             f"{parts[0].dtype} {tuple(shape)}")
        loaded[key] = t
    return _rebuild(like, loaded)
