"""Checkpointing: one file per state tensor plus a manifest, atomic commit;
the counterpart of ``repro.train.checkpoint`` with its on-disk format.

Layout on disk::

    <dir>/step_<N>/manifest.json        step, leaf count, leaf order,
                                         dtypes, shapes
    <dir>/step_<N>/leaf_<i>.npy         one file per tensor

Leaves are the state's tensors in a fixed walk: mappings in sorted key
order (as ``jax.tree.flatten`` orders dicts), a module's parameters in
``named_parameters()`` order; the manifest's ``treedef`` lists each leaf's
path.  bfloat16 is stored as uint16.  Commit is atomic (tmp dir + rename),
so a failure mid-save never corrupts the latest checkpoint.  ``restore``
builds a new state shaped as ``like`` on ``like``'s devices.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def save(state: Any, directory: str, step: int, keep_last: int = 3) -> str:
    leaves = _leaves(state)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for i, (_, leaf) in enumerate(leaves):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:        # persist as uint16
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": [path for path, _ in leaves],
        "dtypes": [_dtype_name(t) for _, t in leaves],
        "shapes": [list(t.shape) for _, t in leaves],
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


def _rebuild(like: Any, loaded: dict, prefix: str = "") -> Any:
    if isinstance(like, nn.Module):
        out = copy.deepcopy(like)
        with torch.no_grad():
            for n, p in out.named_parameters():
                p.copy_(loaded[prefix + n])
        return out
    if isinstance(like, Mapping):
        return {key: _rebuild(like[key], loaded, f"{prefix}{key}/")
                for key in like}
    return loaded[prefix.rstrip("/")].to(like.device)


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: a new state whose tensors
    sit on the devices of ``like``'s."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(like)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint {path} holds {manifest['num_leaves']} "
                         f"tensors, the state {len(leaves)}")
    loaded = {}
    for i, (name, leaf) in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if (manifest["treedef"][i] != name or t.dtype != leaf.dtype
                or tuple(t.shape) != tuple(leaf.shape)):
            raise ValueError(f"checkpoint leaf {i}: {manifest['treedef'][i]} "
                             f"{t.dtype} {tuple(t.shape)} does not match "
                             f"{name} {leaf.dtype} {tuple(leaf.shape)}")
        loaded[name] = t
    return _rebuild(like, loaded)
