"""Production-mesh dry run: rank 0's program of a 256- or 512-device mesh,
run on one machine without devices; the counterpart of
``repro.launch.dryrun``.

The reference forces 512 host devices and has XLA lower and compile each
(arch x shape) cell for the production mesh.  Here :func:`run_cell` opens
a ``fake`` process group of 256 or 512 ranks (:func:`mesh.fake_world`:
collectives return at once), builds a :class:`DeviceMesh` of 16 x 16 or
2 x 16 x 16 over it and, under :class:`FakeTensorMode` (tensors with
shapes, dtypes and devices but no memory), builds the model with its
parameters, the batch and the decode cache distributed as
:class:`DTensor` s by the resolved logical specs.  It then runs one train
step, prefill or decode step eagerly under :class:`~.op_cost.OpCost`
(per-device FLOPs, bytes and collectives, every loop trip counted) and
:class:`~torch.distributed._tools.mem_tracker.MemTracker` (the per-device
peak).  Nothing is compiled: ``trace_seconds`` is the time of that run.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --mesh single --out experiments/dryrun

A failed cell is written as ``<tag>.json.failed`` and counted, and the
command exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, get_arch, runnable_cells,
                                      skipped_cells)
from repro_torch.launch import cells as cell_opts
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_cost import OpCost, tensor_bytes
from repro_torch.models import build_model, input_specs, sharding
from repro_torch.models.factory import _module_for
from repro_torch.models import layers as L
from repro_torch.models.transformer import trainable
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_loop import build_train_step

#: The card's memory, which ``memory_analysis["fits"]`` holds each
#: per-device peak to (NVIDIA H100 SXM, 80 GB HBM3).
CARD_BYTES = 80 * 10 ** 9


def _drop_batch(tree):
    """B = 1 cells (long_500k) cannot shard the batch dim: replicate it."""
    if isinstance(tree, tuple):
        return tuple(None if el == "batch" else el for el in tree)
    return {k: _drop_batch(v) for k, v in tree.items()}


def _layout(shape, spec, mesh, multi_pod: bool) -> tuple:
    return mesh_lib.placements(mesh_lib.resolve_spec(spec, multi_pod), mesh,
                               shape)


def _distribute(t: torch.Tensor, spec, mesh, multi_pod: bool):
    from torch.distributed.tensor import distribute_tensor
    if t.device.type != mesh.device_type:
        # Fake values: a tensor of the same shape on the mesh's device.
        t = torch.empty(t.shape, dtype=t.dtype, device=mesh.device_type)
    return distribute_tensor(t, mesh, _layout(t.shape, spec, mesh,
                                              multi_pod),
                             src_data_rank=None)


def shard_module(module: torch.nn.Module, specs, mesh, multi_pod: bool):
    """Every parameter of ``module`` replaced by its :class:`DTensor` laid
    out by ``specs[name]``; returns the module."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, attr, torch.nn.Parameter(
            _distribute(p.detach(), specs[name], mesh, multi_pod),
            requires_grad=p.requires_grad))
    return module


def _inputs(shapes, specs, mesh, multi_pod: bool, device) -> dict:
    """Zeros of each ``(shape, dtype)`` entry distributed by its spec."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _inputs(v, specs[k], mesh, multi_pod, device)
            continue
        shape, dtype = v
        out[k] = _distribute(torch.zeros(shape, dtype=dtype, device=device),
                             specs[k], mesh, multi_pod)
    return out


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (dicts,
    modules, tensors)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return local_bytes(dict(tree.named_parameters()))
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, DTensor):
        return tensor_bytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return tensor_bytes(tree)
    return 0


def _peak_bytes(tracker, device: torch.device) -> int:
    """The tracker's peak on the mesh's device type (not DTensor's meta
    tensors)."""
    snap = tracker.get_tracker_snapshot("peak")
    return int(max((v.get("Total", 0) for d, v in snap.items()
                    if torch.device(d).type == device.type), default=0))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches=None, seq_parallel=None, opt_dtype=None,
             accum_dtype=None, capacity_factor=None, remat_policy=None,
             keep_ops: bool = False, device=None) -> dict:
    """One cell's record.  ``device`` is the fake tensors' and the mesh's
    device type (the card's by default; tests pass ``"cpu"``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    t_start = time.time()
    shape = SHAPES[shape_name]
    opts = cell_opts.cell_options(arch, shape_name, microbatches,
                                  seq_parallel, opt_dtype)
    if accum_dtype is not None:
        opts = dataclasses.replace(opts, train=dataclasses.replace(
            opts.train, accum_dtype=accum_dtype))
    saved = (L.MOE_OPTIONS["capacity_factor"], L.REMAT_OPTIONS["policy"])
    if capacity_factor is not None:
        L.set_moe_capacity_factor(capacity_factor)
    if remat_policy is not None:
        L.set_remat_policy(remat_policy)
    dev = torch.device("cuda" if device is None else device)
    cfg = get_arch(arch)
    mp = multi_pod
    try:
        with mesh_lib.fake_world(mesh_lib.world_size(mp)):
            mesh = mesh_lib.make_production_mesh(mp, dev)
            with FakeTensorMode(allow_non_fake_inputs=True), \
                    sharding.mesh_context(
                    mesh, batch_axes=mesh_lib.batch_axes(mp),
                    model_axis="model", fsdp_axis="data",
                    seq_parallel=opts.seq_parallel):
                model = build_model(cfg, device=dev)
                # Fake weights drawn on the host, then laid out on the
                # mesh's device.
                params = shard_module(
                    _module_for(cfg).init_params(
                        torch.Generator().manual_seed(0), cfg),
                    model.param_specs(), mesh, mp)
                batch_shapes, batch_specs = input_specs(cfg, shape)
                if shape.global_batch == 1:
                    batch_specs = _drop_batch(batch_specs)
                batch = _inputs(batch_shapes, batch_specs, mesh, mp, dev)
                memory = {"param_bytes": local_bytes(params),
                          "input_bytes": local_bytes(batch)}
                tracker = MemTracker()
                if shape.kind == "train":
                    state = {"params": trainable(params),
                             "opt": init_opt_state(params, opts.opt)}
                    memory["optimizer_bytes"] = local_bytes(state["opt"])
                    step = build_train_step(model, opts.opt, opts.train)
                    run = lambda: step(state, batch)    # noqa: E731
                    tracker.track_external(params, *state["opt"]["m"].values(),
                                           *state["opt"]["v"].values())
                elif shape.kind == "prefill":
                    run = lambda: model.prefill(        # noqa: E731
                        params, batch, max_len=shape.seq_len)
                    tracker.track_external(params)
                else:
                    cache_shapes = model.cache_spec(shape.global_batch,
                                                    shape.seq_len)
                    cache_specs = model.cache_specs(opts.cache_seq_axes)
                    if shape.global_batch == 1:
                        cache_specs = _drop_batch(cache_specs)
                    cache_shapes.pop("index")
                    cache = _inputs(cache_shapes, cache_specs, mesh, mp, dev)
                    memory["cache_bytes"] = local_bytes(cache)
                    # The step writes the cache's last position.
                    cache["index"] = shape.seq_len - 1
                    run = lambda: model.decode_step(    # noqa: E731
                        params, batch, cache)
                    tracker.track_external(params, *_leaves(cache))
                t0 = time.time()
                with torch.set_grad_enabled(shape.kind == "train"), \
                        OpCost(keep_ops) as cost, tracker:
                    run()
                t_trace = time.time() - t0
                memory["peak_bytes"] = _peak_bytes(tracker, dev)
    finally:
        L.set_moe_capacity_factor(saved[0])
        L.set_remat_policy(saved[1])
    memory["card_bytes"] = CARD_BYTES
    memory["fits"] = memory["peak_bytes"] <= CARD_BYTES
    counts = cost.record()
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if mp else "16x16",
        "num_devices": mesh_lib.world_size(mp),
        "device": dev.type,
        "options": {
            "microbatches": opts.train.microbatches,
            "seq_parallel": opts.seq_parallel,
            "opt_state_dtype": opts.opt.state_dtype,
            "accum_dtype": opts.train.accum_dtype,
            "capacity_factor": capacity_factor,
            "remat_policy": remat_policy or "nothing",
            "cache_seq_axes": list(opts.cache_seq_axes),
        },
        "num_params": cfg.num_params(),
        "num_active_params": cfg.num_active_params(),
        "trace_seconds": round(t_trace, 1),
        "total_seconds": round(time.time() - t_start, 1),
        "memory_analysis": memory,
        "op_cost": {k: v for k, v in counts.items() if k != "calls"},
        "op_calls": counts["calls"],
        "collectives": {
            "bytes_by_type": counts["collective_bytes_by_type"],
            "counts_by_type": counts["collective_counts_by_type"],
            "total_bytes": int(counts["collective_bytes_per_device"])},
    }
    if keep_ops:
        record["ops"] = cost.table()
    return record


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Production-mesh dry run")
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-parallel", type=int, default=None,
                    help="0/1 override")
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--accum-dtype", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--remat-policy", default=None,
                    choices=["nothing", "dots"])
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device type (default: cuda)")
    ap.add_argument("--tag", default="", help="suffix for output files")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = runnable_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results, failures = [], []
    for arch, shape_name in cells:
        for mp in meshes:
            tagname = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
            if args.tag:
                tagname += f"__{args.tag}"
            out_path = os.path.join(args.out, tagname + ".json")
            print(f"=== {tagname} ===", flush=True)
            try:
                sp = None if args.seq_parallel is None else bool(
                    args.seq_parallel)
                rec = run_cell(arch, shape_name, mp,
                               microbatches=args.microbatches,
                               seq_parallel=sp, opt_dtype=args.opt_dtype,
                               accum_dtype=args.accum_dtype,
                               capacity_factor=args.capacity_factor,
                               remat_policy=args.remat_policy,
                               device=args.device)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                oc = rec["op_cost"]
                print(f"    ok: trace={rec['trace_seconds']}s "
                      f"flops/dev={oc['flops_per_device']:.3e} "
                      f"bytes/dev={oc['bytes_per_device']:.3e} "
                      f"coll/dev={oc['collective_bytes_per_device']:.3e}B "
                      f"peak/dev={rec['memory_analysis']['peak_bytes']:.3e}B",
                      flush=True)
                results.append(rec)
            except Exception as e:
                traceback.print_exc()
                failures.append((tagname, f"{type(e).__name__}: {e}"))
                with open(out_path + ".failed", "w") as f:
                    f.write(traceback.format_exc())

    print(f"\n==== dry-run done: {len(results)} ok, {len(failures)} failed")
    for name, err in failures:
        print(f"  FAIL {name}: {err[:300]}")
    for arch, shape_name, why in skipped_cells():
        print(f"  SKIP {arch} x {shape_name}: {why}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
