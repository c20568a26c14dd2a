"""Roofline analysis over the dry-run records; the counterpart of
``repro.launch.roofline``, with the constants of the card the port runs
on: an NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit, from NVIDIA's
data sheet.

Per (arch x shape x mesh) cell it derives the three per-device roofline
terms from the op-level counts (:mod:`repro_torch.launch.op_cost`)::

    compute    = flops_per_device      / PEAK_FLOPS   (989 TFLOP/s dense bf16)
    memory     = bytes_per_device      / HBM_BW       (3.35 TB/s)
    collective = coll_bytes_per_device / LINK_BW      (450 GB/s NVLink 4,
                                                       per direction)

plus MODEL_FLOPS (6 N D train, 2 N D inference, N = active params) and the
useful-compute ratio MODEL_FLOPS / (counted FLOPs x devices), which
catches remat recompute, MoE capacity waste, padding and replicated
compute.

Caveat recorded in every report: a 16-wide mesh axis spans two 8-GPU
NVLink nodes, so part of each collective crosses the slower inter-node
network; the collective term (all at NVLink's rate) is a lower bound.
The byte count is each operator's operands and outputs as the eager
program runs them, unfused: an upper bound on HBM traffic.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun experiments/dryrun --out experiments/roofline
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.configs.base import SHAPES, get_arch

CARD = "NVIDIA H100 SXM 80GB, 700 W"
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs per step (global, forward(+backward))."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.num_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the KV cache but does
    # negligible extra matmul FLOPs relative to 2N.
    return 2.0 * n_active * shape.global_batch


def ideal_bytes(arch: str, shape_name: str, opt_dtype: str = "float32"
                ) -> float:
    """Analytic minimal HBM traffic per step (global bytes).

    train:   params read twice (fwd+bwd) + grad write + optimizer m/v
             read+write + param write.
    prefill: params read + KV cache write.
    decode:  active params read + KV cache read (the serving floor).
    """
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    n = cfg.num_params()
    n_active = cfg.num_active_params()
    opt_b = 2 if opt_dtype == "bfloat16" else 4
    kv_per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2   # k+v bf16
    n_attn_layers = (0 if cfg.family == "ssm" else
                     (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                      else cfg.n_layers))
    if shape.kind == "train":
        return n * 2 * 3 + n * 4 + n * opt_b * 4          # bf16 p, f32 grads
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return n_active * 2 + tokens * kv_per_tok * n_attn_layers
    kv_read = shape.global_batch * shape.seq_len * kv_per_tok * n_attn_layers
    state = 0.0
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        state = (shape.global_batch * cfg.n_layers
                 * (d_in // cfg.ssm.head_dim) * cfg.ssm.head_dim
                 * cfg.ssm.d_state * 4)
    if cfg.family == "ssm":
        dh = cfg.rwkv_head_dim
        state = (shape.global_batch * cfg.n_layers
                 * (cfg.d_model // dh) * dh * dh * 4)
    return n_active * 2 + kv_read + state


def analyze_record(rec: Dict) -> Dict:
    oc = rec["op_cost"]
    chips = rec["num_devices"]
    compute_s = oc["flops_per_device"] / PEAK_FLOPS
    memory_s = oc["bytes_per_device"] / HBM_BW
    coll_s = oc["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    counted_flops_global = oc["flops_per_device"] * chips
    useful_ratio = mf / max(counted_flops_global, 1.0)
    opt_dtype = rec.get("options", {}).get("opt_state_dtype", "float32")
    ib = ideal_bytes(rec["arch"], rec["shape"], opt_dtype)
    # The achievable step-time floor is the max of the compute ideal and the
    # memory ideal; roofline fraction = floor / modeled dominant term.
    ideal_s = max(mf / chips / PEAK_FLOPS, ib / chips / HBM_BW)
    roofline_fraction = ideal_s / max(max(terms.values()), 1e-12)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant,
        "model_flops": mf,
        "ideal_bytes": ib,
        "ideal_s": ideal_s,
        "counted_flops_global": counted_flops_global,
        "useful_ratio": useful_ratio,
        "roofline_fraction": roofline_fraction,
        "collective_by_type": oc["collective_bytes_by_type"],
        "options": rec.get("options", {}),
        "memory_analysis": rec.get("memory_analysis", {}),
        "trace_seconds": rec.get("trace_seconds"),
    }


_NOTES = {
    "compute": ("dominant term is tensor-core compute; lower it by cutting "
                "remat recompute (useful_ratio < 0.75 means recompute or "
                "waste) or removing padded or replicated matmul work"),
    "memory": ("dominant term is HBM traffic; lower it with fused "
               "elementwise chains (the count is unfused), bf16-resident "
               "states, or fewer optimizer passes"),
    "collective": ("dominant term is NVLink and network traffic; lower it by "
                   "re-sharding to cut all-gathers (FSDP prefetch), "
                   "overlapping collectives with compute, or compressing "
                   "gradients.  A 16-wide axis spans two 8-GPU nodes, so "
                   "this term is a lower bound"),
}


def to_markdown(rows: List[Dict]) -> str:
    out = [f"Card: {CARD} (PEAK_FLOPS {PEAK_FLOPS:.3g}, HBM_BW "
           f"{HBM_BW:.3g} B/s, LINK_BW {LINK_BW:.3g} B/s).", "",
           "| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['model_flops']:.2e} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} |")
    out.append("")
    out.append("Bottleneck notes (per dominant term):")
    for k, v in _NOTES.items():
        out.append(f"- **{k}**: {v}.")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/roofline")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    args = ap.parse_args(argv)
    rows = []
    for path in sorted(glob.glob(os.path.join(args.dryrun, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if args.mesh != "both":
            want = "16x16" if args.mesh == "single" else "2x16x16"
            if rec["mesh"] != want:
                continue
        rows.append(analyze_record(rec))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"roofline_{args.mesh}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(os.path.join(args.out, f"roofline_{args.mesh}.md"), "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    main()
