"""Per-op FLOP and collective attribution for one dry-run cell; the
counterpart of ``repro.launch.breakdown``, reading
:mod:`repro_torch.launch.op_cost`'s table of (operator, operand shapes)
-> calls, FLOPs and bytes.

Usage: PYTHONPATH=src python -m repro_torch.launch.breakdown --arch X \\
           --shape Y [--multi-pod] [--microbatches N] ...
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-parallel", type=int, default=None)
    ap.add_argument("--accum-dtype", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device type (default: cuda)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    sp = None if args.seq_parallel is None else bool(args.seq_parallel)
    rec = run_cell(args.arch, args.shape, args.multi_pod,
                   microbatches=args.microbatches, seq_parallel=sp,
                   accum_dtype=args.accum_dtype,
                   capacity_factor=args.capacity_factor,
                   remat_policy=args.remat_policy, keep_ops=True,
                   device=args.device)
    oc = rec["op_cost"]
    print(f"flops/dev={oc['flops_per_device']:.3e} "
          f"bytes/dev={oc['bytes_per_device']:.3e} "
          f"coll/dev={oc['collective_bytes_per_device']:.3e}")
    rows = rec["ops"]
    dots = [r for r in rows if r[3]]
    colls = [r for r in rows if r[0].startswith("_c10d_functional.")
             and r[4]]
    print(f"\n== top ops by flops (total {sum(r[3] for r in dots):.3e} "
          f"flops/dev):")
    for op, shapes, calls, flops, _ in sorted(
            dots, key=lambda r: -r[3])[:args.top]:
        print(f"  {flops:.2e} x{calls:<5d} {op:34s} {shapes[:90]}")
    print(f"\n== top collectives by bytes (total "
          f"{sum(r[4] for r in colls):.3e} bytes/dev, operands and "
          f"outputs):")
    for op, shapes, calls, _, nbytes in sorted(
            colls, key=lambda r: -r[4])[:args.top]:
        print(f"  {nbytes:.2e} x{calls:<5d} {op:44s} {shapes[:70]}")


if __name__ == "__main__":
    main()
