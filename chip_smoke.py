#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases kernel  # environment + kernel phase only
    python3 chip_smoke.py --phases kernel,fleet_parity,fleet_full
    python3 chip_smoke.py --phases kernel,reorg_parity,reorg_full
    python3 chip_smoke.py --phases kernel,serve_parity,serve_full
    python3 chip_smoke.py --phases kernel,zorder_parity,zorder_full
    python3 chip_smoke.py --phases kernel,ingest_parity,ingest_full
    python3 chip_smoke.py --phases router_parity,router_full
    python3 chip_smoke.py --phases forecast_parity,forecast_full
    python3 chip_smoke.py --phases train_parity,train_full
    python3 chip_smoke.py --phases family_parity,family_full
    python3 chip_smoke.py --phases launch,train_full

Phases, each printing JSON lines:

1. ``env``: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together, for sm_90a).
2. ``kernel``: each kernel (pruning, fleet_scan, decision_fused,
   move_score, flash_attention, zorder) against its plain PyTorch version
   on the card, at the shapes the main paths give it plus ragged and edge
   shapes, with CUDA-event times and the least time the card could take
   (bound); for pruning, fleet_scan, decision_fused and move_score also
   the profiler's device time per launch (``device_ms``), which tells the
   kernel body from the host's launch rate.  The pruning kernel runs with
   the tile it chooses and with each tile forced (one query row a block;
   a shared-memory tile of 32 partitions walking 32 queries at a time), at
   the decision loop's block shapes (64, 256 and 1,024 queries x 288 x
   32, the main path's ``run`` estimates), at Q = 1 (``step``), with query
   bounds sliced from a larger tensor, a row-strided plane and NaN and
   +-inf zone maps, beside an empty launch's device time.  The fleet
   kernels (one shared-memory tile, ``csrc/fleet_tile.cuh``) run at both
   fleet cells' passes and the other ``FLEET_SHAPES`` (NaN bounds, 70,000
   tenants, the column limit, slots past one tile, a freq-only launch of
   1,000 window rows, no slots) on the path the kernel chooses and on
   each forced one (one or four slots a thread), with each path's device
   time at the two passes; ``cost`` must also equal itself bitwise across
   two launches.  The move-score kernel (the same tile with one tenant and
   the window's freq as its only output; a thread-per-output kernel past
   the tile's 2,905 columns) runs at both planning shapes and the other
   ``MOVE_SHAPES`` (W 1,000, NaN bounds, partition- and state-strided
   planes, S * P past one tile, the column limit and one past it) on each
   path, with each path's device time at the two planning shapes.  Scans,
   ``freq``, move scores and Z-order keys and routes (the TPU kernel's
   float32 lane at its bench
   shape 1,000,000 x 3; the layout generator's float64 lane on the
   1,199,721-row sample, contiguous, read in place from 32 columns and
   column-major, and a column-stride-2 view; the fused route to 1, 2, 32
   and 1,024 partitions with keys on a boundary and values past lo/hi)
   must be exact, ``cost`` within rel 1e-12; flash attention within
   atol = rtol = 2e-2 in bfloat16 and 1e-5 in float32 (qwen3-1.7b's
   prefill, ragged, smoke, non-causal with ``kv_valid_len``,
   ``prefix_len`` 96 and 200, ``q_offset`` 64, ``kv_valid_len`` 0, head
   dims 256 and 192, 32 query heads over 4, paligemma-3b's prefill (4,
   2048, 8/1, 256, ``prefix_len`` 256), musicgen-large's (4, 1024,
   32/32, 64) and zamba2-2.7b's (4, 2048, 32/32, 80)), both of its routes
   in bfloat16 (tensor cores, timed as
   ``ms``, and the scalar one as ``earlier_design_ms``) and the scalar
   one in float32, also timing PyTorch's ``scaled_dot_product_attention``
   on the same tensors as ``library_ms`` (the port never calls it).  The
   flash backward kernel (``csrc/flash_attention_bwd.cu``) runs at
   qwen3-1.7b's training shape (4, 2048, 16/8, 128), paligemma-3b's (2,
   512, 8/1, 256, ``prefix_len`` 256), zamba2-2.7b's (4, 2048, 32/32, 80)
   and the forward's edge shapes, both
   of its routes in bfloat16 (tensor cores, timed as ``ms``, and the
   scalar one as ``earlier_design_ms``) and the scalar one in float32:
   each gradient within 2e-2 (bf16) or 1e-4 (float32) x its max |grad| of
   the plain backward, bitwise equal across two launches, timed beside
   the plain backward and ``torch.autograd.grad`` of SDPA's output
   (``library_ms``).
3. ``parity``: the single-table loop at 20,000 rows x 8 columns and 1,500
   queries under OREO, Static, Greedy and Regret, on the card and on the
   CPU; the traces must be bitwise equal.
4. ``fleet_parity``: 3 tenants of 20,000 x 8, the five drift scenarios x
   three schedulers, 120 queries per tenant, OREO tenants and threshold
   tenants (0, 0.05, 1e9), each through ``run`` and ``run_batched`` on both
   lanes, on the card and on the CPU; every trace and counter must be
   bitwise equal to the CPU's ``run``.  One job per policy, in the spawned
   workers that also run forecast_parity's jobs, submitted when the kernel
   phase ends; the script reads their results after ``router_parity``.
5. ``full``: the ``tpch-sf10-oreo`` cell -- OREO and Static over a
   59,986,052-row x 32-column TPC-H-like table (lineitem at scale factor 10,
   drawn on the host by a thread from the script's start, then copied)
   on the card, its 12,000 queries of 16 templates cut to 6,000 for the
   script's time (``--queries``), alpha = 80, P = 32; each
   method's estimate seconds, block scans and discarded block rows; then
   OREO over the first 1,500 queries as a ``step`` loop (one launch per
   estimate) and as ``run`` (a block of estimates per launch), in turns
   step, run, run, step, and ``run`` with blocks of 64 and 1,024 queries:
   traces bitwise equal, decide and estimate seconds and launches each.
6. ``fleet_full``: the ``fleet16-sf1-oreo-k1`` cell (16 OREO tenants of
   6,001,215 x 8 under one maintenance worker, ``sudden_shift``, its 1,500
   queries per tenant cut to 750) and the ``fleet64-sf1-threshold`` cell
   (64 threshold
   tenants of 6,001,215 x 10, 8 projection-sorted layouts each, 300
   selective queries per tenant, both lanes, whose traces must be equal).
7. ``reorg_parity``: the incremental reorganization plane, card against
   CPU: unbounded incremental fleets equal to atomic ones (3 tenants of
   20,000 x 8, five scenarios x three schedulers), ``run`` and
   ``run_batched`` on both lanes with both planner lanes at 150 rows per
   tick and unbounded, a row-denominated token bucket, a standalone engine
   at 137 rows per tick, and ``DiskBackend`` (5,000 x 4, atomic,
   incremental and tight, writer thread off and on); every trace, counter
   and migration ledger bitwise equal.  Run whole in one of the spawned
   workers, from the end of the kernel phase on.
8. ``reorg_full``: the ``fleet16-sf1-oreo-incr-bucket`` cell -- 16 OREO
   tenants of 6,001,215 x 8 sharing one maintenance budget, four arms
   (atomic and incremental, unlimited and a token bucket of 0.002 swaps or
   0.002 x 6,001,215 rows per tick; 1,000 queries per tenant cut to
   500); the unlimited arms must be equal and
   every completed migration ledger must close on alpha.
9. ``serve_parity``: the serving substrate, card against CPU in float32
   (TF32 off): qwen3-1.7b at full width cut to 2 layers, weights from a
   numpy seed carried into both copies by ``convert.transformer_params``,
   greedy generation of 8 tokens from a (2, 256) prompt -- tokens equal,
   logits within 1e-3 x max |logit| -- then the examples/serve_model.py
   slot loop at the smoke config, every request's tokens equal.
10. ``serve_full``: the ``qwen3-1.7b-serve`` cell -- qwen3-1.7b at full
   width in bf16, weights drawn on the card from a seeded generator, the
   slot loop with 4 slots serving 8 requests of 2048-token prompts, 64
   new tokens each, ``max_len`` 2176; every prefill attention launches
   the flash kernel's tensor-core route (28 per prefill); then one
   prefill (with the flash kernel's share of its device time) and two
   decode steps under ``torch.profiler``.
11. ``zorder_parity``: the six methods of Figs. 3 and 4 (Static, Greedy,
   Regret, OREO, MTS Optimal, Offline Optimal) under the Z-order generator
   on the tpch-, tpcds- and telemetry-like tables at 20,000 rows and 1,500
   queries, card against CPU; every trace bitwise equal.
12. ``zorder_full``: the ``tpch-sf10-zorder`` cell -- the same six methods
   over ``full``'s table and traffic (built once for both cells) under the
   Z-order generator (3 key columns, 16 bits, a 1,199,721-row sample),
   one key launch per build, with each method's estimate seconds, block
   scans and discarded block rows; then Static's full-table route timed alone
   four ways (keys only, the fused route, ``searchsorted`` + ``clamp_max``
   alone, keys only on a column-major copy) beside its bound and the
   sector floor of its key columns.
13. ``ingest_parity``: the streaming ingest plane, card against
   ``BENCH_ingest.json`` and the CPU: (a) three compaction arms (never,
   always, debt) with ``FleetEngine.run`` at its full config (4 tenants of
   8,000 x 8, 1,000 queries, alpha 4) under ``INGEST_FULL_SCENARIOS``
   (mixed_rw and trickle; the other three are cut for the script's time)
   and at its smoke config under all five scenarios, every deterministic
   field and cost ratio equal to the file, rounded as the benchmark
   rounds (the full config's runs go to spawned workers when the kernel
   phase ends, so they overlap the parity phases); (b) at the smoke config,
   ``run_batched`` on both lanes and the unbounded incremental fleet on
   both planner lanes equal to ``run`` for trickle, mixed_rw and
   bulk_load (every migration closes on alpha at once); (c) the smoke
   config's traces card against CPU;
   (d) ``DiskBackend(durable=True)`` at 20,000 x 8 under mixed_rw: after
   every event the WAL replay equals the live manifest and pending
   batches, and the trace equals the ``InMemoryBackend``'s.
14. ``ingest_full``: the ``fleet16-sf1-oreo-ingest-mixed_rw`` cell, its
   16 tenants cut to 8 and its 1,000 queries per tenant to 500 for the
   script's time -- OREO tenants of 6,001,215 x 8
   (benchmarks/bench_ingest.py's config) under mixed_rw with an append of
   37,508 rows after every 8th query,
   four arms (never, always, debt, debt/incremental) under
   ``run_batched``; each arm's totals, events/s, decide, ingest, serve and
   reorg seconds, peak memory, final table bytes, the plane's P_cap and
   pruning's launches by caller; the never arm's final planes hold
   pruning, fleet_scan and decision_fused against their plain versions;
   debt/incremental must equal debt bitwise.
15. ``router_parity``: the routing plane and the serving front end, card
   against the files and the CPU: (a) ``compute="reference"`` backends at
   ``parity``'s 20,000 x 8 config, OREO's and Static's traces equal to the
   default mode's, with the reference path's pruning launches; (b)
   ``BENCH_router.json``'s deterministic fields (events per shard at 1, 2,
   4 and 8 shards, the 1-shard router equal to a plain fleet, the
   migration section), the migration router card against CPU; (c)
   ``BENCH_serving.json``'s (each scenario's events, cache counters and
   breaker opens from the closed serving loop, whose traces equal the
   direct run's; the overload section), the overload front end card
   against CPU; (d) incremental tenants migrated between 2 shards on the
   ``fleet_scan`` lane, traces and ledgers equal to the unsharded fleet's,
   card against CPU.  Run whole in one of the spawned workers, from the end
   of the kernel phase on.
16. ``router_full``: the ``fleet16-sf1-oreo-router`` cell --
   ``fleet16-sf1-oreo-k1``'s width and traffic (16 OREO tenants of
   6,001,215 x 8), queries per tenant cut to ``ROUTER_QUERIES``, behind 4
   shards on the one card: (A) an unlimited router with four tenants
   migrated at half the stream, traces equal to the unsharded fleet's;
   (B) ``ServeFrontend(batched=True)`` with ``bench_serving``'s overload
   settings over a K = 1 router, charge ledgers equal to the router's
   without it, with breaker, shed counts and p50/p99 ms per event; (C) a
   ``ProcessShardSet`` of 4 workers on the card, run from a child process
   that must never initialize CUDA, with one cross-process migration and
   a tail of traffic, traces equal to the inline router's; each arm's
   events/s, critical path (events over the slowest shard's drains) and
   launches (arm C's summed over its workers).
17. ``forecast_parity``: the forecast plane, card against
   ``BENCH_forecast.json`` and the CPU: (a) its ``forecast_smoke`` section
   in full (10 scenarios x 3 schedulers, both arms), every cost ratio
   equal to the file and every trace and ``info()`` card == CPU; (b) from
   its full section (4 tenants of 20,000 x 8, 1,500 queries, alpha 20),
   the rows with pre-positions (gradual_drift and cyclic_diurnal, every
   scheduler) and the unlimited row of ``FORECAST_FULL_UNLIMITED``
   (sudden_shift, flash_crowd, template_churn; the five ingest scenarios'
   rows are cut for the script's time, their smoke rows stay), every
   deterministic field equal; (c) the churn fleet of
   tests/test_forecast_churn.py (ForecastPolicy growing and retiring
   qd-tree states eagerly), five scenarios x three schedulers:
   run_batched on both lanes and the unbounded incremental fleet on both
   planner lanes bitwise equal to ``run``, card == CPU; a forecast engine
   saved with ``torch.save`` while it holds a grown state stays one table
   and continues identically; and a ``ProcessShardSet`` of 2 workers on
   the card migrating a tenant that holds a live grown state, equal to
   the inline router, the parent loading no engine file.  (b) drives
   run_batched, bitwise ``run``.  Every job runs in ``FORECAST_WORKERS``
   spawned processes (host-bound loops), submitted when the kernel phase
   ends, so they overlap the parity phases.
18. ``forecast_full``: the ``fleet16-sf1-forecast-cyclic_diurnal`` cell --
   16 tenants of 6,001,215 x 8 at ``BENCH_forecast.json``'s full config
   (alpha 20, delta 10, P 16, window 80, gen_every 40, the default
   ``ForecastConfig``), cyclic_diurnal seed 7, ``FORECAST_QUERIES``
   (400 of the config's 1,500, cut for the script's time) queries a
   tenant, unlimited: (A) reactive OREO on ``run_batched``
   (decision_fused), (B) ``ForecastPolicy`` through ``run``, (C) the same
   through ``run_batched``, bitwise (B), (D) gradual_drift under
   ``ForecastPolicy`` through ``run`` (the grower's qd-trees over the
   6M-row tables); each arm's totals, pre-positions, forecasts and
   accuracy, grower proposals, admissions and build seconds, events/s,
   decide seconds and the seconds inside ``ForecastPolicy`` but outside
   its inner policy, peak memory and launches.
19. ``train_parity``: the training substrate, card against CPU: (a) in
   float32 (TF32 off), qwen3-1.7b at full width cut to 2 layers, weights
   from a numpy seed in both copies: the loss and every gradient of
   ``loss_fn`` on (2, 128) tokens (loss within 1e-5 relative, each
   gradient within 1e-4 x its max |g|), then 3 ``build_train_step``
   steps whose losses agree within 1e-4 (the CPU side runs in a spawned
   process on two threads from the start of the script, beside the card's
   earlier phases); the card's steps launch both flash kernels' scalar
   routes; (b) at the smoke config in bf16 on the card, a
   ``FaultTolerantTrainer`` run of 20 steps with a fault injected at step
   13 ends bitwise equal to the clean run (restarts 1 and 0), every
   backward launch on the tensor-core route; (c) ``OreoDataPipeline`` at
   tests/test_substrate.py's config (20,000 documents, 1,500 queries):
   batches and stats bitwise equal card and CPU.
20. ``train_full``: the ``qwen3-1.7b-train`` cell -- qwen3-1.7b at full
   width and depth in bf16, weights drawn on the card from a seeded
   generator, per-layer remat, the default ``OptimizerConfig``, 10 steps
   of ``build_train_step`` on 4 x 2048-token batches from
   ``OreoDataPipeline`` over ``synth_corpus(20_000, 2048, 151936)`` at
   alpha 80; the first step run twice from one state must give the same
   bits; s per step, tokens/s, losses, peak memory, the pipeline's scan
   fraction and reorganizations, launches (forward 56 a step, backward
   28, every one on the tensor-core route, pruning), then one step under
   torch.profiler (the backward kernel's device ms and share of device
   time, the idle share).
21. ``family_parity``: the VLM, audio, MoE, SSM and hybrid families,
   card against CPU in float32 (TF32 off): paligemma-3b, musicgen-large,
   moonshot-v1-16b-a3b and rwkv6-3b at full width cut to 2 layers,
   zamba2-2.7b cut to 12 (two groups, so the shared block runs twice with
   two KV caches), weights from the port's init on a CPU generator in
   both copies (the CPU side runs in a spawned two-thread process from the
   end of ``forecast_parity`` on, and a thread here draws the card's
   copy); a prefill (paligemma 256 patch embeddings and 32 tokens,
   musicgen 64 frames, moonshot 64 tokens, rwkv6 160 (two WKV chunks and
   a tail), zamba2 288 (an SSD chunk and a tail); 2 rows) and 8 greedy
   decode steps (musicgen fed seeded frames): tokens (codes) equal, logits
   within 1e-3 x max |logit|, the MoE's expert choices and kept masks
   equal at every layer and call; the loss and every gradient of
   paligemma at (2, 512) (256 patch embeddings and 256 tokens; the
   backward's prefix path at dh 256 with one KV head) and of zamba2 at 6
   layers and (1, 320) (the shared block at dh 80) within
   ``train_parity`` (a)'s limits on the scalar routes, then a bf16 step of
   the same weights on the tensor-core routes; each family smoke config's
   float32 train step (loss, gradient norm, parameters).
22. ``family_full``: five cells at full width and depth in bf16, weights
   drawn on the card from a seeded generator: ``paligemma-3b-serve`` (4
   requests of 256 seeded patch embeddings and 1,792 tokens, 16 greedy
   tokens), ``musicgen-large-serve`` (4 requests of 1,024 frame
   embeddings, 32 decode steps fed seeded frames), and through
   ``serve_full``'s slot loop (4 slots, 8 requests of 2,048 tokens, 16 new
   tokens; the three decode lengths are cut for the script's time)
   ``moonshot-v1-16b-a3b-serve`` (with the tokens its capacity
   drops per layer at prefill and decode), ``rwkv6-3b-serve`` and
   ``zamba2-2.7b-serve``; prefill tokens/s, seconds per output token, peak
   memory, flash launches by route (all on the tensor cores, the first and
   every 10th held against the plain version), one profiled prefill's
   idle share and, for rwkv6 and zamba2, the recurrences' device time,
   share of busy time and launches in a profiled prefill and in 2 decode
   steps, with all kernel launches per decode step.

23. ``launch``: the launch layer.  (a) In a host worker started at the
   script's start (it overlaps the card's phases; its tensors are fake
   and hold no memory): ``repro_torch.launch.dryrun.run_cell`` of the three
   ``qwen3-1.7b`` cells (train_4k, prefill_32k, decode_32k) on the fake
   16 x 16 mesh, each record's per-device FLOPs, bytes, collective bytes
   and peak bytes, and its roofline row.  (b) Inside ``train_full``'s
   ``qwen3-1.7b-train`` cell, on its full-width model and state: one train
   step counted by ``op_cost.OpCost`` on the card's tensors and the same
   step on fake tensors (equal FLOPs and bytes; 56 forward and 28
   backward flash launches counted).  (c) The cell's measured seconds per
   step with its counted FLOP/s, MFU (6 N tokens over the step seconds x
   989e12) and roofline fraction (the counted work's roofline time over
   the step seconds), beside the card's name and power limit and the
   torch version.  ``--phases launch`` runs ``train_full``'s cell too.

Kernel launch counts are reset just before each main path and read just
after it; every 50th (fleet) or 100th (single table, per-query scan or
consumed row of a block scan; any pruning call in ``forecast_full``)
scoring call, and
every 50th planning call, of a main path is checked against the plain
version on CPU copies of the same plane, and the first and every 10th
flash launch of ``serve_full`` and ``family_full`` and the first and
every 10th call of
each 64-bit zorder entry (keys, route) in ``zorder_full``, against the
plain version on the card.  The ``env`` line also lists the global loads
and stores of every zorder kernel in the built SASS (``cuobjdump``).
Then a ``timing`` line (each phase's wall seconds), the launches line,
the kernels' summary line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device the script exits 2 before printing any
result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP64_OPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores

FULL_ROWS = 59_986_052        # TPC-H lineitem cardinality at SF 10
FULL_COLUMNS = 32
FULL_QUERIES = 12_000
QUERIES = 6_000               # the default --queries: the cell's 12,000 cut
                              # for the script's time
MIN_QUERIES = 1_500           # the floor of --queries: paired_estimates's
                              # step and run arms over the first 1,500
SEGMENTS = 12
TEMPLATES = 16
ALPHA = 80.0
PARTITIONS = 32

SF1_ROWS = 6_001_215          # TPC-H lineitem cardinality at SF 1
FLEET_SEED = 100              # benchmarks/bench_fleet.py: tenant tables
PHASES = ("kernel", "parity", "fleet_parity", "full", "fleet_full",
          "reorg_parity", "reorg_full", "serve_parity", "serve_full",
          "zorder_parity", "zorder_full", "ingest_parity", "ingest_full",
          "router_parity", "router_full", "forecast_parity",
          "forecast_full", "train_parity", "train_full", "family_parity",
          "family_full", "launch")


def emit(phase: str, **fields) -> None:
    """One JSON line, written in one call: spawned workers share stdout."""
    sys.stdout.write(json.dumps({"phase": phase, **fields}) + "\n")
    sys.stdout.flush()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, reps: int, budget_s: float = 0.25) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after a warm-up.  A call slower than ``budget_s
    / reps`` (a plain version, a scalar route) is timed over fewer calls,
    at least 10, so the window stays near ``budget_s``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one_s = start.elapsed_time(end) / 1e3
    if one_s > 0:
        reps = max(min(reps, 10), min(reps, int(budget_s / one_s)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel`` over ``reps`` calls of ``fn``, by torch.profiler.  Beside
    cuda_time_ms (back-to-back calls between CUDA events) it tells the
    kernel body's time from the host's launch rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        if kernel in e.key and str(getattr(e, "device_type", "")
                                   ).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            us += t if t is not None else getattr(e, "self_cuda_time_total",
                                                  0)
            count += e.count
    return us / 1e3 / count if count else None


def scan_bound(q: int, p: int, c: int) -> dict:
    """Least time for a (Q, P, C) scan: each input read once, the output
    written once, 3 float64 operations (two compares, one AND) per
    (q, p, c)."""
    nbytes = (2 * q * c + 2 * p * c) * 8 + q * p
    ops = 3 * q * p * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_operands(rng, q: int, p: int, c: int, device, row_pad: int = 0,
                  q_lead: int = 0, nan_inf: bool = False):
    """Zone maps and query bounds with +-inf, empty partitions and bounds
    equal to zone-map ends; ``row_pad`` > 0 makes the partition operands a
    row-strided view of a wider plane, ``q_lead`` > 0 makes the query
    bounds a row slice (from row ``q_lead``) of a larger (2, rows, C)
    tensor, as a run's block estimates read them, and ``nan_inf`` puts NaN
    and +-inf entries into the zone maps."""
    import numpy as np
    import torch
    mins = rng.uniform(0, 100, (p, c))
    maxs = mins + rng.uniform(0, 30, (p, c))
    empty = rng.random(p) < 0.1
    mins[empty], maxs[empty] = np.inf, -np.inf
    lo = rng.uniform(-10, 110, (q, c))
    hi = lo + rng.uniform(0, 40, (q, c))
    if p and c:
        pick = rng.integers(0, p, (q, c))
        cols = np.broadcast_to(np.arange(c), (q, c))
        at_min = rng.random((q, c)) < 0.15
        at_max = rng.random((q, c)) < 0.15
        hi[at_min] = mins[pick, cols][at_min]
        lo[at_max] = maxs[pick, cols][at_max]
    lo[rng.random((q, c)) < 0.4] = -np.inf
    hi[rng.random((q, c)) < 0.4] = np.inf
    if nan_inf:
        for a, v, share in ((mins, np.nan, 0.03), (maxs, np.nan, 0.03),
                            (mins, -np.inf, 0.05), (maxs, np.inf, 0.05)):
            a[rng.random(a.shape) < share] = v

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    if q_lead:
        bounds = torch.zeros((2, q + q_lead + 3, c), dtype=torch.float64,
                             device=device)
        bounds[0, q_lead:q_lead + q], bounds[1, q_lead:q_lead + q] = (
            dev(lo), dev(hi))
        lo_t, hi_t = bounds[0, q_lead:q_lead + q], bounds[1,
                                                          q_lead:q_lead + q]
    else:
        lo_t, hi_t = dev(lo), dev(hi)
    if row_pad:
        wide_min = torch.zeros((p, c + row_pad), dtype=torch.float64,
                               device=device)
        wide_max = torch.zeros_like(wide_min)
        wide_min[:, :c], wide_max[:, :c] = dev(mins), dev(maxs)
        return lo_t, hi_t, wide_min[:, :c], wide_max[:, :c]
    return lo_t, hi_t, dev(mins), dev(maxs)


PRUNING_MAIN = "estimate block 256 x n*P_cap"   # run()'s block estimates
PRUNING_SHAPES = [  # (name, Q, P, C, row_pad, q_lead, nan_inf)
    (PRUNING_MAIN, 256, 288, 32, 0, 0, False),
    ("estimate block 64 x n*P_cap", 64, 288, 32, 0, 0, False),
    ("estimate block 1024 x n*P_cap", 1024, 288, 32, 0, 0, False),
    ("block rows sliced from a run's bounds", 256, 288, 32, 0, 517, False),
    ("block, NaN and +-inf zone maps", 256, 288, 32, 0, 0, True),
    ("state_matrix 1 x n*P_cap (step)", 1, 288, 32, 0, 0, False),
    ("4 x n*P_cap", 4, 288, 32, 0, 0, False),
    ("8 x n*P_cap", 8, 288, 32, 0, 0, False),
    ("16 x n*P_cap", 16, 288, 32, 0, 0, False),
    ("128 x n*P_cap", 128, 288, 32, 0, 0, False),
    ("serve 1 x P", 1, 32, 32, 0, 0, False),
    ("cost_vectors 64 x P", 64, 32, 32, 0, 0, False),
    ("greedy window 200 x P", 200, 32, 32, 0, 0, False),
    ("serve_block 1000 x P", 1000, 32, 32, 0, 0, False),
    ("batch 2048 x P", 2048, 32, 32, 0, 0, False),
    ("ragged", 1000, 37, 5, 0, 0, False),
    ("ragged, 70 columns, NaN", 300, 45, 70, 0, 0, True),
    ("zero columns", 16, 40, 0, 0, 0, False),
    ("row-strided plane view", 64, 288, 32, 3, 0, False),
    ("row-strided plane, sliced bounds, 1 query", 1, 288, 32, 3, 9, True),
]


def phase_kernel(device) -> dict:
    """Kernel against plain version over the listed shapes, with the tile
    the kernel chooses and each tile forced; returns the summary of the
    main path's dominant shape (PRUNING_MAIN, run()'s block estimates)."""
    import numpy as np
    import torch
    from repro_torch.kernels.pruning import pruning, ref
    rng = np.random.default_rng(0)
    fn = pruning._kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    tiny = torch.zeros(1, dtype=torch.uint8, device=device)
    # The device time of a launch that does nothing: a one-byte fill.
    empty_device_ms = device_ms(lambda: tiny.fill_(0), 200, "FillFunctor")
    results = []
    for name, q, p, c, pad, lead, nan_inf in PRUNING_SHAPES:
        lo, hi, mins, maxs = scan_operands(rng, q, p, c, device, pad, lead,
                                           nan_inf)
        want = ref.scan_matrix(lo, hi, mins, maxs)
        q_stride = pruning._row_stride("q_lo", lo)
        p_stride = pruning._row_stride("p_min", mins)
        row = {"shape": name, "q": q, "p": p, "c": c, "q_stride": q_stride,
               "row_stride": p_stride,
               "chosen_path": pruning.chosen_path(q, p, c)}
        err = 0
        for path, tile in pruning.PATHS.items():
            got = pruning.scan_matrix(lo, hi, mins, maxs, path=path)
            torch.cuda.synchronize()
            if got.numel():
                err = max(err, int((got.int() - want.int()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"pruning kernel ({tile}) disagrees at "
                                     f"{name} ({q}, {p}, {c}): max abs err "
                                     f"{err}")
            out = torch.empty((q, p), dtype=torch.bool, device=device)

            def raw(path=path, out=out):
                fn(lo.data_ptr(), hi.data_ptr(), q_stride, mins.data_ptr(),
                   maxs.data_ptr(), p_stride, out.data_ptr(), q, p, c, path,
                   stream)
            key = "" if path == 0 else f"_{tile}"
            row[f"ms{key}"] = cuda_time_ms(raw, 200)
            row[f"device_ms{key}"] = device_ms(raw, 200, "scan_")
        row.update({"equal": True, "max_abs_err": err,
                    "empty_launch_device_ms": empty_device_ms,
                    "wrapper_ms": cuda_time_ms(
                        lambda: pruning.scan_matrix(lo, hi, mins, maxs), 200),
                    "plain_ms": cuda_time_ms(
                        lambda: ref.scan_matrix(lo, hi, mins, maxs), 200),
                    **scan_bound(q, p, c)})
        results.append(row)
        emit("kernel", kernel="pruning.scan_matrix", **row)
    main = results[0]
    return {"name": "pruning.scan_matrix", "route": "cuda",
            "source": "src/repro_torch/csrc/pruning.cu",
            "replaces": "src/repro/kernels/pruning/pruning.py:86",
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "shape": main["shape"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None}


class TimedGenerator:
    """A layout generator that sums the wall seconds of its builds (each
    build ends in a device-to-host copy, so the time is the device's too)."""

    def __init__(self, gen):
        self.gen, self.seconds, self.calls = gen, 0.0, 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        layout = self.gen(*args)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return layout


class EstimateMeter:
    """Wall seconds inside one backend's estimates (``estimate_costs`` and
    ``estimate_vector``, whichever path serves them), and the block scans
    and discarded rows of its runs' lookaheads.  It wraps the instance's
    methods and launches nothing."""

    def __init__(self, backend):
        self.seconds, self.calls = 0.0, 0
        self.blocks = self.rows_discarded = 0
        for attr in ("estimate_costs", "estimate_vector"):
            setattr(backend, attr, self._timed(getattr(backend, attr)))
        inner_close = backend.close_lookahead

        def close():
            ahead = backend._lookahead
            inner_close()
            if ahead is not None:
                self.blocks += ahead.blocks
                self.rows_discarded += ahead.rows_discarded
        backend.close_lookahead = close

    def _timed(self, inner):
        def timed(*args):
            t0 = time.perf_counter()
            try:
                return inner(*args)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return timed

    def fields(self) -> dict:
        return {"estimate_seconds": self.seconds,
                "estimate_calls": self.calls,
                "estimate_blocks": self.blocks,
                "block_rows_discarded": self.rows_discarded}


class EstimateAudit:
    """Checks every ``every``-th state estimate of a run, inside the run.

    Per-query estimates (``step``): the scan that the main path's own
    launch returned for the plane's ``(n * P_cap, C)`` row-strided view.
    Block estimates (``run``): the consumed row of the block scan.  Either
    is held against the plain version on CPU copies of the same plane rows
    and the query's bounds, and the costs against a per-state numpy
    reduction of it.  It launches nothing itself, so the kernel's launch
    count stays the main path's.
    """

    def __init__(self, backend, every: int):
        matrix = backend.state_matrix
        self.matrix, self.every = matrix, every
        self.calls = self.checked = self.block_rows_checked = 0
        self._last = None
        self._inner_scanned, self._inner_estimate = (matrix._scanned,
                                                     matrix.estimate)
        matrix._scanned, matrix.estimate = self._scanned, self._estimate
        inner_open = backend.open_lookahead

        def open_lookahead(*args):
            ahead = inner_open(*args)
            inner_costs = ahead.costs

            def costs(m):
                got = inner_costs(m)
                self._block_row(ahead, got)
                return got
            ahead.costs = costs
            return ahead
        backend.open_lookahead = open_lookahead

    def _scanned(self, q_lo, q_hi):
        self._last = self._inner_scanned(q_lo, q_hi)
        return self._last

    def _estimate(self, q_lo, q_hi):
        self._last = None
        got = self._inner_estimate(q_lo, q_hi)
        self.calls += 1
        if self.calls % self.every == 0 and self._last is not None:
            self.check(q_lo, q_hi, self._last, got)
            self.checked += 1
        return got

    def _block_row(self, ahead, got) -> None:
        self.calls += 1
        if self.calls % self.every or ahead._block is None:
            return
        k = ahead.cursor
        start, version, scan = ahead._block
        if version != self.matrix.version:
            raise AssertionError(f"full: estimate {self.calls} consumed a "
                                 f"row scanned at plane version {version}, "
                                 f"now {self.matrix.version}")
        self.check(ahead._lo[k].cpu().numpy(), ahead._hi[k].cpu().numpy(),
                   scan[k - start], got)
        self.checked += 1
        self.block_rows_checked += 1

    def check(self, q_lo, q_hi, scanned, got) -> None:
        import numpy as np
        import torch
        from repro_torch.kernels.pruning import ref
        m = self.matrix
        n, c = len(m), m.num_columns
        want = ref.scan_matrix(
            torch.as_tensor(q_lo)[None], torch.as_tensor(q_hi)[None],
            m._mins[:n].cpu().reshape(-1, c),
            m._maxs[:n].cpu().reshape(-1, c)).reshape(n, -1).numpy()
        if not np.array_equal(scanned, want):
            raise AssertionError(f"full: kernel scan of the {n}-state plane "
                                 f"differs from the plain version at "
                                 f"estimate {self.calls}")
        costs = np.empty(n)
        for s, sid in enumerate(m.state_ids):
            meta = m.metadata(sid)
            costs[s] = (np.einsum("p,p->", want[s, :meta.num_partitions],
                                  meta.rows_host)
                        / max(meta.total_rows, 1))
        if not np.array_equal(got, costs):
            raise AssertionError(f"full: state estimates differ from numpy "
                                 f"at estimate {self.calls}: "
                                 f"{np.abs(got - costs).max()}")


def policies(data, stream, alpha, parts, gen=None):
    """Makers of the four online methods over ``data`` (a tensor on its
    device)."""
    from repro_torch import core, engine
    gen = gen or core.make_generator("qdtree")
    mgr = core.LayoutManagerConfig(target_partitions=parts)
    cfg = core.OreoConfig(alpha=alpha, manager=mgr)
    initial = core.build_default_layout
    return {
        "OREO": lambda: engine.OreoPolicy(
            data, initial(0, data, parts), gen, cfg),
        "Static": lambda: engine.StaticPolicy(
            data, stream, gen, alpha, target_partitions=parts),
        "Greedy": lambda: engine.GreedyPolicy(
            data, initial(0, data, parts), gen, alpha, mgr_cfg=mgr),
        "Regret": lambda: engine.RegretPolicy(
            data, initial(0, data, parts), gen, alpha, mgr_cfg=mgr),
    }


def phase_parity(device) -> None:
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.pruning import pruning
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 100, size=(20_000, 8))
    templates = core.make_templates(4, 8, rng)
    stream = core.generate_workload(templates, table.min(0), table.max(0),
                                    total_queries=1500, seed=1,
                                    segment_length=(300, 500))
    traces = {}
    launches = 0
    for dev in (device, torch.device("cpu")):
        data = torch.as_tensor(table, device=dev)
        pruning.scan_matrix.launches = 0
        for name, make in policies(data, stream, 40.0, 16).items():
            t0 = time.perf_counter()
            res = engine.LayoutEngine(make(), engine.InMemoryBackend(data)
                                      ).run(stream)
            traces[dev.type, name] = (res, time.perf_counter() - t0)
        if dev.type == "cuda":
            launches = pruning.scan_matrix.launches
            if launches <= 0:
                raise AssertionError("parity: the card run never launched "
                                     "the pruning kernel")
    for name in ("OREO", "Static", "Greedy", "Regret"):
        (a, ta), (b, tb) = traces["cuda", name], traces["cpu", name]
        same = (np.array_equal(a.query_costs, b.query_costs)
                and a.reorg_indices == b.reorg_indices
                and np.array_equal(a.state_seq, b.state_seq))
        emit("parity", policy=name, bitwise_equal=same,
             total_cost=a.total_cost, moves=a.num_reorgs,
             card_seconds=ta, cpu_seconds=tb)
        if not same:
            raise AssertionError(f"parity: {name} trace differs card vs CPU")
    emit("parity", kernel_launches_card=launches)


def sf10_table(rows: int = FULL_ROWS) -> tuple:
    """The tpch-sf10 cells' table built on the host (the port's
    ``build_table`` on the CPU: the same bits as on the card), and the
    seconds it took."""
    from repro_torch.data import build_table
    t0 = time.perf_counter()
    table = build_table(rows, FULL_COLUMNS, seed=0, device="cpu")
    return table, time.perf_counter() - t0


def start_sf10_inputs(device, total_queries: int):
    """Starts sf10_table now in a thread that touches nothing on the card
    (numpy's draws release the GIL), so the table's host-bound build
    overlaps the kernels' build and the kernel phase; returns a function
    that waits for it, copies the table to the card, draws the traffic,
    prints the ``full`` line and gives (table, stream): the table and
    traffic of the tpch-sf10 cells (tpch-sf10-oreo and tpch-sf10-zorder
    share them)."""
    import concurrent.futures as cf
    if total_queries < MIN_QUERIES:
        raise ValueError(f"--queries below {MIN_QUERIES}")
    pool = cf.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(sf10_table)
    pool.shutdown(wait=False)

    def result() -> tuple:
        import numpy as np
        from repro_torch import core
        t0 = time.perf_counter()
        host, table_seconds = future.result()
        waited = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = host.to(device)
        del host
        sync(device)
        copy_seconds = time.perf_counter() - t0
        if total_queries != FULL_QUERIES:
            emit("full", cut=f"queries {FULL_QUERIES} -> {total_queries}")
        rng = np.random.default_rng(10)
        templates = core.make_templates(TEMPLATES, FULL_COLUMNS, rng,
                                        cols_per_template=(1, 2),
                                        selectivity_range=(0.02, 0.10))
        stream = core.generate_workload(
            templates, data.amin(dim=0).cpu().numpy(),
            data.amax(dim=0).cpu().numpy(), total_queries=total_queries,
            seed=20, num_segments=SEGMENTS)
        emit("full", table="tpch-sf10", rows=len(data),
             columns=FULL_COLUMNS, queries=total_queries, alpha=ALPHA,
             partitions=PARTITIONS, table_bytes=data.numel() * 8,
             table_seconds=table_seconds, waited_seconds=waited,
             copy_to_card_seconds=copy_seconds,
             built="on the host, in a thread from the script's start")
        return data, stream
    return result


def phase_full(device, data, stream) -> int:
    """The tpch-sf10-oreo cell; returns the kernel launches of its run."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.pruning import pruning, ref
    total_queries = len(stream)
    emit("full", cell="tpch-sf10-oreo", rows=len(data),
         columns=data.shape[1], queries=total_queries)
    peaks = [torch.cuda.max_memory_allocated(device)]
    results, bound = {}, {}
    pruning.scan_matrix.launches = 0
    for name in ("OREO", "Static"):
        gen = TimedGenerator(core.make_generator("qdtree"))
        make = policies(data, stream, ALPHA, PARTITIONS, gen=gen)[name]
        torch.cuda.reset_peak_memory_stats(device)
        before = pruning.scan_matrix.launches
        t0 = time.perf_counter()
        policy = make()
        backend = engine.InMemoryBackend(data)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        audit = EstimateAudit(backend, every=100)
        meter = EstimateMeter(backend)
        t0 = time.perf_counter()
        res = engine.LayoutEngine(policy, backend).run(stream)
        run_wall = time.perf_counter() - t0
        launches = pruning.scan_matrix.launches - before
        costs = res.query_costs
        if not (len(costs) == total_queries and np.isfinite(costs).all()
                and (costs >= 0).all() and (costs <= 1).all()
                and len(res.state_seq) == total_queries):
            raise AssertionError(f"full: {name} trace malformed")
        if name == "OREO" and audit.checked < total_queries // 100:
            raise AssertionError(f"full: only {audit.checked} of OREO's "
                                 f"estimates were checked")
        results[name] = res
        bound[name] = policy
        peaks.append(torch.cuda.max_memory_allocated(device))
        emit("full", policy=name, total_cost=res.total_cost,
             query_cost=res.total_query_cost,
             reorg_cost=res.total_reorg_cost, moves=res.num_reorgs,
             setup_seconds=setup, decide_seconds=res.decide_seconds,
             reorg_seconds=res.reorg_seconds,
             serve_seconds=res.serve_seconds, run_wall_seconds=run_wall,
             kernel_launches=launches,
             launches_per_query=launches / total_queries,
             estimates=audit.calls, estimates_checked=audit.checked,
             block_rows_checked=audit.block_rows_checked, **meter.fields(),
             qdtree_builds=gen.calls, qdtree_build_seconds=gen.seconds,
             peak_bytes=torch.cuda.max_memory_allocated(device),
             info={k: v for k, v in res.info.items()
                   if isinstance(v, (int, float))})
        if name == "Static":
            # Every query was served by the one materialized layout:
            # recompute its costs with the plain version on the host.
            meta = backend.serving_layout.true_meta
            q_lo, q_hi = core.stack_queries(stream.queries)
            scanned = ref.scan_matrix(torch.as_tensor(q_lo),
                                      torch.as_tensor(q_hi),
                                      meta.mins.cpu(), meta.maxs.cpu())
            want = (core.layouts.scanned_dot(scanned.numpy(),
                                             meta.rows_host)
                    / max(meta.total_rows, 1))
            if not np.array_equal(want, costs):
                raise AssertionError("full: Static serve costs differ from "
                                     "the host recomputation")
    launches = pruning.scan_matrix.launches
    emit("full", stage_peaks=stage_peaks(device, data, stream,
                                         bound["OREO"]))
    oreo, static = results["OREO"], results["Static"]
    emit("full", oreo_vs_static_pct=100.0 * (static.total_cost
                                             - oreo.total_cost)
         / static.total_cost,
         kernel_launches=launches,
         max_memory_allocated=max(peaks), card=card_line())
    if launches <= 0:
        raise AssertionError("full: the main path never launched the "
                             "pruning kernel")
    paired_estimates(device, data, stream, MIN_QUERIES)
    return launches


def paired_estimates(device, data, stream, queries: int) -> None:
    """OREO over the first ``queries`` queries of the stream, as a step()
    loop (one pruning launch per estimate) and as run() (a block of
    estimates per launch), in turns (step, run, run, step), then run()
    with 64- and 1,024-query blocks; every trace must be bitwise equal.
    Prints each one's decide and estimate seconds and launch counts."""
    import numpy as np
    from repro_torch import engine
    from repro_torch.engine.state_matrix import BlockEstimates
    from repro_torch.kernels.pruning import pruning
    head = stream.queries[:queries]
    rows = BlockEstimates.rows
    arms = [("step", rows), ("run", rows), ("run", rows), ("step", rows),
            ("run", 64), ("run", 1024)]
    first = None
    for mode, block in arms:
        policy = policies(data, stream, ALPHA, PARTITIONS)["OREO"]()
        backend = engine.InMemoryBackend(data)
        meter = EstimateMeter(backend)
        eng = engine.LayoutEngine(policy, backend)
        BlockEstimates.rows = block
        pruning.scan_matrix.launches = 0
        t0 = time.perf_counter()
        try:
            if mode == "run":
                res = eng.run(head)
            else:
                for q in head:
                    eng.step(q)
                res = eng.result()
        finally:
            BlockEstimates.rows = rows
        wall = time.perf_counter() - t0
        trace = (res.query_costs, res.reorg_indices, res.state_seq)
        if first is None:
            first = trace
        same = (np.array_equal(trace[0], first[0]) and trace[1] == first[1]
                and np.array_equal(trace[2], first[2]))
        emit("full", paired="OREO step vs run", mode=mode, queries=queries,
             block_rows=block if mode == "run" else None,
             bitwise_equal=same, total_cost=res.total_cost,
             moves=res.num_reorgs, decide_seconds=res.decide_seconds,
             run_wall_seconds=wall,
             pruning_launches=pruning.scan_matrix.launches, **meter.fields())
        if not same:
            raise AssertionError(f"full: OREO's {mode} trace (block "
                                 f"{block}) differs from the first arm's")


def stage_peaks(device, data, stream, oreo_policy) -> dict:
    """Device memory above the resident table, and seconds, of each stage
    a run adds to it, measured alone: one candidate build, and one move
    (routing the full table through OREO's deepest tree, then its zone
    maps); and the largest partition of OREO's materialized layouts, as a
    share of the table's rows."""
    import torch
    from repro_torch.core import layouts, make_generator

    def measure(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"bytes": torch.cuda.max_memory_allocated(device) - base,
                     "seconds": time.perf_counter() - t0}
    window = stream.queries[:200]
    _, build = measure(lambda: make_generator("qdtree")(
        10_000, data, window, PARTITIONS))
    deepest = max((lay for lay in oreo_policy.manager.store.values()
                   if lay.technique == "qdtree"),
                  key=lambda lay: lay.route.depth)
    assignment, route = measure(lambda: deepest.route(data))
    _, zone_maps = measure(lambda: layouts.metadata_from_assignment(
        data, assignment, deepest.num_partitions))
    shares = [float(lay.true_meta.rows_host.max() / len(data))
              for lay in oreo_policy.manager.store.values()
              if lay.true_meta is not None]
    return {"qdtree_build": build, "route": {**route,
                                              "depth": deepest.route.depth},
            "zone_maps": zone_maps,
            "largest_partition_share": max(shares, default=None)}


# ---------------------------------------------------------------------------
# The fleet kernels
# ---------------------------------------------------------------------------

def plane_bound(b: int, t: int, n: int, c: int, w: int = 0,
                cost: bool = False) -> dict:
    """Least time for scoring B frames (and a W-row window) of T tenants
    against their N = S * P slots of C columns: each input read once
    (frames, plane, window; row counts and inverse totals when ``cost``),
    each output written once (the B x T x N scan bytes; B x T x S costs are
    not counted, a lower bound), 3 float64 operations per (frame or window
    row, t, n, c)."""
    nbytes = (2 * b * t * c + 2 * t * n * c + 2 * w * c) * 8 + b * t * n
    if cost:
        nbytes += t * n * 8
    if w:
        nbytes += t * n * 8
    ops = 3 * (b + w) * t * n * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def plane_operands(rng, b: int, t: int, s: int, p: int, c: int, w: int = 0):
    """Frames (B, T, C) and a plane (T, S, P, C) as the fleet's passes give
    them: +-inf bounds, empty partitions, a padded last state, query bounds
    equal to the tenant's own zone-map ends, and in every frame one
    query-less tenant of [-inf, +inf] dummies; row counts, inverse totals
    and a (W, C) window."""
    import numpy as np
    mins = rng.uniform(0, 100, (t, s, p, c))
    maxs = mins + rng.uniform(0, 30, (t, s, p, c))
    empty = rng.random((t, s, p)) < 0.1
    mins[empty], maxs[empty] = np.inf, -np.inf
    if s > 1:
        mins[:, -1, p // 2:], maxs[:, -1, p // 2:] = np.inf, -np.inf
    lo = rng.uniform(-10, 110, (b, t, c))
    hi = lo + rng.uniform(0, 40, (b, t, c))
    if s * p and c:
        flat_min, flat_max = mins.reshape(t, s * p, c), maxs.reshape(
            t, s * p, c)
        pick = rng.integers(0, s * p, (b, t, c))
        ti = np.broadcast_to(np.arange(t)[None, :, None], (b, t, c))
        ci = np.broadcast_to(np.arange(c), (b, t, c))
        at_min = rng.random((b, t, c)) < 0.15
        at_max = rng.random((b, t, c)) < 0.15
        hi[at_min] = flat_min[ti, pick, ci][at_min]
        lo[at_max] = flat_max[ti, pick, ci][at_max]
    lo[rng.random((b, t, c)) < 0.4] = -np.inf
    hi[rng.random((b, t, c)) < 0.4] = np.inf
    if t > 1:
        dummy = rng.integers(0, t, b)
        lo[np.arange(b), dummy], hi[np.arange(b), dummy] = -np.inf, np.inf
    rows = rng.integers(0, 1000, (t, s, p)).astype(np.float64)
    inv = 1.0 / np.maximum(rows.sum(-1), 1.0)
    w_lo = rng.uniform(-10, 110, (w, c))
    w_hi = w_lo + rng.uniform(0, 60, (w, c))
    w_lo[rng.random((w, c)) < 0.4] = -np.inf
    return lo, hi, mins, maxs, rows, inv, w_lo, w_hi


def plane_view(device, mins, maxs, c_pad: int = 0, t_step: int = 1):
    """The plane on ``device``; with ``c_pad`` / ``t_step`` a view of a
    plane with more columns and tenants (read in place by the kernels)."""
    import torch
    t, s, p, c = mins.shape
    wmin = torch.zeros((t * t_step, s, p, c + c_pad), dtype=torch.float64,
                       device=device)
    wmax = torch.zeros_like(wmin)
    wmin[::t_step, ..., :c] = torch.as_tensor(mins, device=device)
    wmax[::t_step, ..., :c] = torch.as_tensor(maxs, device=device)
    return wmin[::t_step, ..., :c], wmax[::t_step, ..., :c]


#: (name, B, T, S, P, C, W, c_pad, t_step, nan).  The first two are the
#: main paths' passes, whose plane shapes the cells report:
#: fleet64-sf1-threshold (1024 // 64 = 16 frames; T_cap 128, because the
#: plane's growth schedule doubles the tenant axis when the state axis
#: grows; S_cap 12 = 8 layouts + the serving shadow; P 8; C 10) and
#: fleet16-sf1-oreo-k1 (256 // 16 = 16 frames; T_cap 32, S_cap 8, P 16,
#: C 8).  ``nan`` puts NaN into 5 % of the zone-map and query bounds.
#: The kernels' tile holds 96 KB of zone maps (152 slots at C 40), and
#: takes up to ``decision_fused_max_columns()`` columns (the ``None``
#: width below).
FLEET_SHAPES = [
    ("fleet64 pass", 16, 128, 12, 8, 10, 0, 0, 1, False),
    ("fleet16 pass", 16, 32, 8, 16, 8, 0, 0, 1, False),
    ("fleet64 pass + 80-query window", 16, 128, 12, 8, 10, 80, 0, 1, False),
    ("ragged", 3, 17, 3, 130, 7, 5, 0, 1, False),
    ("partitions past one tile", 2, 3, 2, 300, 3, 2, 0, 1, False),
    ("bounds past 48 KB of shared memory", 2, 4, 2, 33, 100, 3, 0, 1, False),
    ("zero columns", 2, 3, 4, 40, 0, 2, 0, 1, False),
    ("one frame, one window row", 1, 5, 3, 9, 4, 1, 0, 1, False),
    ("strided plane view", 4, 6, 3, 10, 5, 3, 2, 2, False),
    ("NaN zone maps and query bounds", 16, 32, 8, 16, 8, 80, 0, 1, True),
    ("NaN, strided, ragged", 3, 17, 3, 130, 7, 5, 2, 2, True),
    ("tenants past 65,535", 2, 70_000, 1, 4, 2, 3, 0, 1, False),
    ("columns at the limit", 2, 2, 2, 5, None, 2, 0, 1, False),
    ("S * P past one tile", 3, 2, 3, 700, 40, 3, 0, 1, False),
    ("S * P past one tile, strided", 2, 3, 2, 650, 40, 2, 1, 2, False),
    ("freq only, W 1,000", 0, 1, 2, 16, 8, 1_000, 0, 1, False),
    ("no slots", 2, 4, 2, 0, 3, 2, 0, 1, False),
]


def with_nans(rng, *arrays) -> None:
    """NaN into 5 % of each array's entries, in place."""
    for a in arrays:
        a[rng.random(a.shape) < 0.05] = float("nan")


#: The fleet kernels' forced paths, by the key suffix their times get.
FLEET_PATHS = {1: "one_slot", 2: "four_slots"}


def time_fleet_kernels(device, lo, hi, vmin, vmax, reps: int = 200,
                       by_path: bool = False) -> dict:
    """CUDA-event ms per call at one pass shape, scan only (what the main
    paths launch): each kernel raw (its ``ctypes`` launch) and through its
    wrapper, and its plain version; fleet_scan for one frame.  With
    ``by_path`` also each forced path's raw and device ms."""
    import torch
    from repro_torch.kernels import _backend
    from repro_torch.kernels.decision_fused import decision_fused, ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan, ref as fref
    b, t, c = lo.shape
    _, s, p, _ = vmin.shape
    stream = _backend.stream_handle(device)
    scan = torch.empty((b, t, s, p), dtype=torch.bool, device=device)
    lib = decision_fused._lib()
    fmin, fmax = vmin.flatten(1, 2), vmax.flatten(1, 2)
    out = torch.empty((t, s * p), dtype=torch.bool, device=device)
    fn = fleet_scan._kernel()
    lo0, hi0 = lo[0].contiguous(), hi[0].contiguous()

    def raw_fused(path=0):
        lib.decision_fused(lo.data_ptr(), hi.data_ptr(), vmin.data_ptr(),
                           vmax.data_ptr(), vmin.stride(0), vmin.stride(1),
                           vmin.stride(2), None, None, None, None,
                           scan.data_ptr(), None, None, b, t, s, p, c, 0,
                           path, stream)

    def raw_fleet(path=0):
        fn(lo0.data_ptr(), hi0.data_ptr(), fmin.data_ptr(), fmax.data_ptr(),
           fmin.stride(0), fmin.stride(1), out.data_ptr(), t, s * p, c, path,
           stream)
    times = {
        "decision_fused": {
            "ms": cuda_time_ms(raw_fused, reps),
            "device_ms": device_ms(raw_fused, reps, "decision_fused_kernel"),
            "wrapper_ms": cuda_time_ms(lambda: decision_fused.fused_decision(
                lo, hi, vmin, vmax), reps),
            "plain_ms": cuda_time_ms(lambda: dref.fused_decision(
                lo, hi, vmin, vmax), reps),
            **plane_bound(b, t, s * p, c)},
        "fleet_scan": {
            "ms": cuda_time_ms(raw_fleet, reps),
            "device_ms": device_ms(raw_fleet, reps, "fleet_scan_kernel"),
            "wrapper_ms": cuda_time_ms(lambda: fleet_scan.scan_fleet(
                lo0, hi0, fmin, fmax), reps),
            "plain_ms": cuda_time_ms(lambda: fref.scan_fleet(
                lo0, hi0, fmin, fmax), reps),
            **plane_bound(1, t, s * p, c)}}
    for path, key in FLEET_PATHS.items() if by_path else ():
        for kernel, raw in (("decision_fused", raw_fused),
                            ("fleet_scan", raw_fleet)):
            times[kernel][f"ms_{key}"] = cuda_time_ms(
                lambda: raw(path), reps)
            times[kernel][f"device_ms_{key}"] = device_ms(
                lambda: raw(path), reps, f"{kernel}_kernel")
    return times


def phase_fleet_kernels(device) -> dict:
    """Both fleet kernels against their plain versions over FLEET_SHAPES;
    returns each kernel's summary at the fleet64 pass shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.decision_fused import decision_fused, ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan, ref as fref
    rng = np.random.default_rng(1)
    errs = {"fleet_scan": 0.0, "decision_fused": 0.0}
    main = None
    max_columns = decision_fused._lib().decision_fused_max_columns()
    for name, b, t, s, p, c, w, c_pad, t_step, nan in FLEET_SHAPES:
        c = max_columns if c is None else c
        lo, hi, mins, maxs, rows, inv, w_lo, w_hi = plane_operands(
            rng, b, t, s, p, c, w)
        if nan:
            with_nans(rng, lo, hi, mins, maxs, w_lo, w_hi)
        vmin, vmax = plane_view(device, mins, maxs, c_pad, t_step)
        dev = [torch.as_tensor(a, device=device)
               for a in (lo, hi, rows, inv, w_lo, w_hi)]
        window = dev[4:] if w else [None, None]
        want = dref.fused_decision(dev[0], dev[1], vmin, vmax, dev[2],
                                   dev[3], *window)
        for path in FLEET_PATHS:       # each forced path, bitwise
            forced = decision_fused.fused_decision(
                dev[0], dev[1], vmin, vmax, dev[2], dev[3], *window,
                path=path)
            frames = [fleet_scan.scan_fleet(dev[0][k], dev[1][k],
                                            vmin.flatten(1, 2),
                                            vmax.flatten(1, 2), path=path)
                      for k in range(b)]
            torch.cuda.synchronize()
            if not (torch.equal(forced[0], want[0])
                    and (not w or torch.equal(forced[2].view(torch.int64),
                                              want[2].view(torch.int64)))
                    and torch.allclose(forced[1], want[1], rtol=1e-12,
                                       atol=0)
                    and all(torch.equal(g.view(t, s, p), want[0][k])
                            for k, g in enumerate(frames))):
                raise AssertionError(f"fleet kernels on path {path} "
                                     f"disagree with their plain versions "
                                     f"at {name}")
        got = decision_fused.fused_decision(dev[0], dev[1], vmin, vmax,
                                            dev[2], dev[3], *window)
        again = decision_fused.fused_decision(dev[0], dev[1], vmin, vmax,
                                              dev[2], dev[3], *window)
        per_frame = [fleet_scan.scan_fleet(dev[0][k], dev[1][k],
                                           vmin.flatten(1, 2),
                                           vmax.flatten(1, 2))
                     for k in range(b)]
        plain_frames = [fref.scan_fleet(dev[0][k], dev[1][k],
                                        vmin.flatten(1, 2),
                                        vmax.flatten(1, 2))
                        for k in range(b)]
        torch.cuda.synchronize()
        scan_err = int((got[0].int() - want[0].int()).abs().max()
                       ) if got[0].numel() else 0
        cost_err = float((got[1] - want[1]).abs().max()) if got[1].numel() \
            else 0.0
        freq_err = (float((got[2] - want[2]).abs().max())
                    if w and got[2].numel() else 0.0)
        fleet_err = max((int((g.int() - h.int()).abs().max())
                         for g, h in zip(per_frame, plain_frames)
                         if g.numel()), default=0)
        cost_ok = (torch.allclose(got[1], want[1], rtol=1e-12, atol=0)
                   and torch.equal(got[1].view(torch.int64),
                                   again[1].view(torch.int64)))
        freq_ok = not w or torch.equal(got[2].view(torch.int64),
                                       want[2].view(torch.int64))
        ok = (torch.equal(got[0], want[0]) and cost_ok and freq_ok
              and torch.equal(again[0], got[0])
              and all(torch.equal(g, h)
                      for g, h in zip(per_frame, plain_frames))
              and all(torch.equal(g.view(t, s, p), got[0][k])
                      for k, g in enumerate(per_frame)))
        row = {"shape": name, "b": b, "t": t, "s": s, "p": p, "c": c,
               "w": w, "plane_strides": list(vmin.stride()), "equal": ok,
               "scan_max_abs_err": scan_err, "cost_max_abs_err": cost_err,
               "freq_max_abs_err": freq_err,
               "fleet_scan_max_abs_err": fleet_err}
        if not ok:
            emit("kernel", kernel="fleet", **row)
            raise AssertionError(f"fleet kernels disagree with their plain "
                                 f"versions at {name}: {row}")
        errs["fleet_scan"] = max(errs["fleet_scan"], fleet_err)
        errs["decision_fused"] = max(errs["decision_fused"], scan_err,
                                     cost_err, freq_err)
        if name in ("fleet64 pass", "fleet16 pass"):
            times = time_fleet_kernels(device, dev[0], dev[1], vmin, vmax,
                                       by_path=True)
            row.update({f"{k}_{m}": v for k, d in times.items()
                        for m, v in d.items()})
            if main is None:
                main = times
        emit("kernel", kernel="fleet_scan+decision_fused", **row)
    return {kernel: {"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{kernel}.cu",
                     "replaces": line, "max_abs_err": errs[kernel],
                     "ms": main[kernel]["ms"],
                     "device_ms": main[kernel]["device_ms"],
                     "plain_ms": main[kernel]["plain_ms"],
                     "bound_ms": main[kernel]["bound_ms"],
                     "bound_by": main[kernel]["bound_by"],
                     "library_ms": None}
            for kernel, name, line in (
                ("fleet_scan", "fleet_scan.scan_fleet",
                 "src/repro/kernels/fleet_scan/fleet_scan.py:102"),
                ("decision_fused", "decision_fused.fused_decision",
                 "src/repro/kernels/decision_fused/decision_fused.py:207"))}


class ScanAudit:
    """Checks the first and then every ``every``-th fleet pass of a run,
    inside the run.

    Wraps the two compute entry points the FleetMatrix scores passes
    through: the scan the main path's own launches returned is held
    against the plain version on CPU copies of the same frames and plane.
    It launches nothing itself, so the kernels' launch counts stay the
    main path's.
    """

    def __init__(self, every: int):
        from repro_torch.engine import compute
        self.compute, self.every = compute, every
        self.calls = self.checked = 0
        self._fused, self._fleet = (compute.fused_frames_scan,
                                    compute.fleet_scan_matrix)
        compute.fused_frames_scan = self._wrap(self._fused, fused=True)
        compute.fleet_scan_matrix = self._wrap(self._fleet, fused=False)

    def close(self) -> None:
        self.compute.fused_frames_scan = self._fused
        self.compute.fleet_scan_matrix = self._fleet

    def _wrap(self, inner, fused: bool):
        def call(q_lo, q_hi, mins, maxs):
            got = inner(q_lo, q_hi, mins, maxs)
            self.calls += 1
            if (self.calls - 1) % self.every == 0:
                self.check(q_lo, q_hi, mins, maxs, got, fused)
                self.checked += 1
            return got
        return call

    def check(self, q_lo, q_hi, mins, maxs, got, fused: bool) -> None:
        import numpy as np
        import torch
        from repro_torch.kernels.decision_fused import ref as dref
        from repro_torch.kernels.fleet_scan import ref as fref
        lo, hi = torch.as_tensor(q_lo), torch.as_tensor(q_hi)
        cmin, cmax = mins.cpu(), maxs.cpu()
        if fused:
            want = dref.fused_decision(lo, hi, cmin, cmax)[0].numpy()
        else:
            want = np.stack([fref.scan_fleet(lo[k], hi[k], cmin,
                                             cmax).numpy()
                             for k in range(lo.shape[0])])
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"fleet_full: the kernel's scan of pass "
                                 f"{self.calls} differs from the plain "
                                 f"version on the same plane")


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.move_score import move_score
    from repro_torch.kernels.pruning import pruning
    from repro_torch.kernels.zorder import zorder
    return {"pruning": pruning.scan_matrix,
            "fleet_scan": fleet_scan.scan_fleet,
            "decision_fused": decision_fused.fused_decision,
            "move_score": move_score.move_scores,
            "zorder": zorder.zorder_keys64}


class PlanAudit:
    """Checks the first and then every ``every``-th planning call of a
    run, inside the run.

    Wraps the two compute entry points the migration planner scores its
    window through: the frequencies the main path's own launch returned
    are held against the plain version on CPU copies of the same window
    and plane, exactly.  It launches nothing itself.
    """

    def __init__(self, every: int):
        from repro_torch.engine import compute
        self.compute, self.every = compute, every
        self.calls = self.checked = 0
        self._move, self._fused = (compute.move_frequencies,
                                   compute.fused_window_freq)
        compute.move_frequencies = self._wrap(self._move, fused=False)
        compute.fused_window_freq = self._wrap(self._fused, fused=True)

    def close(self) -> None:
        self.compute.move_frequencies = self._move
        self.compute.fused_window_freq = self._fused

    def _wrap(self, inner, fused: bool):
        def call(q_lo, q_hi, mins, maxs):
            got = inner(q_lo, q_hi, mins, maxs)
            self.calls += 1
            if (self.calls - 1) % self.every == 0:
                self.check(q_lo, q_hi, mins, maxs, got, fused)
                self.checked += 1
            return got
        return call

    def check(self, q_lo, q_hi, mins, maxs, got, fused: bool) -> None:
        import numpy as np
        import torch
        from repro_torch.kernels.move_score import ref as mref
        lo, hi = torch.as_tensor(q_lo), torch.as_tensor(q_hi)
        cmin, cmax = mins.cpu(), maxs.cpu()
        if fused:
            want = np.stack([mref.move_scores(lo, hi, cmin[t], cmax[t])
                             .numpy() for t in range(cmin.shape[0])])
        else:
            want = mref.move_scores(lo, hi, cmin, cmax).numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"the kernel's frequencies of planning call "
                                 f"{self.calls} differ from the plain "
                                 f"version on the same plane")


# ---------------------------------------------------------------------------
# The move-score kernel
# ---------------------------------------------------------------------------

def move_bound(q: int, s: int, p: int, c: int) -> dict:
    """Least time for a (Q, C) window against an (S, P, C) plane: the plane
    and window read once, the (S, P) float64 result written once; 3
    float64 operations per (q, s, p, c)."""
    nbytes = (2 * s * p * c + 2 * q * c + s * p) * 8
    ops = 3 * q * s * p * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def window_operands(rng, q: int, s: int, p: int, c: int, identity: bool):
    """A (Q, C) window and an (S, P, C) plane as the planner gives them:
    empty partitions and padding of [+inf, -inf], window bounds of +-inf
    and bounds equal to zone-map ends; ``identity`` makes half the
    partitions identity rows and half the window rows [-inf, +inf]."""
    import numpy as np
    mins = rng.uniform(0, 100, (s, p, c))
    maxs = mins + rng.uniform(0, 30, (s, p, c))
    empty = rng.random((s, p)) < (0.5 if identity else 0.15)
    mins[empty], maxs[empty] = np.inf, -np.inf
    mins[:, p - p // 4:], maxs[:, p - p // 4:] = np.inf, -np.inf   # padding
    lo = rng.uniform(-10, 110, (q, c))
    hi = lo + rng.uniform(0, 60, (q, c))
    if s * p and c:
        pick = rng.integers(0, s * p, (q, c))
        flat_min, flat_max = mins.reshape(-1, c), maxs.reshape(-1, c)
        cols = np.broadcast_to(np.arange(c), (q, c))
        at_min = rng.random((q, c)) < 0.2
        at_max = rng.random((q, c)) < 0.2
        hi[at_min] = flat_min[pick, cols][at_min]
        lo[at_max] = flat_max[pick, cols][at_max]
    lo[rng.random((q, c)) < 0.35] = -np.inf
    hi[rng.random((q, c)) < 0.35] = np.inf
    if identity:
        lo[::2], hi[::2] = -np.inf, np.inf
    return lo, hi, mins, maxs


#: (name, Q, S, P, C, c_pad, p_pad, bounds).  The first is the planning
#: shape of the fleet cells (2 layouts of P 16, C 8, a 64-query window),
#: the second the single-table cell's (P 32, C 32).  ``c_pad`` and
#: ``p_pad`` make the plane a view of one with more columns or partitions
#: (partition and state strides the kernel reads in place).  ``bounds``:
#: "identity" makes half the partitions identity rows and half the window
#: rows [-inf, +inf]; "nan" puts NaN into 5 % of the bounds; "few" leaves
#: every column past the eighth unbounded, so that wide windows still
#: overlap.  A C of "limit" is the tile's column limit
#: (``decision_fused_max_columns()``, 2,905), "limit + 1" the first width
#: the thread-per-output kernel takes.  The tile holds 96 KB of zone maps
#: (60 slots at C 100: "S * P past one tile" loops over two tiles a block).
MOVE_SHAPES = [
    ("fleet plan 64 x 2 x 16 x 8", 64, 2, 16, 8, 0, 0, ""),
    ("single-table plan 64 x 2 x 32 x 32", 64, 2, 32, 32, 0, 0, ""),
    ("one query", 1, 2, 16, 8, 0, 0, ""),
    ("ragged P 37", 64, 2, 37, 8, 0, 0, ""),
    ("ragged P 130", 64, 2, 130, 8, 0, 0, ""),
    ("wide S 4096", 64, 4096, 16, 8, 0, 0, ""),
    ("strided plane view", 64, 2, 32, 32, 3, 0, ""),
    ("state-strided plane view", 64, 2, 16, 8, 0, 3, ""),
    ("+-inf rows", 64, 2, 16, 8, 0, 0, "identity"),
    ("window past 48 KB of shared memory", 200, 2, 33, 100, 0, 0, ""),
    ("zero columns", 9, 2, 20, 0, 0, 0, ""),
    ("W 1,000", 1_000, 2, 16, 8, 0, 0, ""),
    ("NaN zone maps and window bounds", 64, 2, 16, 8, 0, 0, "nan"),
    ("NaN, strided, ragged", 64, 3, 37, 8, 2, 1, "nan"),
    ("S * P past one tile", 64, 4, 4_000, 100, 0, 0, ""),
    ("columns at the tile's limit", 64, 2, 5, "limit", 0, 0, "few"),
    ("columns past the tile's limit", 100, 2, 5, "limit + 1", 1, 0, "few"),
]


def move_plane(device, mins, maxs, c_pad: int = 0, p_pad: int = 0):
    """The (S, P, C) plane on ``device``; with ``c_pad`` / ``p_pad`` a view
    of a plane with more columns / partitions."""
    import torch
    s, p, c = mins.shape
    wmin = torch.zeros((s, p + p_pad, c + c_pad), dtype=torch.float64,
                       device=device)
    wmax = torch.zeros_like(wmin)
    wmin[:, :p, :c] = torch.as_tensor(mins, device=device)
    wmax[:, :p, :c] = torch.as_tensor(maxs, device=device)
    return wmin[:, :p, :c], wmax[:, :p, :c]


def phase_move_score_kernel(device) -> dict:
    """move_score against its plain version over MOVE_SHAPES, bitwise, on
    the path the kernel chooses and on each forced one; times at the two
    planning shapes (each path's device time too), and the fused decision
    kernel's freq-only launch at the fleet's; returns the kernel's summary
    at the fleet planning shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import _backend
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.move_score import move_score, ref as mref
    rng = np.random.default_rng(2)
    lib = move_score._lib()
    limit = decision_fused._lib().decision_fused_max_columns()
    stream = _backend.stream_handle(device)
    results = []
    for name, q, s, p, c, c_pad, p_pad, bounds in MOVE_SHAPES:
        c = {"limit": limit, "limit + 1": limit + 1}.get(c, c)
        lo, hi, mins, maxs = window_operands(rng, q, s, p, c,
                                             bounds == "identity")
        if bounds == "nan":
            with_nans(rng, lo, hi, mins, maxs)
        if bounds == "few":
            lo[:, 8:], hi[:, 8:] = -np.inf, np.inf
        vmin, vmax = move_plane(device, mins, maxs, c_pad, p_pad)
        dlo, dhi = (torch.as_tensor(a, device=device) for a in (lo, hi))
        want = mref.move_scores(dlo, dhi, vmin, vmax)
        got = {path: move_score.move_scores(dlo, dhi, vmin, vmax, path=path)
               for path in (0, *FLEET_PATHS)}
        torch.cuda.synchronize()
        err = float((got[0] - want).abs().max()) if want.numel() else 0.0
        row = {"shape": name, "q": q, "s": s, "p": p, "c": c,
               "plane_strides": list(vmin.stride()),
               "equal": all(torch.equal(g.view(torch.int64),
                                        want.view(torch.int64))
                            for g in got.values()), "max_abs_err": err}
        if not row["equal"]:
            emit("kernel", kernel="move_score", **row)
            raise AssertionError(f"move_score disagrees with its plain "
                                 f"version at {name}: {row}")
        if len(results) < 2:
            out = torch.empty((s, p), dtype=torch.float64, device=device)

            def raw(path=0):
                lib.move_score(dlo.data_ptr(), dhi.data_ptr(),
                               vmin.data_ptr(), vmax.data_ptr(),
                               vmin.stride(0), vmin.stride(1),
                               out.data_ptr(), q, s, p, c, path, stream)
            row.update({
                "ms": cuda_time_ms(raw, 200),
                "device_ms": device_ms(raw, 200, "move_score_kernel"),
                "wrapper_ms": cuda_time_ms(lambda: move_score.move_scores(
                    dlo, dhi, vmin, vmax), 200),
                "plain_ms": cuda_time_ms(lambda: mref.move_scores(
                    dlo, dhi, vmin, vmax), 200),
                **move_bound(q, s, p, c)})
            for path, key in FLEET_PATHS.items():
                row[f"ms_{key}"] = cuda_time_ms(lambda: raw(path), 200)
                row[f"device_ms_{key}"] = device_ms(
                    lambda: raw(path), 200, "move_score_kernel")
            # One column fewer and one more: the staged window rows are C
            # doubles apart, so an odd C spreads a warp's rows over the
            # shared-memory banks and an even one does not.
            row["device_ms_by_columns"] = {}
            for cc in (c - 1, c + 1):
                ops = [torch.as_tensor(a, device=device) for a in
                       window_operands(np.random.default_rng(cc), q, s, p,
                                       cc, False)]
                row["device_ms_by_columns"][cc] = device_ms(
                    lambda: move_score.move_scores(*ops), 200,
                    "move_score_kernel")
        if len(results) == 0:
            # The planner's other lane: one fused decision launch with no
            # frames and the window's freq only, over the (1, S, P, C)
            # plane: the same tile on the same operands.
            frames = torch.empty((0, 1, c), dtype=torch.float64,
                                 device=device)
            freq = torch.empty((1, s, p), dtype=torch.float64, device=device)
            dlib = decision_fused._lib()
            pmin, pmax = vmin[None], vmax[None]

            def raw_fused():
                dlib.decision_fused(
                    frames.data_ptr(), frames.data_ptr(), pmin.data_ptr(),
                    pmax.data_ptr(), pmin.stride(0), pmin.stride(1),
                    pmin.stride(2), None, None, dlo.data_ptr(),
                    dhi.data_ptr(), None, None, freq.data_ptr(), 0, 1, s,
                    p, c, q, 0, stream)
            fused = decision_fused.fused_decision(
                frames, frames, pmin, pmax, w_lo=dlo, w_hi=dhi,
                emit_scan=False)[2]
            torch.cuda.synchronize()
            if not torch.equal(fused[0], want):
                raise AssertionError("decision_fused's freq-only launch "
                                     "differs from move_score's plain "
                                     "version")
            row["decision_fused_freq_only"] = {
                "ms": cuda_time_ms(raw_fused, 200),
                "device_ms": device_ms(raw_fused, 200,
                                       "decision_fused_kernel"),
                "wrapper_ms": cuda_time_ms(
                    lambda: decision_fused.fused_decision(
                        frames, frames, pmin, pmax, w_lo=dlo, w_hi=dhi,
                        emit_scan=False), 200),
                **plane_bound(0, 1, s * p, c, w=q)}
        results.append(row)
        emit("kernel", kernel="move_score.move_scores", **row)
    main = results[0]
    return {"name": "move_score.move_scores", "route": "cuda",
            "source": "src/repro_torch/csrc/move_score.cu",
            "replaces": "src/repro/kernels/move_score/move_score.py:91",
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None}


# ---------------------------------------------------------------------------
# The fleet: parity card against CPU, and the full-width cells
# ---------------------------------------------------------------------------

FLEET_SCENARIOS = ("sudden_shift", "gradual_drift", "cyclic_diurnal",
                   "flash_crowd", "template_churn")


def fleet_schedulers():
    from repro_torch import engine
    return {"unlimited": engine.UnlimitedScheduler,
            "k1": lambda: engine.KConcurrentScheduler(1),
            "bucket": lambda: engine.TokenBucketScheduler(
                rate=0.01, capacity=1.0, initial=0.0)}


def oreo_tenant(data, alpha: float, delta: int, partitions: int, seed: int,
                window: int, gen_every: int, backend=None, **engine_kw):
    """One OREO tenant engine over ``data`` (benchmarks/bench_fleet.py's
    tenant_engine); ``engine_kw`` reaches ``LayoutEngine`` (incremental
    mode, row budget, planner lane)."""
    from repro_torch import core, engine
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=core.LayoutManagerConfig(
                              target_partitions=partitions,
                              window_size=window, gen_every=gen_every))
    policy = engine.OreoPolicy(data, core.build_default_layout(
        0, data, partitions), core.make_generator("qdtree"), cfg)
    return engine.LayoutEngine(policy, backend or engine.InMemoryBackend(data),
                               delta=cfg.delta, **engine_kw)


def threshold_tenant(data, threshold: float, space=None, delta: int = 2):
    from repro_torch import core, engine
    if space is None:
        space = [core.build_default_layout(
            sid, data, 8, sort_col=sid % data.shape[1]) for sid in range(3)]
    return engine.LayoutEngine(engine.ThresholdSwitchPolicy(
        space, alpha=10.0, threshold=threshold),
        engine.InMemoryBackend(data), delta=delta)


def fleet_trace(res) -> tuple:
    """Everything of a FleetResult that must be bitwise equal."""
    return (tuple((tid, r.query_costs.tobytes(), tuple(r.reorg_indices),
                   r.state_seq.tobytes())
                  for tid, r in res.per_tenant.items()),
            res.ticks, res.swaps_deferred, res.deferred_ticks,
            tuple(sorted(res.scheduler_stats.items())))


FLEET_PARITY_POLICIES = ("oreo", "threshold0", "threshold0.05",
                         "threshold1e+09")


def fleet_parity_job(job: dict, rows: int = 20_000, columns: int = 8,
                     queries: int = 120) -> dict:
    """fleet_parity's runs for one of FLEET_PARITY_POLICIES, card against
    CPU, in a spawned worker (or here): the five drift scenarios x three
    schedulers, each through ``run`` and ``run_batched`` on both lanes on
    both devices; every trace must equal the CPU's ``run``.  Returns the
    combinations, the card's launches and the seconds."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.pruning import pruning
    torch.set_num_threads(1)
    device, policy = torch.device(job["device"]), job["policy"]
    tables = {f"t{t}": np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(rows, columns)) for t in range(3)}
    lo = np.min([d.min(0) for d in tables.values()], axis=0)
    hi = np.max([d.max(0) for d in tables.values()], axis=0)
    data = {dev.type: {tid: torch.as_tensor(d, device=dev)
                       for tid, d in tables.items()}
            for dev in (device, torch.device("cpu"))}
    if policy == "oreo":
        def make(d):
            return oreo_tenant(d, 10.0, 5, 8, 2, 60, 30)
    else:
        def make(d, th=float(policy[len("threshold"):])):
            return threshold_tenant(d, th)
    counters = (pruning.scan_matrix, fleet_scan.scan_fleet,
                decision_fused.fused_decision)
    launched = {c.__name__: 0 for c in counters}
    combos = 0
    t0 = time.perf_counter()
    for scenario in FLEET_SCENARIOS:
        stream = core.make_drift_scenario(scenario, lo, hi, num_tenants=3,
                                          queries_per_tenant=queries, seed=7)
        for sname, sched in fleet_schedulers().items():
            traces = {}
            for dev in data:
                for mode in ("run", "fleet_scan", "decision_fused"):
                    before = [c.launches for c in counters]
                    fleet = engine.FleetEngine(
                        {tid: make(data[dev][tid])
                         for tid in stream.tenant_ids}, sched())
                    res = (fleet.run(stream) if mode == "run" else
                           fleet.run_batched(stream, compute=mode))
                    traces[dev, mode] = fleet_trace(res)
                    for c, b in zip(counters, before):
                        if dev == "cuda":
                            launched[c.__name__] += c.launches - b
                        elif c.launches != b:
                            raise AssertionError("fleet_parity: a CPU "
                                                 "run launched a kernel")
            want = traces["cpu", "run"]
            bad = [k for k, v in traces.items() if v != want]
            if bad:
                emit("fleet_parity", policy=policy, scenario=scenario,
                     scheduler=sname, bitwise_equal=False, differ=bad)
                raise AssertionError(f"fleet_parity: {policy} "
                                     f"{scenario} {sname}: {bad} differ "
                                     f"from the CPU run")
            combos += 1
    return {"combos": combos, "launches": launched,
            "seconds": time.perf_counter() - t0}


def start_fleet_parity(device, pool):
    """Submits fleet_parity_job for each policy now to ``pool``; returns a
    function that waits for them and gives their results in order."""
    futures = [pool.submit(fleet_parity_job, {"device": device.type,
                                              "policy": policy})
               for policy in FLEET_PARITY_POLICIES]
    return lambda: [f.result() for f in futures]


def phase_fleet_parity(device, host=None) -> dict:
    """Card against CPU, every fleet path: fleet_parity_job for each
    policy, from ``host`` (start_fleet_parity's function, whose jobs ran
    in spawned workers beside the other parity phases) or here if it is
    None; returns the card's launches."""
    t0 = time.perf_counter()
    results = (host() if host is not None else
               [fleet_parity_job({"device": device.type, "policy": policy})
                for policy in FLEET_PARITY_POLICIES])
    launched = {}
    for policy, out in zip(FLEET_PARITY_POLICIES, results):
        for k, n in out["launches"].items():
            launched[k] = launched.get(k, 0) + n
        emit("fleet_parity", policy=policy, scenarios=len(FLEET_SCENARIOS),
             schedulers=3, runs_per_combo=6, bitwise_equal=True,
             job_seconds=out["seconds"])
    if not (launched["scan_fleet"] and launched["fused_decision"]):
        raise AssertionError(f"fleet_parity: the card runs did not launch "
                             f"both fleet kernels: {launched}")
    emit("fleet_parity", combos=sum(r["combos"] for r in results),
         launches_card=launched, seconds=time.perf_counter() - t0)
    return launched


class PassCounter:
    """Counts a fleet's bulk commits and refused (replayed) passes."""

    def __init__(self, fleet):
        self.bulk = self.replayed = 0
        inner = fleet._bulk_pass

        def bulk_pass(*args):
            ok = inner(*args)
            if ok:
                self.bulk += 1
            else:
                self.replayed += 1
            return ok
        fleet._bulk_pass = bulk_pass


def fleet_tables(device, tenants: int, rows: int, columns: int) -> dict:
    """``default_rng(FLEET_SEED + t).uniform(0, 100)`` tables
    (benchmarks/bench_fleet.py make_tenant_data) as device tensors, drawn
    by eight threads: each tenant has its own generator, and numpy's fill
    and the copy to the card release the GIL, so the tables are the same
    bits as one tenant at a time."""
    import concurrent.futures as cf
    import numpy as np
    import torch

    def draw(t: int):
        return torch.as_tensor(np.random.default_rng(FLEET_SEED + t).uniform(
            0, 100, size=(rows, columns)), device=device)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        return {f"t{t}": d for t, d in enumerate(pool.map(draw,
                                                          range(tenants)))}


def run_cell(name: str, fleet, events, lane: str, device) -> tuple:
    """One main-path run: counts reset just before, read just after, the
    first and every 50th pass audited; returns (result, line fields)."""
    import numpy as np
    import torch
    counters = kernel_counters()
    passes = PassCounter(fleet)
    audit = ScanAudit(every=50)
    plans = PlanAudit(every=50)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        res = fleet.run_batched(events, compute=lane)
        torch.cuda.synchronize()
    finally:
        audit.close()
        plans.close()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for tid, r in res.per_tenant.items():
        costs = r.query_costs
        if not (np.isfinite(costs).all() and (costs >= 0).all()
                and (costs <= 1).all() and len(r.state_seq) == len(costs)):
            raise AssertionError(f"{name}: {tid}'s trace is malformed")
    if launches[lane] <= 0:
        raise AssertionError(f"{name}: the {lane} lane never launched its "
                             f"kernel")
    if audit.checked < -(-audit.calls // 50):
        raise AssertionError(f"{name}: only {audit.checked} of "
                             f"{audit.calls} passes were audited")
    if plans.checked < -(-plans.calls // 50):
        raise AssertionError(f"{name}: only {plans.checked} of "
                             f"{plans.calls} planning calls were audited")
    fm = fleet.fleet_matrix
    return res, {
        "lane": lane, "events": len(events), "run_wall_seconds": wall,
        "events_per_second": len(events) / wall,
        "decide_seconds": res.decide_seconds,
        "reorg_seconds": res.reorg_seconds,
        "serve_seconds": res.serve_seconds,
        "launches": launches, "passes_scored": audit.calls,
        "passes_audited": audit.checked, "planning_calls": plans.calls,
        "planning_calls_audited": plans.checked, "bulk_passes": passes.bulk,
        "replayed_passes": passes.replayed,
        "plane_shape": [fm._tcap, fm.state_capacity,
                        fm.partition_capacity, fm.num_columns],
        "peak_bytes": torch.cuda.max_memory_allocated(device),
        "total_cost": res.total_cost, "query_cost": res.total_query_cost,
        "reorg_cost": res.total_reorg_cost, "moves": res.num_reorgs,
        "swaps_deferred": res.swaps_deferred,
        "deferred_ticks": res.deferred_ticks,
        "scheduler_stats": res.scheduler_stats}


def cell_fleet16(device, rows: int = SF1_ROWS, tenants: int = 16,
                 queries: int = 750) -> dict:
    """fleet16-sf1-oreo-k1: 16 OREO tenants under one maintenance worker
    (benchmarks/bench_fleet.py:59-70 configuration, BENCH_fleet.json
    config: alpha 20, delta 10, P 16, window 80, gen_every 40), its 1,500
    queries per tenant cut to 750 for the script's time."""
    import torch
    from repro_torch import core, engine
    name = "fleet16-sf1-oreo-k1"
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 8)
    torch.cuda.synchronize()
    table_seconds = time.perf_counter() - t0
    lo = torch.stack([d.amin(0) for d in tables.values()]).amin(0)
    hi = torch.stack([d.amax(0) for d in tables.values()]).amax(0)
    stream = core.make_drift_scenario("sudden_shift", lo.cpu().numpy(),
                                      hi.cpu().numpy(), num_tenants=tenants,
                                      queries_per_tenant=queries, seed=7)
    t0 = time.perf_counter()
    fleet = engine.FleetEngine(
        {tid: oreo_tenant(tables[tid], 20.0, 10, 16, 0, 80, 40)
         for tid in stream.tenant_ids}, engine.KConcurrentScheduler(1))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    res, fields = run_cell(name, fleet, stream.events, "decision_fused",
                           device)
    if res.num_reorgs <= 0:
        raise AssertionError(f"{name}: no tenant reorganized")
    fm = fleet.fleet_matrix
    times = time_fleet_kernels(device, *fleet_frames(fm, device),
                               fm._mins, fm._maxs)
    emit("fleet_full", cell=name, tenants=tenants, rows=rows, columns=8,
         queries_per_tenant=queries,
         reduced={"queries_per_tenant": f"1500 -> {queries}"},
         scenario="sudden_shift",
         scheduler="k1", table_bytes=sum(d.numel() * 8
                                         for d in tables.values()),
         table_seconds=table_seconds, setup_seconds=setup,
         kernels_at_final_plane=times, **fields)
    return fields["launches"]


def fleet_frames(fm, device, b: int = 16):
    """B frames of unbounded and bounded queries for every tenant row of
    ``fm``'s plane, on ``device`` (for timing at the run's final shape)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    t, c = fm._tcap, fm.num_columns
    lo = rng.uniform(0, 80, (b, t, c))
    hi = lo + 20
    lo[rng.random((b, t, c)) < 0.5] = -np.inf
    hi[rng.random((b, t, c)) < 0.5] = np.inf
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


def projection_space(data, num_states: int, partitions: int, rng) -> list:
    """S layouts that each sort the table along a random projection and
    cut it into equal partitions (benchmarks/bench_fleet.py:73-90), on the
    table's device.  Their zone maps are exact, so each is its own
    materialized layout."""
    import torch
    from repro_torch.core import layouts
    n = len(data)
    ranks = torch.arange(n, device=data.device) * partitions // n
    out = []
    for s in range(num_states):
        proj = data @ torch.as_tensor(rng.normal(size=data.shape[1]),
                                      device=data.device)
        assignment = torch.empty_like(ranks)
        assignment[torch.argsort(proj, stable=True)] = ranks
        del proj
        meta = layouts.metadata_from_assignment(data, assignment, partitions)
        out.append(layouts.Layout(layout_id=s, name=f"synthetic-{s}",
                                  technique="synthetic", meta=meta))
    return out


def selective_events(tables: dict, queries: int) -> list:
    """Selective conjunctive range queries bounding every column of each
    tenant's table at selectivity 0.1, round robin over the tenants
    (benchmarks/bench_fleet.py:132-145, 153-161)."""
    import numpy as np
    from repro_torch.core import workload as wl
    per = {}
    for i, (tid, data) in enumerate(sorted(tables.items())):
        col_lo, col_hi = (data.amin(0).cpu().numpy(),
                          data.amax(0).cpu().numpy())
        rng = np.random.default_rng(FLEET_SEED + i)
        span = col_hi - col_lo
        width = span * 0.1
        per[tid] = []
        for _ in range(queries):
            start = col_lo + rng.uniform(0, 1, len(span)) * (span - width)
            per[tid].append(wl.Query(lo=start, hi=start + width))
    return [wl.QueryEvent(tid, per[tid][k]) for k in range(queries)
            for tid in sorted(tables)]


def cell_fleet64(device, rows: int = SF1_ROWS, tenants: int = 64,
                 queries: int = 300) -> dict:
    """fleet64-sf1-threshold: 64 threshold tenants (0.05, alpha 10) over 8
    projection-sorted layouts of P 8 each, scored in one pass
    (benchmarks/bench_fleet.py tenant sweep, T = 64: 10 columns, 8 states,
    8 partitions, 300 queries per tenant), on both lanes."""
    import numpy as np
    import torch
    from repro_torch import engine
    name = "fleet64-sf1-threshold"
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 10)
    torch.cuda.synchronize()
    table_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    spaces = {tid: projection_space(tables[tid], 8, 8,
                                    np.random.default_rng(FLEET_SEED + 7 * i))
              for i, tid in enumerate(sorted(tables))}
    torch.cuda.synchronize()
    space_seconds = time.perf_counter() - t0
    events = selective_events(tables, queries)
    launches, traces = {}, {}
    for lane in ("fleet_scan", "decision_fused"):
        t0 = time.perf_counter()
        fleet = engine.FleetEngine(
            {tid: threshold_tenant(tables[tid], 0.05, spaces[tid], delta=0)
             for tid in sorted(tables)}, engine.UnlimitedScheduler())
        setup = time.perf_counter() - t0
        res, fields = run_cell(name, fleet, events, lane, device)
        traces[lane] = fleet_trace(res)
        launches[lane] = fields["launches"]
        extra = {}
        if lane == "decision_fused":
            fm = fleet.fleet_matrix
            extra["kernels_at_final_plane"] = time_fleet_kernels(
                device, *fleet_frames(fm, device), fm._mins, fm._maxs)
        emit("fleet_full", cell=name, tenants=tenants, rows=rows, columns=10,
             states=8, partitions=8, queries_per_tenant=queries,
             threshold=0.05, scheduler="unlimited",
             table_bytes=sum(d.numel() * 8 for d in tables.values()),
             table_seconds=table_seconds,
             state_space_seconds=space_seconds, setup_seconds=setup,
             **fields, **extra)
    if traces["fleet_scan"] != traces["decision_fused"]:
        raise AssertionError(f"{name}: the two lanes' traces differ")
    emit("fleet_full", cell=name, lanes_bitwise_equal=True)
    return launches


def release(device) -> None:
    """Free what the last cell left behind before the next one measures its
    peak: a fleet and its tenants' engines hold each other (the governor),
    so their tables go only when the cycle collector runs."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_fleet_full(device) -> dict:
    """Both fleet cells; returns each main path's launch counts."""
    runs = {"fleet16-sf1-oreo-k1": cell_fleet16(device)}
    release(device)
    for lane, counts in cell_fleet64(device).items():
        runs[f"fleet64-sf1-threshold/{lane}"] = counts
    release(device)
    return runs


# ---------------------------------------------------------------------------
# The incremental reorganization plane
# ---------------------------------------------------------------------------

def engine_ledgers(engine) -> tuple:
    """An engine's MigrationRecords, ledgers included (none if atomic)."""
    ex = engine.reorg_executor
    return () if ex is None else tuple(
        (m.target_state, m.charged_at, m.begun_at, m.completed_at, m.alpha,
         m.total_rows, m.moved_rows, m.moves_total, m.moves_done,
         tuple(m.charges), m.charged) for m in ex.migrations)


def run_trace(res) -> tuple:
    """Everything of one engine's RunResult that must be bitwise equal."""
    return (res.query_costs.tobytes(), tuple(res.reorg_indices),
            res.state_seq.tobytes())


def phase_reorg_parity(device, rows: int = 20_000, queries: int = 120,
                       disk_rows: int = 5_000) -> dict:
    """Card against CPU over the incremental plane (tests/test_reorg.py's
    goldens); returns the card's launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import core, engine
    cpu = torch.device("cpu")
    counters = kernel_counters()
    launched = {k: 0 for k in counters}
    tables = {f"t{t}": np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(rows, 8)) for t in range(3)}
    lo = np.min([d.min(0) for d in tables.values()], axis=0)
    hi = np.max([d.max(0) for d in tables.values()], axis=0)
    data = {dev.type: {tid: torch.as_tensor(d, device=dev)
                       for tid, d in tables.items()}
            for dev in (device, cpu)}
    t0 = time.perf_counter()

    def counted(dev, fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        for k, c in counters.items():
            if dev.type == "cuda":
                launched[k] += c.launches - before[k]
            elif c.launches != before[k]:
                raise AssertionError("reorg_parity: a CPU run launched a "
                                     "kernel")
        return out

    def fleet_run(dev, stream, sched, incremental, rpt=None, mode="run",
                  planner="move_score"):
        kw = ({"incremental": True, "rows_per_tick": rpt,
               "reorg_compute": planner} if incremental else {})
        fleet = engine.FleetEngine(
            {tid: oreo_tenant(data[dev.type][tid], 10.0, 5, 8, 2, 60, 30,
                              **kw)
             for tid in stream.tenant_ids}, sched)
        res = counted(dev, lambda: fleet.run(stream) if mode == "run"
                      else fleet.run_batched(stream, compute=mode))
        return fleet_trace(res), tuple(
            (tid, engine_ledgers(fleet.tenant(tid)))
            for tid in fleet.tenant_ids)

    def same(label, runs):
        want = runs[0]
        bad = [k for k, v in enumerate(runs) if v != want]
        if bad:
            emit("reorg_parity", case=label, bitwise_equal=False, differ=bad)
            raise AssertionError(f"reorg_parity: {label}: runs {bad} differ")

    # 1. Unbounded incremental == atomic, card == CPU: 5 scenarios x 3
    #    schedulers (tests/test_reorg.py:201-233).
    for scenario in FLEET_SCENARIOS:
        stream = core.make_drift_scenario(scenario, lo, hi, num_tenants=3,
                                          queries_per_tenant=queries, seed=7)
        for sname, sched in fleet_schedulers().items():
            runs = {}
            for label, dev in (("card", device), ("host", cpu)):
                runs[label, "atomic"] = fleet_run(dev, stream, sched(),
                                                  False)
                runs[label, "incr"] = fleet_run(dev, stream, sched(), True)
            same(f"{scenario}/{sname}: incremental vs atomic",
                 [runs[k][0] for k in runs])
            same(f"{scenario}/{sname}: ledgers card vs CPU",
                 [runs["card", "incr"][1], runs["host", "incr"][1]])
            for tid, migs in runs["card", "incr"][1]:
                for m in migs:     # completed_at == begun_at, charged == alpha
                    if not (m[3] == m[2] and m[10] == m[4]):
                        raise AssertionError(f"reorg_parity: {scenario}/"
                                             f"{sname}: {tid} migration "
                                             f"not atomic or not on alpha")
    emit("reorg_parity", case="incremental == atomic, 5 x 3",
         bitwise_equal=True, seconds=time.perf_counter() - t0)
    # 2. run and run_batched on both lanes, rows_per_tick None and 150
    #    (tests/test_reorg.py:236-255); both planner lanes.
    stream = core.make_drift_scenario("sudden_shift", lo, hi, num_tenants=3,
                                      queries_per_tenant=queries, seed=3)
    for rpt in (None, 150):
        runs = [fleet_run(cpu, stream, engine.UnlimitedScheduler(), True,
                          rpt)]
        for mode in ("run", "fleet_scan", "decision_fused"):
            for planner in ("move_score", "decision_fused"):
                runs.append(fleet_run(device, stream,
                                      engine.UnlimitedScheduler(), True,
                                      rpt, mode, planner))
        same(f"rows_per_tick={rpt}: run/run_batched x lanes x planners",
             runs)
    # 3. A row-denominated token bucket.
    runs = [fleet_run(dev, stream, engine.TokenBucketScheduler(
        rate=40.0, capacity=2000.0, initial=0.0, rows_per_token=1.0), True,
        None, "decision_fused") for dev in (device, cpu)]
    same("token bucket rows_per_token=1", runs)
    emit("reorg_parity", case="run/run_batched, budgets, planner lanes",
         bitwise_equal=True, seconds=time.perf_counter() - t0)
    # 4. A standalone engine at 137 rows per tick, both planner lanes
    #    (tests/test_reorg.py:312-331).
    rng = np.random.default_rng(6)
    table = rng.uniform(0, 100, size=(rows, 5))
    single = core.generate_workload(core.make_templates(2, 5, rng),
                                    table.min(0), table.max(0),
                                    total_queries=10 * queries // 6, seed=1,
                                    segment_length=(60, 90))
    runs = []
    for dev, planner in ((cpu, "move_score"), (device, "move_score"),
                         (device, "decision_fused")):
        eng = oreo_tenant(torch.as_tensor(table, device=dev), 10.0, 5, 8, 2,
                          60, 30, incremental=True, rows_per_tick=137,
                          reorg_compute=planner)
        res = counted(dev, lambda: eng.run(single))
        runs.append((run_trace(res), engine_ledgers(eng)))
    same("standalone rows_per_tick=137", runs)
    if not any(m[3] > m[2] for m in runs[0][1]):
        raise AssertionError("reorg_parity: 137 rows per tick spread no "
                             "migration over several steps")
    # 5. DiskBackend, writer thread off and on: atomic, incremental and a
    #    tight budget (tests/test_reorg.py:273-309).
    rng = np.random.default_rng(1)
    disk_table = rng.uniform(0, 100, size=(disk_rows, 4))
    disk_stream = core.generate_workload(
        core.make_templates(2, 4, rng), disk_table.min(0),
        disk_table.max(0), total_queries=80, seed=2,
        segment_length=(30, 50))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for background in (False, True):
            for mode, kw in (("atomic", {}),
                             ("incremental", {"incremental": True}),
                             ("tight", {"incremental": True,
                                        "rows_per_tick": 1000})):
                runs = []
                for label, dev in (("card", device), ("host", cpu)):
                    tdata = torch.as_tensor(disk_table, device=dev)
                    root = str(Path(tmp) / f"{mode}-{background}-{label}")
                    backend = engine.DiskBackend(tdata, root,
                                                 background=background)
                    eng = oreo_tenant(tdata, 8.0, 6, 6, 1, 30, 15,
                                      backend=backend, **kw)
                    res = counted(dev, lambda: eng.run(disk_stream))
                    backend.close()
                    runs.append((run_trace(res), engine_ledgers(eng)))
                same(f"DiskBackend {mode} background={background}", runs)
    emit("reorg_parity", case="DiskBackend atomic/incremental/tight x "
         "writer thread off/on", bitwise_equal=True,
         seconds=time.perf_counter() - t0)
    if not (launched["move_score"] and launched["decision_fused"]):
        raise AssertionError(f"reorg_parity: the card runs did not launch "
                             f"both planner kernels: {launched}")
    emit("reorg_parity", launches_card=launched,
         seconds=time.perf_counter() - t0)
    return launched


REORG_RATE = 0.002            # benchmarks/bench_reorg.py: bucket_rate


def cell_reorg(device, rows: int = SF1_ROWS, tenants: int = 16,
               queries: int = 500) -> dict:
    """fleet16-sf1-oreo-incr-bucket: 16 OREO tenants sharing one
    row-denominated maintenance budget (benchmarks/bench_reorg.py:54-75,
    180-198, BENCH_reorg.json config: alpha 10, delta 10, P 16, window
    80, gen_every 40, sudden_shift seed 7, 1,000 queries per tenant, bucket
    rate 0.002; its 1,000 queries per tenant cut to 500 for the script's
    time), in four arms over the same tables; returns each arm's
    launches."""
    import torch
    from repro_torch import core, engine
    name = "fleet16-sf1-oreo-incr-bucket"
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 8)
    torch.cuda.synchronize()
    table_seconds = time.perf_counter() - t0
    lo = torch.stack([d.amin(0) for d in tables.values()]).amin(0)
    hi = torch.stack([d.amax(0) for d in tables.values()]).amax(0)
    stream = core.make_drift_scenario("sudden_shift", lo.cpu().numpy(),
                                      hi.cpu().numpy(), num_tenants=tenants,
                                      queries_per_tenant=queries, seed=7)
    emit("reorg_full", cell=name, tenants=tenants, rows=rows, columns=8,
         queries_per_tenant=queries,
         reduced={"queries_per_tenant": f"1000 -> {queries}"},
         scenario="sudden_shift",
         table_bytes=sum(d.numel() * 8 for d in tables.values()),
         table_seconds=table_seconds,
         row_budget_per_tick=REORG_RATE * rows)
    arms = {
        "atomic/unlimited": (False, engine.UnlimitedScheduler),
        "incremental/unlimited": (True, engine.UnlimitedScheduler),
        "atomic/bucket": (False, lambda: engine.TokenBucketScheduler(
            rate=REORG_RATE, capacity=1.0, initial=0.0)),
        "incremental/bucket": (True, lambda: engine.TokenBucketScheduler(
            rate=REORG_RATE * rows, capacity=float(rows), initial=0.0,
            rows_per_token=1.0)),
    }
    launches, traces, results = {}, {}, {}
    for arm, (incremental, sched) in arms.items():
        kw = ({"incremental": True, "reorg_compute": "move_score"}
              if incremental else {})
        t0 = time.perf_counter()
        fleet = engine.FleetEngine(
            {tid: oreo_tenant(tables[tid], 10.0, 10, 16, 0, 80, 40, **kw)
             for tid in stream.tenant_ids}, sched())
        setup = time.perf_counter() - t0
        res, fields = run_cell(f"{name} {arm}", fleet, stream.events,
                               "decision_fused", device)
        ledger = {"migrations": 0, "completed": 0, "moves_done": 0,
                  "rows_moved": 0}
        for tid in fleet.tenant_ids:
            ex = fleet.tenant(tid).reorg_executor
            for m in (ex.migrations if ex is not None else ()):
                ledger["migrations"] += 1
                ledger["moves_done"] += m.moves_done
                ledger["rows_moved"] += m.moved_rows
                if m.completed_at >= 0:
                    ledger["completed"] += 1
                    if m.charged != m.alpha:
                        raise AssertionError(f"{name} {arm}: {tid}'s "
                                             f"ledger closed on {m.charged!r}"
                                             f", not alpha {m.alpha!r}")
        if incremental and fields["launches"]["move_score"] <= 0:
            raise AssertionError(f"{name} {arm}: the planner never launched "
                                 f"move_score")
        traces[arm] = fleet_trace(res)
        results[arm] = res
        launches[arm] = fields["launches"]
        emit("reorg_full", cell=name, arm=arm, setup_seconds=setup,
             ledger=ledger, **fields)
        del fleet, res
        release(device)
    if traces["incremental/unlimited"] != traces["atomic/unlimited"]:
        raise AssertionError(f"{name}: the unlimited arms differ")
    bucket = (results["atomic/bucket"], results["incremental/bucket"])
    if bucket[0].total_reorg_cost != bucket[1].total_reorg_cost:
        raise AssertionError(f"{name}: reorg cost differs between the "
                             f"bucket arms")
    emit("reorg_full", cell=name, unlimited_arms_bitwise_equal=True,
         bucket_reorg_cost_equal=True,
         atomic_over_incremental_total_cost=(bucket[0].total_cost
                                             / bucket[1].total_cost),
         card=card_line())
    return launches


# ---------------------------------------------------------------------------
# The streaming ingest plane and the manifest WAL
# ---------------------------------------------------------------------------

#: benchmarks/bench_ingest.py: the three compaction arms.
INGEST_ARMS = {"never": {"auto_compact": False},
               "always": {"debt_threshold": 0.0},
               "debt": {"debt_threshold": 1.0}}
#: The fields of BENCH_ingest.json that do not depend on the machine.
INGEST_FIELDS = ("total_cost", "query_cost", "reorg_cost", "reorgs",
                 "rows_appended", "rows_pending", "compactions",
                 "clustering_debt", "total_excess")
INGEST_SCENARIO_SEED = 7      # benchmarks/bench_ingest.py: bench_cell seed
#: The full section's scenarios that ingest_parity runs (all five before
#: the family phases; cut for the whole script's time).
INGEST_FULL_SCENARIOS = ("mixed_rw", "trickle")
INGEST_CELL = "fleet16-sf1-oreo-ingest-mixed_rw"
INGEST_BATCH_ROWS = 37_508    # mixed_rw's 50 of 8,000 rows, at 6,001,215
INGEST_TENANTS = 8            # the cell's 16 tenants, cut for script time


def ingest_tenant(data, alpha: float, delta: int, partitions: int,
                  arm: str, backend=None, **engine_kw):
    """One OREO tenant of benchmarks/bench_ingest.py (tenant_engine:
    window 80, gen_every 40, seed 0, the default layout sorted on column
    0) under one compaction arm; ``engine_kw`` reaches ``LayoutEngine``."""
    from repro_torch import core, engine
    cfg = core.OreoConfig(alpha=alpha, seed=0, delta=delta,
                          manager=core.LayoutManagerConfig(
                              target_partitions=partitions, window_size=80,
                              gen_every=40))
    policy = engine.OreoPolicy(
        data, core.build_default_layout(0, data, partitions, sort_col=0),
        core.make_generator("qdtree"), cfg)
    return engine.LayoutEngine(
        policy, backend or engine.InMemoryBackend(data), delta=cfg.delta,
        ingest=engine.IngestConfig(**INGEST_ARMS[arm]), **engine_kw)


def ingest_fields(res, fleet) -> dict:
    """An arm's deterministic fields, rounded as
    benchmarks/bench_ingest.py:86-124 rounds them."""
    appended = pending = compactions = 0
    debt = excess = 0.0
    for tid in fleet.tenant_ids:
        s = fleet.tenant(tid).ingest_stats()
        appended += s["ingested_rows"]
        pending += s["pending_rows"]
        compactions += len(s["compactions"])
        debt += s["clustering_debt"]
        excess += s["total_excess"]
    return {"total_cost": round(res.total_cost, 3),
            "query_cost": round(res.total_query_cost, 3),
            "reorg_cost": round(res.total_reorg_cost, 3),
            "reorgs": res.num_reorgs, "rows_appended": appended,
            "rows_pending": pending, "compactions": compactions,
            "clustering_debt": round(debt, 3),
            "total_excess": round(excess, 3)}


def ingest_trace(fleet, res) -> tuple:
    """A mixed-stream fleet run's trace, compactions and ingest counters."""
    return (fleet_trace(res), tuple(
        (tid, tuple(fleet.tenant(tid).compaction_indices),
         tuple(sorted(fleet.tenant(tid).ingest_stats().items(),
                      key=lambda kv: kv[0])))
        for tid in fleet.tenant_ids))


def ingest_tables(device, tenants: int, rows: int, columns: int) -> tuple:
    """benchmarks/bench_ingest.py make_tenant_data (seed 100) on
    ``device``, with the column bounds its streams are drawn over."""
    import numpy as np
    import torch
    host = {f"t{t}": np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(rows, columns)) for t in range(tenants)}
    lo = np.min([d.min(0) for d in host.values()], axis=0)
    hi = np.max([d.max(0) for d in host.values()], axis=0)
    return {tid: torch.as_tensor(d, device=device)
            for tid, d in host.items()}, lo, hi


def ingest_durable_parity(device, counted, rows: int = 20_000) -> None:
    """A durable DiskBackend under mixed_rw and the always arm, driven
    event by event through ``FleetEngine.step``: after every event the WAL
    replay equals the live manifest and pending batches, and the trace
    equals the InMemoryBackend's on the same card."""
    import tempfile
    from repro_torch import core, engine
    table, lo, hi = ingest_tables(device, 1, rows, 8)
    stream = core.make_ingest_scenario(
        "mixed_rw", lo, hi, num_tenants=1, queries_per_tenant=200,
        seed=INGEST_SCENARIO_SEED, batch_rows=50 * rows // 8_000)
    (ROOT / "build").mkdir(exist_ok=True)
    traces, replays, compactions = {}, 0, 0
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for kind in ("disk", "memory"):
            backend = (engine.DiskBackend(table["t0"], tmp, background=False,
                                          durable=True, wal_snapshot_every=8)
                       if kind == "disk" else None)
            fleet = engine.FleetEngine({"t0": ingest_tenant(
                table["t0"], 4.0, 10, 16, "always", backend=backend)})
            for ev in stream:
                counted(device, lambda: fleet.step("t0", ev[1]))
                if backend is None:
                    continue
                state = engine.DiskBackend.recover_state(tmp)
                store = Path(backend._serving_store.root)
                with open(store / "manifest.json") as f:
                    live = json.load(f)
                if (state["serving"] != store.name
                        or state["manifest"] != live
                        or [d["batch_id"] for d in state["deltas"]]
                        != [b.batch_id for b in backend.delta_log.batches]):
                    raise AssertionError("ingest_parity: the WAL replay "
                                         "differs from the live manifest")
                replays += 1
            traces[kind] = ingest_trace(fleet, fleet.result())
            if backend is not None:
                compactions = len(fleet.tenant("t0").compaction_indices)
                backend.close()
    if traces["disk"] != traces["memory"] or not compactions:
        raise AssertionError("ingest_parity: the durable DiskBackend's trace "
                             "differs from the InMemoryBackend's, or it "
                             "never compacted")
    emit("ingest_parity", case="DiskBackend(durable=True) 20,000 x 8",
         events=len(stream), replays_equal_live=replays,
         compactions=compactions, trace_equals_memory=True)


def ingest_file_job(job: dict) -> dict:
    """ingest_parity (a) at BENCH_ingest.json's full config for one
    scenario, run in a spawned worker on the device the job names: every
    arm through ``FleetEngine.run``; returns each arm's fields and total
    cost, the job's seconds and its kernel launches."""
    import torch
    from repro_torch import core, engine
    torch.set_num_threads(1)
    device = torch.device(job["device"])
    cfg = job["config"]
    counters = kernel_counters()
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    data, lo, hi = ingest_tables(device, cfg["tenants"], cfg["rows"],
                                 cfg["columns"])
    stream = core.make_ingest_scenario(
        job["scenario"], lo, hi, num_tenants=cfg["tenants"],
        queries_per_tenant=cfg["queries_per_tenant"],
        seed=INGEST_SCENARIO_SEED)
    got, combined = {}, {}
    for arm in INGEST_ARMS:
        fleet = engine.FleetEngine(
            {tid: ingest_tenant(data[tid], cfg["alpha"], cfg["delta"],
                                cfg["partitions"], arm)
             for tid in data}, engine.UnlimitedScheduler())
        res = fleet.run(stream)
        got[arm] = ingest_fields(res, fleet)
        combined[arm] = res.total_cost
    sync(device)
    return {"got": got, "combined": combined,
            "seconds": time.perf_counter() - t0,
            "launches": {k: c.launches - before[k]
                         for k, c in counters.items()}}


def start_ingest_file(device, pool):
    """Submits ingest_file_job for each of INGEST_FULL_SCENARIOS now to
    ``pool``; returns a function that waits for them and gives
    {scenario: result}."""
    bench = json.loads((ROOT / "BENCH_ingest.json").read_text())
    futures = {s: pool.submit(ingest_file_job, {
        "scenario": s, "config": bench["config"], "device": device.type})
        for s in INGEST_FULL_SCENARIOS}
    return lambda: {s: f.result() for s, f in futures.items()}


def phase_ingest_parity(device, file_host=None) -> dict:
    """(a) BENCH_ingest.json's deterministic fields on the card, at its
    full and smoke configs; (b) at the smoke config, run_batched on both
    lanes and the unbounded incremental fleet equal ``run``; (c) the
    smoke config's card traces equal the CPU's; (d) a durable
    DiskBackend's WAL replays to the live manifest after every event.
    (a)'s full config runs in spawned workers (ingest_file_job) from
    ``file_host``, start_ingest_file's function, or here if it is None.
    Returns the card's launches."""
    import torch
    from repro_torch import core, engine
    cpu = torch.device("cpu")
    bench = json.loads((ROOT / "BENCH_ingest.json").read_text())
    if file_host is None:
        file_host = (lambda: {s: ingest_file_job({
            "scenario": s, "config": bench["config"],
            "device": device.type}) for s in INGEST_FULL_SCENARIOS})
    counters = kernel_counters()
    launched = {k: 0 for k in counters}
    t0 = time.perf_counter()

    def counted(dev, fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        for k, c in counters.items():
            if dev.type == "cuda":
                launched[k] += c.launches - before[k]
            elif c.launches != before[k]:
                raise AssertionError("ingest_parity: a CPU run launched a "
                                     "kernel")
        return out

    def build(data, cfg, arm, **kw):
        return engine.FleetEngine(
            {tid: ingest_tenant(data[tid], cfg["alpha"], cfg["delta"],
                                cfg["partitions"], arm, **kw)
             for tid in data}, engine.UnlimitedScheduler())

    # (a) and (c): every scenario x arm with FleetEngine.run, at the
    # file's full config and (card and CPU) at its smoke config.
    sections = {"full": (bench["config"], {
        r["scenario"]: (r["arms"], r["cost_ratio_vs_debt_aware"])
        for r in bench["results"]}),
        "smoke": (bench["ingest_smoke"]["config"], {
            s: (None, ratio) for s, ratio in
            bench["ingest_smoke"]["cost_ratio_vs_debt_aware"].items()})}
    def same_as_run(data, cfg, scenario, stream, want) -> int:
        """(b) run_batched on both lanes and the unbounded incremental
        fleet (rows_per_tick None, both planner lanes) equal run's debt
        arm; returns the migrations checked."""
        migrations = 0
        for lane in ("fleet_scan", "decision_fused"):
            fleet = build(data, cfg, "debt")
            res = counted(device, lambda: fleet.run_batched(stream,
                                                            compute=lane))
            if ingest_trace(fleet, res) != want:
                raise AssertionError(f"ingest_parity: {scenario}: "
                                     f"run_batched({lane}) differs from run")
        for planner in ("move_score", "decision_fused"):
            fleet = build(data, cfg, "debt", incremental=True,
                          reorg_compute=planner)
            res = counted(device, lambda: fleet.run(stream))
            if ingest_trace(fleet, res) != want:
                raise AssertionError(f"ingest_parity: {scenario}: the "
                                     f"incremental fleet ({planner}) differs "
                                     f"from the atomic one")
            for tid in fleet.tenant_ids:
                for m in fleet.tenant(tid).reorg_executor.migrations:
                    migrations += 1
                    if not (m.completed_at == m.begun_at
                            and m.charged == m.alpha):
                        raise AssertionError(f"ingest_parity: {scenario} "
                                             f"{tid}: a migration did not "
                                             f"close on alpha at once")
        emit("ingest_parity", case="run_batched x 2 lanes, incremental x 2 "
             "planners == run", scenario=scenario, bitwise_equal=True,
             seconds=time.perf_counter() - t0)
        return migrations

    def file_section(section, scenario, got, combined, arms_want,
                     ratio_want, host) -> int:
        """Holds one scenario's arms against the file; returns the fields
        checked."""
        ratio = {arm: round(combined[arm] / max(combined["debt"], 1e-12),
                            4) for arm in ("never", "always")}
        bad = [] if ratio == ratio_want else [("ratio", ratio, ratio_want)]
        checked = len(ratio)
        if arms_want is not None:
            bad += [(arm, f, got[arm][f], arms_want[arm][f])
                    for arm in INGEST_ARMS for f in INGEST_FIELDS
                    if got[arm][f] != arms_want[arm][f]]
            checked += len(INGEST_ARMS) * len(INGEST_FIELDS)
        emit("ingest_parity", case=f"BENCH_ingest.json {section}",
             scenario=scenario, arms=got, cost_ratio_vs_debt_aware=ratio,
             equal_to_file=not bad, card_equals_cpu=host is not None,
             seconds=time.perf_counter() - t0)
        if bad:
            raise AssertionError(f"ingest_parity: {section} {scenario} "
                                 f"differs from BENCH_ingest.json: {bad}")
        return checked

    checked = migrations = 0
    for section, (cfg, want) in sections.items():
        if section == "full":
            for scenario, out in sorted(file_host().items()):
                got, combined = out["got"], out["combined"]
                for k, n in out["launches"].items():
                    launched[k] += n
                if got["never"]["compactions"]:
                    raise AssertionError(f"ingest_parity: {scenario}: the "
                                         f"never arm compacted")
                checked += file_section(section, scenario, got, combined,
                                        *want[scenario], host=None)
            continue
        data, lo, hi = ingest_tables(device, cfg["tenants"], cfg["rows"],
                                     cfg["columns"])
        host = {tid: d.cpu() for tid, d in data.items()}
        for scenario in sorted(core.INGEST_SCENARIOS):
            stream = core.make_ingest_scenario(
                scenario, lo, hi, num_tenants=cfg["tenants"],
                queries_per_tenant=cfg["queries_per_tenant"],
                seed=INGEST_SCENARIO_SEED)
            combined, got = {}, {}
            for arm in INGEST_ARMS:
                fleet = build(data, cfg, arm)
                res = counted(device, lambda: fleet.run(stream))
                got[arm] = ingest_fields(res, fleet)
                combined[arm] = res.total_cost
                if arm == "never" and got[arm]["compactions"]:
                    raise AssertionError(f"ingest_parity: {scenario}: the "
                                         f"never arm compacted")
                if arm == "debt":
                    want_debt = ingest_trace(fleet, res)
                cpu_fleet = build(host, cfg, arm)
                cpu_res = counted(cpu, lambda: cpu_fleet.run(stream))
                if (ingest_trace(cpu_fleet, cpu_res)
                        != ingest_trace(fleet, res)):
                    raise AssertionError(f"ingest_parity: {scenario} "
                                         f"{arm}: card and CPU traces "
                                         f"differ")
                del fleet
            checked += file_section(section, scenario, got, combined,
                                    *want[scenario], host=host)
            if scenario in ("trickle", "mixed_rw", "bulk_load"):
                migrations += same_as_run(data, cfg, scenario, stream,
                                          want_debt)
        del data
    # (d) DiskBackend(durable=True) at 20,000 x 8.
    ingest_durable_parity(device, counted)
    if not (migrations and all(launched[k] for k in (
            "pruning", "fleet_scan", "decision_fused", "move_score"))):
        raise AssertionError(f"ingest_parity: the card runs did not launch "
                             f"every fleet kernel, or planned no migration: "
                             f"{launched}")
    emit("ingest_parity", fields_equal_to_file=checked,
         incremental_migrations=migrations, launches_card=launched,
         seconds=time.perf_counter() - t0)
    return launched


class IngestMeter:
    """Times every tenant's ``ingest`` and splits the pruning kernel's
    launches of a run by caller: the serve path (``backend.serve``), the
    debt meter (``DebtMeter.observe``: one Q = 1 scan per served query)
    and the decision (``policy.decide``: estimates, the layout manager's
    cost vectors).  It wraps the engines' own objects and launches
    nothing."""

    def __init__(self, fleet):
        from repro_torch.kernels.pruning import pruning
        self.counter = pruning.scan_matrix
        self.pruning = {"serve": 0, "debt_meter": 0, "decide": 0}
        self.ingest_seconds = self.debt_seconds = 0.0
        for tid in fleet.tenant_ids:
            eng = fleet.tenant(tid)
            eng.ingest = self._timed(eng.ingest, None)
            eng.backend.serve = self._timed(eng.backend.serve, "serve")
            eng._debt.observe = self._timed(eng._debt.observe, "debt_meter")
            eng.policy.decide = self._timed(eng.policy.decide, "decide")

    def _timed(self, inner, caller):
        def call(*args):
            before = self.counter.launches
            t0 = time.perf_counter()
            out = inner(*args)
            if caller is None:
                self.ingest_seconds += time.perf_counter() - t0
            elif caller == "debt_meter":
                self.debt_seconds += time.perf_counter() - t0
            if caller is not None:
                self.pruning[caller] += self.counter.launches - before
            return out
        return call


def final_plane_kernels(device, fleet, queries) -> dict:
    """pruning, fleet_scan and decision_fused against their plain versions
    on the run's final planes: the FleetMatrix plane with 16 frames for
    every tenant row, one tenant's StateMatrix plane with a 256-query
    block (``run``'s block estimate) and one query (an estimate), and its
    serving shadow with one query (serve); bitwise, then timed."""
    import numpy as np
    import torch
    from repro_torch.kernels.decision_fused import decision_fused, ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan, ref as fref
    from repro_torch.kernels.pruning import pruning, ref as pref
    fm = fleet.fleet_matrix
    lo, hi = fleet_frames(fm, device)
    got = decision_fused.fused_decision(lo, hi, fm._mins, fm._maxs)[0]
    want = dref.fused_decision(lo, hi, fm._mins, fm._maxs)[0]
    fmin, fmax = fm._mins.flatten(1, 2), fm._maxs.flatten(1, 2)
    frames_equal = all(torch.equal(
        fleet_scan.scan_fleet(lo[k], hi[k], fmin, fmax),
        fref.scan_fleet(lo[k], hi[k], fmin, fmax)) for k in range(len(lo)))
    if not (torch.equal(got, want) and frames_equal):
        raise AssertionError(f"{INGEST_CELL}: a fleet kernel disagrees with "
                             f"its plain version at the final plane")
    out = {"fleet_plane": list(fm._mins.shape),
           **time_fleet_kernels(device, lo, hi, fm._mins, fm._maxs)}
    eng = fleet.tenant(fleet.tenant_ids[0])
    m = eng.backend.state_matrix
    n = len(m)
    smin, smax = m._mins[:n].flatten(0, 1), m._maxs[:n].flatten(0, 1)
    shadow = eng.backend._serving_cache
    q_lo = np.stack([q.lo for q in queries[:256]])
    q_hi = np.stack([q.hi for q in queries[:256]])
    bounds = torch.as_tensor(np.stack([q_lo, q_hi]), device=device)
    shapes = {"estimate block 256 x n*P_cap": (bounds[0], bounds[1], smin,
                                               smax),
              "estimate 1 x n*P_cap": (bounds[0, :1], bounds[1, :1], smin,
                                       smax),
              "serve 1 x P": (bounds[0, :1], bounds[1, :1], shadow[0],
                              shadow[1])}
    for name, (a, b, c, d) in shapes.items():
        if not torch.equal(pruning.scan_matrix(a, b, c, d),
                           pref.scan_matrix(a, b, c, d)):
            raise AssertionError(f"{INGEST_CELL}: pruning disagrees with its "
                                 f"plain version at {name}")
        q, (p, cols) = a.shape[0], c.shape
        out[f"pruning {name}"] = {
            "q": q, "p": p, "c": cols,
            "ms": cuda_time_ms(lambda: pruning.scan_matrix(a, b, c, d), 200),
            "plain_ms": cuda_time_ms(lambda: pref.scan_matrix(a, b, c, d),
                                     200), **scan_bound(q, p, cols)}
    return out


def phase_ingest_full(device, rows: int = SF1_ROWS,
                      tenants: int = INGEST_TENANTS,
                      queries: int = 500) -> dict:
    """fleet16-sf1-oreo-ingest-mixed_rw: benchmarks/bench_ingest.py's
    config (alpha 4, delta 10, P 16, window 80, gen_every 40) with the
    mixed_rw scenario (seed 7; an append after every 8th query, 50 of
    8,000 rows, so 37,508 rows at 6,001,215) over tenants of SF 1, cut
    from 16 to ``INGEST_TENANTS`` and its 1,000 queries per tenant to 500
    to keep the whole script near half its time limit; arms never,
    always, debt and debt/incremental under run_batched's decision_fused
    lane.  Returns each arm's launches."""
    import torch
    from repro_torch import core, engine
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 8)
    torch.cuda.synchronize()
    table_seconds = time.perf_counter() - t0
    lo = torch.stack([d.amin(0) for d in tables.values()]).amin(0)
    hi = torch.stack([d.amax(0) for d in tables.values()]).amax(0)
    t0 = time.perf_counter()
    stream = core.make_ingest_scenario(
        "mixed_rw", lo.cpu().numpy(), hi.cpu().numpy(), num_tenants=tenants,
        queries_per_tenant=queries, seed=INGEST_SCENARIO_SEED,
        batch_rows=INGEST_BATCH_ROWS)
    stream_seconds = time.perf_counter() - t0
    appended = stream.total_appended_rows
    emit("ingest_full", cell=INGEST_CELL, tenants=tenants,
         reduced={"tenants": f"16 -> {tenants}",
                  "queries_per_tenant": f"1000 -> {queries}"}, rows=rows,
         columns=8, queries_per_tenant=queries, scenario="mixed_rw",
         batch_rows=INGEST_BATCH_ROWS, events=len(stream),
         rows_appended=appended, appended_bytes=appended * 8 * 8,
         table_bytes=sum(d.numel() * 8 for d in tables.values()),
         table_seconds=table_seconds, stream_seconds=stream_seconds)
    arms = {"never": ("never", {}), "always": ("always", {}),
            "debt": ("debt", {}),
            "debt/incremental": ("debt", {"incremental": True,
                                          "reorg_compute": "move_score"})}
    launches, traces = {}, {}
    for label, (arm, kw) in arms.items():
        t0 = time.perf_counter()
        fleet = engine.FleetEngine(
            {tid: ingest_tenant(tables[tid], 4.0, 10, 16, arm, **kw)
             for tid in stream.tenant_ids}, engine.UnlimitedScheduler())
        setup = time.perf_counter() - t0
        meter = IngestMeter(fleet)
        res, fields = run_cell(f"{INGEST_CELL} {label}", fleet, stream.events,
                               "decision_fused", device)
        stats = ingest_fields(res, fleet)
        lengths = []
        for tid in fleet.tenant_ids:
            backend = fleet.tenant(tid).backend
            d = backend.delta_log
            lengths.append(len(backend.data))
            if d.clustered_len + d.delta_rows != len(backend.data):
                raise AssertionError(f"{INGEST_CELL} {label}: {tid}'s "
                                     f"clustered and pending rows do not "
                                     f"add up to its table")
        if sum(lengths) != tenants * rows + appended:
            raise AssertionError(f"{INGEST_CELL} {label}: rows were lost")
        if arm == "never" and stats["compactions"]:
            raise AssertionError(f"{INGEST_CELL}: the never arm compacted")
        if arm == "debt" and not stats["compactions"]:
            raise AssertionError(f"{INGEST_CELL}: the debt arm never "
                                 f"compacted")
        split = dict(meter.pruning)
        split["other"] = fields["launches"]["pruning"] - sum(split.values())
        extra = {}
        if label == "never":
            extra["kernels_at_final_plane"] = final_plane_kernels(
                device, fleet, stream.tenant_queries(stream.tenant_ids[0]))
        traces[label] = ingest_trace(fleet, res)
        launches[label] = fields["launches"]
        emit("ingest_full", cell=INGEST_CELL, arm=label, setup_seconds=setup,
             ingest_seconds=meter.ingest_seconds,
             debt_meter_seconds=meter.debt_seconds,
             pruning_by_caller=split, final_table_bytes=sum(lengths) * 8 * 8,
             final_table_rows=sum(lengths),
             p_cap=fleet.fleet_matrix.partition_capacity,
             bench_fields=stats, **fields, **extra)
        del fleet, res, meter
        release(device)
    if traces["debt/incremental"] != traces["debt"]:
        raise AssertionError(f"{INGEST_CELL}: debt/incremental differs from "
                             f"debt")
    emit("ingest_full", cell=INGEST_CELL,
         incremental_equals_atomic=True, card=card_line())
    return launches


# ---------------------------------------------------------------------------
# The serving substrate: flash attention, parity card against CPU, and the
# qwen3-1.7b-serve cell
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SERVE_ARCH = "qwen3-1.7b"
SERVE_SEED = 1234
SERVE_SLOTS = 4
SERVE_REQUESTS = 8
SERVE_PROMPT = 2048
SERVE_NEW_TOKENS = 64
SERVE_MAX_LEN = 2176
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # atol = rtol
FLASH_SHAPES = [  # (name, B, T, S, Hq, Hkv, dh, kwargs, head_pad)
    ("qwen3-1.7b prefill", 4, 2048, 2048, 16, 8, 128, {}, 0),
    ("ragged", 2, 1000, 1000, 16, 8, 128, {}, 0),
    ("smoke", 2, 16, 16, 4, 2, 16, {}, 0),
    ("non-causal kv_valid_len 300", 2, 256, 384, 16, 8, 128,
     {"causal": False, "kv_valid_len": 300}, 0),
    ("prefix_len 96", 2, 128, 128, 16, 8, 128, {"prefix_len": 96}, 0),
    ("q_offset 64", 2, 64, 128, 16, 8, 128, {"q_offset": 64}, 0),
    ("kv_valid_len 0", 2, 128, 128, 16, 8, 128, {"kv_valid_len": 0}, 0),
    ("dh 256 MQA", 1, 200, 200, 8, 1, 256, {}, 0),
    ("dh 192 head-strided views", 1, 130, 130, 6, 2, 192, {}, 2),
    ("prefix_len 200", 1, 512, 512, 16, 8, 128, {"prefix_len": 200}, 0),
    ("g 8", 1, 256, 256, 32, 4, 128, {}, 0),
]
#: The families' prefills: the VLM's, the audio family's and the hybrid's
#: shared block (dh 80).
FAMILY_FLASH_SHAPES = [
    ("paligemma-3b prefill", 4, 2048, 2048, 8, 1, 256, {"prefix_len": 256},
     0),
    ("musicgen-large prefill", 4, 1024, 1024, 32, 32, 64, {}, 0),
    ("zamba2-2.7b prefill", 4, 2048, 2048, 32, 32, 80, {}, 0),
]
#: The order operands are drawn in: each group in both dtypes, then the
#: next, so that a row added later leaves every earlier row's operands the
#: same draws.
FLASH_DRAWS = (FLASH_SHAPES, FAMILY_FLASH_SHAPES[:2], FAMILY_FLASH_SHAPES[2:])
#: The routes each dtype's cases are held and timed on; the first is the
#: one the wrapper chooses for the main path's operands.
FLASH_ROUTES = {"bfloat16": ("tensor_core", "scalar"), "float32": ("scalar",)}


def flash_bound(b, t, s, hq, hkv, dh, kw, dtype, device) -> dict:
    """Least time: 4 dh flops per visible (query, key) pair of this input
    (the mask counted exactly) at the type's peak, against q, k, v and out
    each moved once."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    kv_limit = s if kw.get("kv_valid_len") is None else kw["kv_valid_len"]
    q_pos = kw.get("q_offset", 0) + torch.arange(t, device=device)
    mask = ref.visible(q_pos, torch.arange(s, device=device),
                       kw.get("causal", True), kw.get("prefix_len", 0),
                       kv_limit)
    pairs = int(mask.sum())
    ops = 4 * dh * b * hq * pairs
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * dh * (2 * b * t * hq + 2 * b * s * hkv)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"pairs": pairs, "ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa(q, k, v, causal=True, prefix_len=0, kv_valid_len=None,
         q_offset=0):
    """PyTorch's own attention on the same (B, T, H, dh) tensors: the
    yardstick ``library_ms`` times (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref
    t, s = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    plain_causal = (causal and not prefix_len and not q_offset
                    and kv_valid_len is None and t == s)
    if not plain_causal:
        kv_limit = s if kv_valid_len is None else kv_valid_len
        mask = ref.visible(q_offset + torch.arange(t, device=q.device),
                           torch.arange(s, device=q.device), causal,
                           prefix_len, kv_limit)
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=plain_causal, enable_gqa=True)


def flash_operands(rng, b, t, s, hq, hkv, dh, dtype, device, head_pad):
    """q, k, v from a numpy seed; ``head_pad`` > 0 makes each a view of a
    tensor with more heads (token and batch strides past the dense ones)."""
    import numpy as np
    import torch

    def draw(n, h):
        a = torch.as_tensor(rng.standard_normal((b, n, h + head_pad, dh),
                                                dtype=np.float32))
        return a.to(device=device, dtype=dtype)[:, :, :h]
    return draw(t, hq), draw(s, hkv), draw(s, hkv)


def phase_flash_kernel(device) -> dict:
    """flash_attention against its plain version on the card over
    FLASH_SHAPES and FAMILY_FLASH_SHAPES, each route of FLASH_ROUTES (both
    in bfloat16, atol = rtol = 2e-2; the scalar one in float32, 1e-5), with
    CUDA-event times of each route, the plain version and PyTorch's
    scaled_dot_product_attention over 50 launches each (fewer, at least
    10, for a call past 5 ms: cuda_time_ms); returns the kernel's summary
    at qwen3-1.7b's prefill shape in bfloat16: the tensor-core route as
    ``ms``, the scalar
    route (the earlier design) on the same tensors as
    ``earlier_design_ms``."""
    import numpy as np
    import torch
    from repro_torch.kernels import _backend
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref
    rng = np.random.default_rng(3)
    lib = fa._lib()
    stream = _backend.stream_handle(device)
    results = []                # the chosen route's rows
    max_err = 0.0               # over every route
    for shapes, dtype in [(shapes, dtype) for shapes in FLASH_DRAWS
                          for dtype in (torch.bfloat16, torch.float32)]:
        dname = str(dtype).split(".")[1]
        tol = FLASH_TOL[dname]
        for name, b, t, s, hq, hkv, dh, kw, pad in shapes:
            q, k, v = flash_operands(rng, b, t, s, hq, hkv, dh, dtype,
                                     device, pad)
            want = ref.flash_attention(q, k, v, **kw)
            out = torch.empty_like(q, memory_format=torch.contiguous_format)
            strides = np.array([*fa._strides(q), *fa._strides(k),
                                *fa._strides(v), *fa._strides(out)],
                               dtype=np.int64)
            kv_valid = s if kw.get("kv_valid_len") is None else kw[
                "kv_valid_len"]
            scale = float(np.float32(dh ** -0.5))
            dcode = fa._DTYPES[dtype]
            ms, rows = {}, []
            for route in FLASH_ROUTES[dname]:
                got = fa.flash_attention(q, k, v, route=route, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                row = {"shape": name, "dtype": dname, "route": route,
                       "b": b, "t": t, "s": s, "hq": hq, "hkv": hkv,
                       "dh": dh, **kw, "q_strides": list(q.stride()),
                       "max_abs_err": (float(err.max()) if err.numel()
                                       else 0.0),
                       "tolerance": tol,
                       "finite": bool(torch.isfinite(got).all())}
                ok = bool((err <= tol + tol * want.float().abs()).all())
                if kw.get("kv_valid_len") == 0:
                    ok = ok and not bool(got.float().abs().max())
                if not (ok and row["finite"]):
                    emit("kernel", kernel="flash_attention", **row)
                    raise AssertionError(
                        f"flash_attention's {route} route disagrees with "
                        f"its plain version at {name} {dname}")
                max_err = max(max_err, row["max_abs_err"])

                def raw(code=fa.ROUTES[route]):
                    rc = lib.flash_attention(
                        code, dcode, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), strides.ctypes.data,
                        b, t, s, hq, hkv, dh, int(kw.get("causal", True)),
                        kw.get("prefix_len", 0), kv_valid,
                        kw.get("q_offset", 0), scale, stream)
                    if rc:
                        raise RuntimeError(f"flash_attention: CUDA error "
                                           f"{rc} at launch")
                ms[route] = row["ms"] = cuda_time_ms(raw, 50)
                rows.append(row)
            main = rows[0]
            main.update({
                "plain_ms": cuda_time_ms(
                    lambda: ref.flash_attention(q, k, v, **kw), 50),
                "library_ms": cuda_time_ms(lambda: sdpa(q, k, v, **kw), 50),
                **flash_bound(b, t, s, hq, hkv, dh, kw, dtype, device)})
            if main["route"] != "scalar":
                main["earlier_design_ms"] = ms["scalar"]
            results.append(main)
            for row in rows:
                emit("kernel", kernel="flash_attention", **row)
    main = results[0]
    return {"name": "flash_attention.flash_attention", "route": "cuda",
            "kernel_route": main["route"],
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:99",
            "max_abs_err": max_err,
            "ms": main["ms"], "earlier_design_ms": main["earlier_design_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"]}


def numpy_transformer(cfg, seed: int) -> dict:
    """A float32 parameter tree in the reference's layout (layer leaves
    stacked on axis 0) from a numpy seed: embed normal * 0.02, dense
    normal * d_in ** -0.5, norm scales normal * 0.1."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    n, d, dh, ff = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff

    def dense(d_in, d_out):
        return normal(n, d_in, d_out, scale=d_in ** -0.5)
    attn = {"wq": dense(d, cfg.n_heads * dh),
            "wk": dense(d, cfg.n_kv_heads * dh),
            "wv": dense(d, cfg.n_kv_heads * dh),
            "wo": dense(cfg.n_heads * dh, d)}
    if cfg.qk_norm:
        attn["q_norm"] = normal(n, dh, scale=0.1)
        attn["k_norm"] = normal(n, dh, scale=0.1)
    mlp = ({"w_gate": dense(d, ff), "w_up": dense(d, ff),
            "w_down": dense(ff, d)} if cfg.act in ("swiglu", "geglu")
           else {"w_in": dense(d, ff), "w_out": dense(ff, d)})
    return {"embed": normal(cfg.vocab, d, scale=0.02),
            "layers": {"attn": attn, "mlp": mlp,
                       "ln1": normal(n, d, scale=0.1),
                       "ln2": normal(n, d, scale=0.1)},
            "final_norm": normal(d, scale=0.1),
            "head": normal(d, cfg.vocab, scale=d ** -0.5)}


def serve_slot_loop(model, params, prompts, new_tokens: int, slots: int,
                    max_len: int, prefill_fn=None, decode_fn=None):
    """The examples/serve_model.py loop through the port's entry points;
    returns the batcher and the loop's counts."""
    from repro_torch import serve
    batcher = serve.SlotBatcher(slots)
    for rid, prompt in enumerate(prompts):
        batcher.submit(serve.Request(rid, prompt, max_new_tokens=new_tokens))
    fns = serve.build_serve_fns(model, max_len)
    counts = serve.serve_requests(batcher, prefill_fn or fns[0],
                                  decode_fn or fns[1], params,
                                  len(prompts[0]), max_len, model.device)
    return batcher, counts


def phase_serve_parity(device, layers: int = 2, batch: int = 2,
                       prompt_len: int = 256, steps: int = 8) -> int:
    """Card against CPU in float32 (TF32 off): qwen3-1.7b at full width cut
    to ``layers`` layers, weights from a numpy seed in both copies;
    greedy tokens equal and every step's logits within 1e-3 * max |logit|;
    then the slot loop at the smoke config, every request's tokens equal.
    Returns the card's flash launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import convert, serve
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    launches = 0
    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=layers)
    t0 = time.perf_counter()
    tree = numpy_transformer(cfg, SERVE_SEED)
    models = {kind: (build_model(cfg, dev), convert.transformer_params(
        tree, cfg, dev, torch.float32))
        for kind, dev in (("card", device), ("cpu", cpu))}
    del tree
    prompt = np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab, (batch, prompt_len))
    setup = time.perf_counter() - t0
    runs = {}
    for kind, (model, params) in models.items():
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        prefill_fn, decode_fn = serve.build_serve_fns(model,
                                                      prompt_len + steps)
        logits, cache = prefill_fn(params, {"tokens": prompt})
        steps_logits, toks = [logits.float().cpu()], []
        for _ in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok.cpu())
            logits, cache = decode_fn(params, {"tokens": tok}, cache)
            steps_logits.append(logits.float().cpu())
        generated = serve.greedy_generate(model, params, prompt, steps).cpu()
        runs[kind] = (torch.cat(toks, 1), steps_logits, generated,
                      time.perf_counter() - t0)
        if kind == "card":
            launches += fa.flash_attention.launches
    card, host = runs["card"], runs["cpu"]
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(card[1], host[1]))
    finite = all(bool(torch.isfinite(x).all()) for x in card[1])
    equal = (torch.equal(card[0], host[0]) and torch.equal(card[2], host[2])
             and torch.equal(card[0], card[2]))
    emit("serve_parity", model=f"{SERVE_ARCH} full width, {layers} layers",
         batch=batch, prompt_len=prompt_len, steps=steps, dtype="float32",
         setup_seconds=setup, card_seconds=card[3], cpu_seconds=host[3],
         tokens_equal=equal, max_rel_logit_err=rel, finite=finite,
         flash_launches_card=launches)
    if not (equal and finite and rel <= 1e-3):
        raise AssertionError(f"serve_parity: card and CPU differ (tokens "
                             f"equal {equal}, logits rel err {rel})")
    del models, runs

    # The examples/serve_model.py loop at the smoke config.
    cfg = get_arch(SERVE_ARCH, smoke=True)
    tree = numpy_transformer(cfg, SERVE_SEED + 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(10)]
    done = {}
    for kind, dev in (("card", device), ("cpu", cpu)):
        fa.flash_attention.launches = 0
        model = build_model(cfg, dev)
        params = convert.transformer_params(tree, cfg, dev, torch.float32)
        batcher, counts = serve_slot_loop(model, params, prompts, 12, 4, 64)
        done[kind] = ([(r.request_id, r.generated)
                       for r in batcher.completed], counts)
        if kind == "card":
            launches += fa.flash_attention.launches
    equal = done["card"][0] == done["cpu"][0]
    emit("serve_parity", model=f"{SERVE_ARCH} smoke, slot loop",
         requests=len(prompts), completed=len(done["card"][0]),
         counts=done["card"][1], tokens_equal=equal,
         flash_launches_card=launches)
    if not equal or len(done["card"][0]) != len(prompts):
        raise AssertionError("serve_parity: the slot loop's tokens differ "
                             "between card and CPU")
    if launches <= 0:
        raise AssertionError("serve_parity: the card runs launched no "
                             "flash_attention kernel")
    return launches


class FlashAudit:
    """Holds the first and every ``every``-th flash launch of a main path
    against the plain version on the same card tensors.  It calls the
    kernel's wrapper once per call and launches no kernel itself, so the
    wrapper's count stays the main path's."""

    def __init__(self, every: int):
        from repro_torch.models import layers
        self.layers, self.every = layers, every
        self.inner = layers.flash_attention
        self.calls = self.checked = 0
        self.max_abs_err = 0.0
        layers.flash_attention = self

    def close(self) -> None:
        self.layers.flash_attention = self.inner

    def __call__(self, q, k, v, **kw):
        from repro_torch.kernels.flash_attention import ref
        got = self.inner(q, k, v, **kw)
        self.calls += 1
        if (self.calls - 1) % self.every == 0:
            want = ref.flash_attention(q, k, v, **kw).float()
            err = (got.float() - want).abs()
            tol = FLASH_TOL[str(q.dtype).split(".")[1]]
            self.max_abs_err = max(self.max_abs_err, float(err.max()))
            if not bool((err <= tol + tol * want.abs()).all()):
                raise AssertionError(f"serve: flash launch {self.calls} "
                                     f"differs from the plain version by "
                                     f"{float(err.max())}")
            self.checked += 1
        return got


def spanned(label: str, fn):
    """``fn`` inside a ``torch.profiler.record_function(label)`` range."""
    import functools
    import torch

    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return run


def kernels_under(event) -> int:
    """Kernels launched under a profiler CPU event and its children."""
    return len(event.kernels) + sum(kernels_under(c)
                                    for c in event.cpu_children)


def profile_window(fn, focus: str = "", spans=None, steps: int = 0) -> dict:
    """Wall time of ``fn`` (ending in a synchronize) under torch.profiler,
    the device time of its kernels (one stream, so their sum is the busy
    time), the idle share and the kernels that take the most time; with
    ``focus``, the device time of the kernels whose name holds it and its
    share of the busy time.  ``spans`` ({label: (module, attribute)})
    wraps those functions in ranges for the window and adds each one's
    calls, device time, share of busy time and kernel launches, and every
    kernel launch of the window (per step, over ``steps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    spans = spans or {}
    inner = {label: getattr(*where) for label, where in spans.items()}
    for label, (module, attr) in spans.items():
        setattr(module, attr, spanned(label, inner[label]))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for label, (module, attr) in spans.items():
            setattr(module, attr, inner[label])
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if (us and str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.key not in spans):     # not the spans' own ranges
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy if rows else None,
           "idle_share": 1.0 - busy / wall if rows else None,
           "top_kernels": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                           for us, k, n in rows[:8]]}
    if focus:
        us = sum(r[0] for r in rows if focus in r[1])
        out.update({f"{focus}_ms": us / 1e3,
                    f"{focus}_share": us / 1e6 / busy if rows else None})
    if spans:
        out["kernel_launches"] = sum(r[2] for r in rows)
        if steps:
            out["launches_per_step"] = out["kernel_launches"] / steps
        for label in spans:
            events = [e for e in prof.events() if e.name == label
                      and str(e.device_type).endswith("CPU")]
            us = sum(e.device_time_total for e in events)
            out.update({f"{label}_calls": len(events),
                        f"{label}_ms": us / 1e3,
                        f"{label}_share": us / 1e6 / busy if rows else None,
                        f"{label}_launches": sum(kernels_under(e)
                                                 for e in events)})
    return out


def profile_serve(model, params, prompts, max_len: int, name: str,
                  phase: str = "serve_full", spans=None,
                  steps: int = 2) -> None:
    """One prefill of a full slot batch and ``steps`` decode steps at the
    end of the cache, each under torch.profiler (after the main path's
    counts are read); ``spans`` as profile_window's.  The profiler's own
    processing takes about a second per thousand launches, so the decode
    window is short."""
    import numpy as np
    import torch
    from repro_torch import serve
    prefill_fn, decode_fn = serve.build_serve_fns(model, max_len)
    tokens = torch.as_tensor(np.stack(prompts), device=model.device)
    out = {}

    def prefill():
        out["cache"] = prefill_fn(params, {"tokens": tokens})[1]
    pre = profile_window(prefill, focus="flash_attention", spans=spans)
    cache = out["cache"]
    cache["index"] = max_len - 1 - steps
    tok = tokens[:, :1]

    def decode():
        c = cache
        for _ in range(steps):
            c = decode_fn(params, {"tokens": tok}, c)[1]
    dec = profile_window(decode, spans=spans, steps=steps)
    emit(phase, cell=name, profile="prefill (one slot batch)", **pre)
    emit(phase, cell=name, profile=f"{steps} decode steps at the cache's "
         f"end", **dec)


def cache_sizes(spec: dict) -> tuple:
    """A cache_spec's bytes: (its KV caches, the rest but the index: the
    SSM's or the hybrid's recurrent state)."""
    import numpy as np

    def size(entry):
        if isinstance(entry, dict):
            return sum(size(e) for e in entry.values())
        shape, dtype = entry
        return int(np.prod(shape)) * dtype.itemsize
    return (sum(size(spec[n]) for n in ("k", "v") if n in spec),
            sum(size(e) for n, e in spec.items()
                if n not in ("k", "v", "index")))


def cell_serve(device, slots: int = SERVE_SLOTS,
               requests: int = SERVE_REQUESTS,
               prompt_len: int = SERVE_PROMPT,
               new_tokens: int = SERVE_NEW_TOKENS,
               max_len: int = SERVE_MAX_LEN, arch: str = SERVE_ARCH,
               phase: str = "serve_full") -> int:
    """qwen3-1.7b-serve: qwen3-1.7b at full width (hf:Qwen/Qwen3-1.7B,
    configs/qwen3_1p7b.py) in bf16 with weights drawn on the card from a
    seeded generator, serving ``requests`` seeded prompts through the
    examples/serve_model.py slot loop; returns the flash launches.  Another
    ``arch`` serves the same way (an MoE's line adds the entries its
    capacity dropped, per layer, at prefill and at decode; an SSM's or a
    hybrid's the bytes of its recurrent state, and its profiles the
    recurrences' spans)."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import build_model
    name = f"{arch}-serve"
    cfg = get_arch(arch)
    model = build_model(cfg, device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
    params = model.init_params(gen)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    rng = np.random.default_rng(SERVE_SEED)
    prompts = [rng.integers(0, cfg.vocab, prompt_len)
               for _ in range(requests)]
    cache_bytes, state_bytes = cache_sizes(model.cache_spec(slots, max_len))
    prefill_fn, decode_fn = serve.build_serve_fns(model, max_len)
    timing = {"prefill_s": 0.0, "decode_s": 0.0, "prompt_tokens": 0,
              "finite": True}

    def timed(fn, key):
        def run(params, batch, *rest):
            if recorder is not None:
                recorder.kind = key[:-2]
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(params, batch, *rest)
            timing["finite"] &= bool(torch.isfinite(logits).all())
            timing[key] += time.perf_counter() - t
            if key == "prefill_s":
                timing["prompt_tokens"] += batch["tokens"].numel()
            return logits, cache
        return run
    audit = FlashAudit(every=10)
    recorder = (RouteRecorder(cfg.n_layers, device) if cfg.moe is not None
                else None)
    fa.flash_attention.launches = 0
    by_route = fa.flash_attention.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    t0 = time.perf_counter()
    try:
        batcher, counts = serve_slot_loop(
            model, params, prompts, new_tokens, slots, max_len,
            timed(prefill_fn, "prefill_s"), timed(decode_fn, "decode_s"))
        torch.cuda.synchronize()
    finally:
        audit.close()
        drops = recorder.close() if recorder is not None else None
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    routes = dict(by_route)
    generated = sum(len(r.generated) for r in batcher.completed)
    in_range = all(0 <= t < cfg.vocab for r in batcher.completed
                   for t in r.generated)
    moe = {} if drops is None else {"moe_capacity_drops": drops}
    if state_bytes:
        moe["recurrent_state_bytes"] = state_bytes
    emit(phase, cell=name, source=cfg.source,
         params=cfg.num_params(), weight_bytes=weight_bytes,
         init_seconds=init_seconds, slots=slots, requests=requests,
         prompt_len=prompt_len, new_tokens=new_tokens, max_len=max_len,
         kv_cache_bytes=cache_bytes, **counts,
         prefill_seconds=timing["prefill_s"],
         prompt_tokens=timing["prompt_tokens"],
         prompt_tokens_per_s=timing["prompt_tokens"] / timing["prefill_s"],
         decode_seconds=timing["decode_s"],
         decode_tokens_per_s=generated / timing["decode_s"],
         seconds_per_output_token=timing["decode_s"]
         / counts["decode_steps"],
         wall_seconds=wall, requests_completed=len(batcher.completed),
         tokens_generated=generated, flash_launches=launches,
         flash_launches_by_route=routes,
         flash_launches_per_prefill=launches / counts["prefills"],
         flash_checked=audit.checked, flash_max_abs_err=audit.max_abs_err,
         logits_finite=timing["finite"], tokens_in_vocab=in_range,
         peak_bytes=torch.cuda.max_memory_allocated(device), **moe,
         card=card_line())
    profile_serve(model, params, prompts[:slots], max_len, name, phase,
                  spans=recurrences(cfg))
    if len(batcher.completed) != requests or generated != requests * \
            new_tokens:
        raise AssertionError(f"{name}: {len(batcher.completed)} requests "
                             f"and {generated} tokens completed")
    calls = attention_calls(cfg)
    if launches != calls * counts["prefills"] or (calls and launches <= 0):
        raise AssertionError(f"{name}: {launches} flash launches for "
                             f"{counts['prefills']} prefills")
    if routes["tensor_core"] != launches:
        raise AssertionError(f"{name}: {routes['tensor_core']} of "
                             f"{launches} flash launches took the "
                             f"tensor-core route")
    if not (timing["finite"] and in_range):
        raise AssertionError(f"{name}: non-finite logits or tokens out of "
                             f"the vocabulary")
    return launches


# ---------------------------------------------------------------------------
# Training: the flash backward kernel, training card against CPU, and the
# qwen3-1.7b-train cell
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SEED = 4321
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 10
TRAIN_DOCS = 20_000
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # x max |grad| a tensor
FLASH_BWD_ROUTES = {"bfloat16": ("tensor_core", "scalar"),
                    "float32": ("scalar",)}
FLASH_BWD_SHAPES = [  # (name, B, T, S, Hq, Hkv, dh, kwargs, head_pad)
    ("qwen3-1.7b train", 4, 2048, 2048, 16, 8, 128, {}, 0),
    ("ragged", 2, 1000, 1000, 16, 8, 128, {}, 0),
    ("prefix_len 96", 2, 128, 128, 16, 8, 128, {"prefix_len": 96}, 0),
    ("prefix_len 200", 1, 512, 512, 16, 8, 128, {"prefix_len": 200}, 0),
    ("q_offset 64", 2, 64, 128, 16, 8, 128, {"q_offset": 64}, 0),
    ("kv_valid_len 0", 2, 128, 128, 16, 8, 128, {"kv_valid_len": 0}, 0),
    ("dh 256 MQA", 1, 200, 200, 8, 1, 256, {}, 0),
    ("dh 192 head-strided views", 1, 130, 130, 6, 2, 192, {}, 2),
    ("g 8", 1, 256, 256, 32, 4, 128, {}, 0),
]
#: The VLM's and the hybrid's training shapes.
FAMILY_FLASH_BWD_SHAPES = [
    ("paligemma-3b train", 2, 512, 512, 8, 1, 256, {"prefix_len": 256}, 0),
    ("zamba2-2.7b train", 4, 2048, 2048, 32, 32, 80, {}, 0),
]
#: Draw order, as FLASH_DRAWS'.
FLASH_BWD_DRAWS = (FLASH_BWD_SHAPES, FAMILY_FLASH_BWD_SHAPES[:1],
                   FAMILY_FLASH_BWD_SHAPES[1:])


def flash_bwd_bound(b, t, s, hq, hkv, dh, kw, dtype, device) -> dict:
    """Least time for the backward: 10 dh flops per visible (query, key)
    pair of this input (QK^T, dO V^T, dV, dQ, dK; the mask counted exactly)
    at the type's peak, against q, k, v, out and dout read once and dq, dk,
    dv written once."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    kv_limit = s if kw.get("kv_valid_len") is None else kw["kv_valid_len"]
    q_pos = kw.get("q_offset", 0) + torch.arange(t, device=device)
    mask = ref.visible(q_pos, torch.arange(s, device=device),
                       kw.get("causal", True), kw.get("prefix_len", 0),
                       kv_limit)
    pairs = int(mask.sum())
    ops = 10 * dh * b * hq * pairs
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * dh * (4 * b * t * hq + 4 * b * s * hkv)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"pairs": pairs, "ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa_backward_ms(q, k, v, dout, kw, reps: int):
    """CUDA-event ms of torch.autograd.grad of PyTorch's
    scaled_dot_product_attention output alone, after its forward, on the
    same tensors: the backward's ``library_ms`` (the port never calls it).
    None, with the error, where SDPA's backward refuses the operands."""
    import torch
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    try:
        out = sdpa(*leaves, **kw)
        d_out = dout.transpose(1, 2)

        def grad():
            torch.autograd.grad(out, leaves, d_out, retain_graph=True)
        return cuda_time_ms(grad, reps), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def phase_flash_bwd_kernel(device) -> dict:
    """flash_attention_bwd against its plain backward on the card over
    FLASH_BWD_SHAPES and FAMILY_FLASH_BWD_SHAPES, each route of
    FLASH_BWD_ROUTES (both in bfloat16, the scalar one in float32), each
    tensor within FLASH_BWD_TOL x its max |grad| and bitwise equal across two launches; CUDA-event times of each
    route, the plain backward and SDPA's backward; returns the kernel's
    summary at qwen3-1.7b's training shape in bfloat16: the tensor-core
    route as ``ms``, the scalar route (the earlier design) on the same
    tensors as ``earlier_design_ms``."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref
    rng = np.random.default_rng(5)
    results, max_err = [], 0.0
    for shapes, dtype in [(shapes, dtype) for shapes in FLASH_BWD_DRAWS
                          for dtype in (torch.bfloat16, torch.float32)]:
        dname = str(dtype).split(".")[1]
        tol = FLASH_BWD_TOL[dname]
        for name, b, t, s, hq, hkv, dh, kw, pad in shapes:
            q, k, v = flash_operands(rng, b, t, s, hq, hkv, dh, dtype,
                                     device, pad)
            dout = flash_operands(rng, b, t, t, hq, hkv, dh, dtype, device,
                                  pad)[0]
            out = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_bwd(q, k, v, out, dout, **kw)
            big = t * s >= 1_000_000
            ms, rows = {}, []
            for route in FLASH_BWD_ROUTES[dname]:
                got = fa.flash_attention_bwd(q, k, v, out, dout, route=route,
                                             **kw)
                again = fa.flash_attention_bwd(q, k, v, out, dout,
                                               route=route, **kw)
                torch.cuda.synchronize()
                row = {"shape": name, "dtype": dname, "route": route,
                       "b": b, "t": t, "s": s, "hq": hq, "hkv": hkv,
                       "dh": dh, **kw, "tolerance": tol,
                       "bitwise_repeat": all(torch.equal(x, y)
                                             for x, y in zip(got, again)),
                       "finite": all(bool(torch.isfinite(x).all())
                                     for x in got)}
                ok = row["bitwise_repeat"] and row["finite"]
                for gname, x, w in zip(("dq", "dk", "dv"), got, want):
                    err = float((x.float() - w.float()).abs().max())
                    scale = float(w.float().abs().max())
                    row[f"{gname}_max_abs_err"] = err
                    row[f"{gname}_max"] = scale
                    ok = ok and (err <= tol * scale or err == 0.0)
                    max_err = max(max_err, err)
                if kw.get("kv_valid_len") == 0:
                    ok = ok and not any(bool(x.float().abs().max())
                                        for x in got)
                if not ok:
                    emit("kernel", kernel="flash_attention_bwd", **row)
                    raise AssertionError(
                        f"flash_attention_bwd's {route} route disagrees "
                        f"with its plain backward (or with itself) at "
                        f"{name} {dname}")
                ms[route] = row["ms"] = cuda_time_ms(
                    lambda: fa.flash_attention_bwd(q, k, v, out, dout,
                                                   route=route, **kw),
                    10 if big else 50)
                rows.append(row)
            main = rows[0]
            main["plain_ms"] = cuda_time_ms(
                lambda: ref.flash_attention_bwd(q, k, v, out, dout, **kw),
                3 if big else 10)
            main["library_ms"], lib_err = sdpa_backward_ms(
                q, k, v, dout, kw, 10 if big else 50)
            if lib_err:
                main["library_error"] = lib_err
            main.update(flash_bwd_bound(b, t, s, hq, hkv, dh, kw, dtype,
                                        device))
            if main["route"] != "scalar":
                main["earlier_design_ms"] = ms["scalar"]
            results.append(main)
            for row in rows:
                emit("kernel", kernel="flash_attention_bwd", **row)
    main = results[0]
    return {"name": "flash_attention.flash_attention_bwd", "route": "cuda",
            "kernel_route": main["route"],
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:122",
            "max_abs_err": max_err, "ms": main["ms"],
            "earlier_design_ms": main["earlier_design_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"]}


def flash_counts() -> tuple:
    """Forward and backward launches, and each one's launches by route."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    return (fa.flash_attention.launches, fa.flash_attention_bwd.launches,
            dict(fa.flash_attention.launches_by_route),
            dict(fa.flash_attention_bwd.launches_by_route))


def reset_flash_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    for fn in (fa.flash_attention, fa.flash_attention_bwd):
        fn.launches_by_route.update(dict.fromkeys(fn.launches_by_route, 0))


def token_batches(vocab: int, n: int, shape, seed: int) -> list:
    """``n`` next-token batches of host int32 tokens (last target -1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, shape, dtype=np.int32)
        targets = np.roll(toks, -1, 1)
        targets[:, -1] = -1
        out.append({"tokens": toks, "targets": targets})
    return out


TRAIN_PARITY = {"layers": 2, "batch": 2, "seq": 128, "steps": 3}   # (a)


def train_parity_run(device, layers: int, batch: int, seq: int,
                     steps: int) -> tuple:
    """One side of (a) on ``device``: the loss, every gradient (float32,
    on the host), ``steps`` train steps' losses, the seconds and the flash
    counts."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, transformer
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_opt_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=layers)
    tree = numpy_transformer(cfg, TRAIN_SEED)
    batches = token_batches(cfg.vocab, steps, (batch, seq), TRAIN_SEED)
    opt_cfg = OptimizerConfig()
    model = build_model(cfg, device)
    params = transformer.trainable(
        convert.transformer_params(tree, cfg, device, torch.float32))
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    reset_flash_counts()
    t0 = time.perf_counter()
    names, leaves = zip(*params.named_parameters())
    loss = model.loss_fn(params, batches[0])
    grads = {n: g.float().cpu() for n, g in
             zip(names, torch.autograd.grad(loss, leaves))}
    step = build_train_step(model, opt_cfg)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return (float(loss.detach()), grads, losses, time.perf_counter() - t0,
            flash_counts())


def train_parity_cpu(path: str) -> tuple:
    """(a)'s CPU side in a spawned process on two threads; the gradients
    go to the torch.save file ``path`` (a pipe moves megabytes a second)."""
    import torch
    torch.set_num_threads(2)
    out = train_parity_run(torch.device("cpu"), **TRAIN_PARITY)
    torch.save(out[1], path)
    return (out[0], None, *out[2:])


def start_train_parity_cpu():
    """Starts (a)'s CPU side now in a spawned process, so it overlaps the
    card's earlier phases (it uses two of the host's cores and nothing on
    the card); returns a function that waits for it and gives
    train_parity_run's tuple.  The process exits once the job is done."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import tempfile
    import torch
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    pool = cf.ProcessPoolExecutor(max_workers=1,
                                  mp_context=mp.get_context("spawn"))
    future = pool.submit(train_parity_cpu, path)
    pool.shutdown(wait=False)

    def result() -> tuple:
        out = future.result()
        grads = torch.load(path)
        os.remove(path)
        return (out[0], grads, *out[2:])
    return result


def train_parity_steps(device, layers: int, batch: int, seq: int,
                       steps: int, host=None) -> None:
    """(a): float32 (TF32 off), qwen3-1.7b at full width cut to ``layers``
    layers, weights from a numpy seed in both copies; loss and every
    gradient card == CPU, then ``steps`` train steps' losses.  ``host``
    gives the CPU side's tuple (start_train_parity_cpu's function); by
    default the CPU side runs here after the card's."""
    import torch
    runs = {"card": train_parity_run(device, layers, batch, seq, steps)}
    release(device)
    runs["cpu"] = host() if host is not None else train_parity_run(
        torch.device("cpu"), layers, batch, seq, steps)
    card, host = runs["card"], runs["cpu"]
    worst = 0.0
    for n, g in host[1].items():
        err = float((card[1][n] - g).abs().max())
        scale = float(g.abs().max())
        if not (err <= 1e-4 * scale or err == 0.0):
            raise AssertionError(f"train_parity: gradient {n} differs card "
                                 f"vs CPU by {err} (max |g| {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(card[2], host[2]))
    fwd, bwd, routes, bwd_routes = card[4]
    emit("train_parity", part="a", model=f"{TRAIN_ARCH} full width, "
         f"{layers} layers", dtype="float32", tokens=[batch, seq],
         steps=steps, loss_card=card[0], loss_cpu=host[0],
         loss_rel_err=loss_rel, worst_grad_err_over_max=worst,
         step_losses_card=card[2], step_losses_cpu=host[2],
         step_loss_rel_err=step_rel, card_seconds=card[3],
         cpu_seconds=host[3], flash_launches_card=fwd,
         flash_launches_by_route=routes, flash_bwd_launches_card=bwd,
         flash_bwd_launches_by_route=bwd_routes)
    if loss_rel > 1e-5 or step_rel > 1e-4:
        raise AssertionError(f"train_parity: losses differ card vs CPU "
                             f"(loss {loss_rel}, steps {step_rel})")
    if (fwd, bwd) != (2 * layers * (steps + 1), layers * (steps + 1)) or \
            routes["scalar"] != fwd or bwd_routes["scalar"] != bwd:
        raise AssertionError(f"train_parity: {fwd} forward ({routes}) and "
                             f"{bwd} backward ({bwd_routes}) flash launches "
                             f"on the card")


def train_resume(device, steps: int = 20, fault_at: int = 13) -> None:
    """(b): at the smoke config in bf16 on the card, a FaultTolerantTrainer
    run with a fault injected at ``fault_at`` ends bitwise equal to the
    clean run."""
    import copy
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import (FaultTolerantTrainer, OptimizerConfig,
                                   build_train_step, checkpoint,
                                   init_train_state)
    cfg = get_arch(TRAIN_ARCH, smoke=True)
    model = build_model(cfg, device)
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=100)
    step = build_train_step(model, opt_cfg)
    state0 = init_train_state(model, torch.Generator(device).manual_seed(0),
                              opt_cfg)
    batches = token_batches(cfg.vocab, steps, (4, 32), TRAIN_SEED + 1)

    def batch_fn(i):
        return {k: torch.as_tensor(v, device=device)
                for k, v in batches[i].items()}
    armed = {"on": True}

    def fault_hook(s):
        if s == fault_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")
    reset_flash_counts()
    with tempfile.TemporaryDirectory() as td:
        clean = FaultTolerantTrainer(step, copy.deepcopy(state0), batch_fn,
                                     ckpt_dir=td + "/a", ckpt_every=5)
        final_clean = clean.run(steps)
        faulty = FaultTolerantTrainer(step, copy.deepcopy(state0), batch_fn,
                                      ckpt_dir=td + "/b", ckpt_every=5,
                                      fault_hook=fault_hook)
        final_faulty = faulty.run(steps)
    fwd, bwd, routes, bwd_routes = flash_counts()
    pairs = list(zip(checkpoint._leaves(final_clean),
                     checkpoint._leaves(final_faulty)))
    equal = all(a[0] == b[0] and torch.equal(a[1], b[1]) for a, b in pairs)
    on_card = all(a[1].device == b[1].device == torch.device(device)
                  for a, b in pairs)
    emit("train_parity", part="b", model=f"{TRAIN_ARCH} smoke",
         dtype="bfloat16", steps=steps, fault_at=fault_at,
         restarts_clean=clean.restarts, restarts_faulty=faulty.restarts,
         leaves=len(pairs), bitwise_equal=equal, on_card=on_card,
         final_loss=clean.metrics_log[-1]["loss"],
         flash_launches_card=fwd, flash_launches_by_route=routes,
         flash_bwd_launches_card=bwd, flash_bwd_launches_by_route=bwd_routes)
    if (clean.restarts, faulty.restarts) != (0, 1):
        raise AssertionError(f"train_parity: restarts {clean.restarts} and "
                             f"{faulty.restarts}, one fault injected")
    if not (equal and on_card):
        raise AssertionError("train_parity: the resumed run differs from "
                             "the clean one")
    # Each run trains `steps` steps, the faulty one replays 13 - 10 more.
    n = 2 * steps + fault_at - fault_at // 5 * 5
    if (fwd, bwd) != (2 * cfg.n_layers * n, cfg.n_layers * n) or \
            bwd_routes["tensor_core"] != bwd:
        raise AssertionError(f"train_parity: {fwd} forward and {bwd} "
                             f"backward ({bwd_routes}) flash launches for "
                             f"{n} steps")


def train_pipeline_parity(device, steps: int = 1500) -> None:
    """(c): tests/test_substrate.py's OreoDataPipeline config on the card
    and on the CPU: batches and stats bitwise equal."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.data import (OreoDataPipeline, mixture_recipe,
                                  synth_corpus)
    from repro_torch.kernels.pruning import pruning
    meta, tokens = synth_corpus(n_docs=20_000, doc_len=32, vocab=100, seed=0)
    runs = {}
    for kind, dev in (("card", device), ("cpu", torch.device("cpu"))):
        pruning.scan_matrix.launches = 0
        t0 = time.perf_counter()
        pipe = OreoDataPipeline(
            meta, tokens, mixture_recipe(meta, total_steps=steps, seed=1,
                                         segment_length=(300, 500)),
            batch_size=4, seq_len=32, alpha=40.0, device=dev)
        batches = list(pipe)
        runs[kind] = (batches, dataclasses.asdict(pipe.stats),
                      time.perf_counter() - t0,
                      pruning.scan_matrix.launches)
    card, host = runs["card"], runs["cpu"]
    equal = len(card[0]) == len(host[0]) == steps and all(
        np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
        for a, b in zip(card[0], host[0]) for k in ("tokens", "targets"))
    emit("train_parity", part="c", batches=len(card[0]),
         batches_equal=equal, stats_card=card[1], stats_cpu=host[1],
         card_seconds=card[2], cpu_seconds=host[2],
         pruning_launches_card=card[3])
    if not equal or card[1] != host[1]:
        raise AssertionError("train_parity: the pipeline's batches or stats "
                             "differ between card and CPU")
    if card[3] <= 0:
        raise AssertionError("train_parity: the card's pipeline launched no "
                             "pruning kernel")


def phase_train_parity(device, host=None) -> None:
    """(a) float32 training card against CPU (``host``: see
    train_parity_steps), (b) a fault-injected FaultTolerantTrainer run
    bitwise equal to a clean one on the card, (c) the OREO data pipeline
    card against CPU."""
    train_parity_steps(device, **TRAIN_PARITY, host=host)
    release(device)
    train_resume(device)
    train_pipeline_parity(device)


def cell_train(device, steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, docs: int = TRAIN_DOCS,
               arch: str = TRAIN_ARCH, launch: bool = False) -> dict:
    """qwen3-1.7b-train: qwen3-1.7b at full width and depth in bf16
    (hf:Qwen/Qwen3-1.7B, configs/qwen3_1p7b.py), weights drawn on the card
    from a seeded generator, per-layer remat, the default OptimizerConfig;
    ``steps`` steps of build_train_step on batches of ``batch`` x ``seq``
    tokens from OreoDataPipeline over synth_corpus(docs, seq, vocab) at
    alpha 80.  The first step is run twice from one state and must give the
    same bits.  With ``launch``, the launch phase's (b) and (c) follow the
    timed steps (:func:`launch_counts`).  Returns the main path's
    launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import (OreoDataPipeline, mixture_recipe,
                                  synth_corpus)
    from repro_torch.kernels.pruning import pruning
    from repro_torch.models import build_model
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_train_state)
    name = f"{arch}-train"
    cfg = get_arch(arch)
    model = build_model(cfg, device)
    opt_cfg = OptimizerConfig()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device).manual_seed(
        TRAIN_SEED), opt_cfg)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    params = state["params"]
    n_params = sum(p.numel() for p in params.parameters())
    t0 = time.perf_counter()
    meta, tokens = synth_corpus(docs, doc_len=seq, vocab=cfg.vocab)
    pipe = OreoDataPipeline(meta, tokens,
                            mixture_recipe(meta, total_steps=steps + 1),
                            batch_size=batch, seq_len=seq, alpha=ALPHA,
                            device=device)
    corpus_seconds = time.perf_counter() - t0
    step_fn = build_train_step(model, opt_cfg)
    batches = {}

    def batch_at(i):
        if i not in batches:
            batches[i] = {k: torch.as_tensor(v, device=device)
                          for k, v in next(pipe).items()}
        return batches[i]

    # The first step twice from one state: the same bits.
    snapshot = [p.detach().clone() for p in params.parameters()]
    _, first = step_fn(state, batch_at(0))
    first = {k: v.clone() for k, v in first.items()}
    after_first = [p.detach().clone() for p in params.parameters()]
    with torch.no_grad():
        for p, s in zip(params.parameters(), snapshot):
            p.copy_(s)
        for part in ("m", "v"):
            for t in state["opt"][part].values():
                t.zero_()
        state["opt"]["step"].zero_()
    del snapshot

    reset_flash_counts()
    pruning.scan_matrix.launches = 0
    times, losses, norms = [], [], []
    repeat_equal = None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            repeat_equal = (
                torch.equal(metrics["loss"], first["loss"])
                and torch.equal(metrics["grad_norm"], first["grad_norm"])
                and all(torch.equal(p, a) for p, a in
                        zip(params.parameters(), after_first)))
            del after_first
    fwd, bwd, routes, bwd_routes = flash_counts()
    prunes = pruning.scan_matrix.launches
    peak = torch.cuda.max_memory_allocated(device)
    seconds = sum(times)
    emit("train_full", cell=name, source=cfg.source, params=n_params,
         dtype="bfloat16", batch=batch, seq=seq, steps=steps,
         init_seconds=init_seconds, corpus_seconds=corpus_seconds,
         step_seconds=times, s_per_step=seconds / steps,
         s_per_step_after_first=sum(times[1:]) / max(steps - 1, 1),
         tokens_per_s=batch * seq * steps / seconds,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         grad_norms=norms, first_step_repeat_bitwise=repeat_equal,
         peak_bytes=peak, pipeline_mean_scan_fraction=(
             pipe.stats.mean_scan_fraction),
         pipeline_reorgs=pipe.stats.reorgs,
         pipeline_queries=pipe.stats.queries,
         flash_launches=fwd, flash_launches_by_route=routes,
         flash_launches_per_step=fwd / steps, flash_bwd_launches=bwd,
         flash_bwd_launches_by_route=bwd_routes,
         flash_bwd_launches_per_step=bwd / steps, pruning_launches=prunes,
         card=card_line())
    if launch:
        launch_counts(device, cfg, model, opt_cfg, state, step_fn,
                      batch_at(steps), sum(times[1:]) / max(steps - 1, 1))
    prof = profile_window(lambda: step_fn(state, batch_at(steps)),
                          focus="flash_attention_bwd")
    emit("train_full", cell=name, profile="one train step", **prof)
    if not repeat_equal:
        raise AssertionError(f"{name}: the first step run twice from one "
                             f"state gave different bits")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"{name}: non-finite loss or gradient norm")
    if (fwd, bwd) != (2 * cfg.n_layers * steps, cfg.n_layers * steps) or \
            bwd_routes["tensor_core"] != bwd:
        raise AssertionError(f"{name}: {fwd} forward and {bwd} backward "
                             f"({bwd_routes}) flash launches in {steps} "
                             f"steps")
    if prunes <= 0:
        raise AssertionError(f"{name}: the pipeline launched no pruning "
                             f"kernel")
    return {"flash_attention": fwd, "flash_attention_bwd": bwd,
            "pruning": prunes}


# ---------------------------------------------------------------------------
# The launch layer: host dry runs, op counts on the card and on fake
# tensors, the roofline line
# ---------------------------------------------------------------------------

LAUNCH_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                ("qwen3-1.7b", "decode_32k"))
LAUNCH_KEYS = ("flops_per_device", "bytes_per_device",
               "collective_bytes_per_device")


def launch_dryrun_cells() -> list:
    """(a)'s host side: each LAUNCH_CELLS record on the fake 16 x 16 mesh
    (fake CUDA tensors, which hold no memory), without its per-op calls,
    and its roofline row."""
    import torch
    from repro_torch.launch import dryrun, roofline
    torch.set_num_threads(1)
    out = []
    for arch, shape in LAUNCH_CELLS:
        rec = dryrun.run_cell(arch, shape, False)
        rec.pop("op_calls")
        out.append((rec, roofline.analyze_record(rec)))
    return out


def start_launch_dryrun():
    """Starts (a) now in a spawned process; returns a function that waits
    for it and gives launch_dryrun_cells's list."""
    import concurrent.futures as cf
    import multiprocessing as mp
    pool = cf.ProcessPoolExecutor(max_workers=1,
                                  mp_context=mp.get_context("spawn"))
    future = pool.submit(launch_dryrun_cells)
    pool.shutdown(wait=False)
    return future.result


def phase_launch(host) -> None:
    """(a): prints the host's dry-run records and roofline rows."""
    card = card_line()
    for rec, row in host():
        mem = rec["memory_analysis"]
        emit("launch", part="a: dry run", cell=f"{rec['arch']}__"
             f"{rec['shape']}__{rec['mesh']}", mesh=rec["mesh"],
             device=rec["device"], trace_seconds=rec["trace_seconds"],
             **{k: rec["op_cost"][k] for k in LAUNCH_KEYS},
             collective_bytes_by_type=rec["op_cost"][
                 "collective_bytes_by_type"],
             peak_bytes_per_device=mem["peak_bytes"],
             param_bytes_per_device=mem["param_bytes"], fits=mem["fits"],
             roofline={k: row[k] for k in (
                 "compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "useful_ratio", "roofline_fraction")},
             card=card)


def launch_counts(device, cfg, model, opt_cfg, state, step_fn, batch,
                  s_per_step) -> None:
    """(b) and (c): one train step counted by OpCost on the card's state
    and batch, the same step on fake tensors of the same shapes, and the
    roofline line from the measured seconds per step."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import roofline
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train import init_train_state
    t0 = time.perf_counter()
    reset_flash_counts()
    with OpCost() as real:
        step_fn(state, batch)
    torch.cuda.synchronize()
    launched = flash_counts()[:2]
    with FakeTensorMode():
        fake_state = init_train_state(
            model, torch.Generator(device).manual_seed(TRAIN_SEED), opt_cfg)
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        with OpCost() as fake:
            step_fn(fake_state, fake_batch)
    real, fake = real.record(), fake.record()
    calls = tuple(fake["calls"].get(f"repro_torch.{op}", 0)
                  for op in ("flash_attention", "flash_attention_bwd"))
    tokens = batch["tokens"].numel()
    n = cfg.num_active_params()
    flops, nbytes = real["flops_per_device"], real["bytes_per_device"]
    roof_s = max(flops / roofline.PEAK_FLOPS, nbytes / roofline.HBM_BW)
    emit("launch", part="b: op counts", cell=f"{cfg.name}-train",
         real={k: real[k] for k in LAUNCH_KEYS + ("num_ops",)},
         fake={k: fake[k] for k in LAUNCH_KEYS + ("num_ops",)},
         equal=(real == fake), flash_launches=launched,
         fake_flash_calls=calls, seconds=time.perf_counter() - t0)
    emit("launch", part="c: roofline", cell=f"{cfg.name}-train",
         s_per_step=s_per_step, counted_flops=flops, counted_bytes=nbytes,
         flops_per_s=flops / s_per_step,
         model_flops=6.0 * n * tokens,
         mfu=6.0 * n * tokens / (s_per_step * roofline.PEAK_FLOPS),
         roofline_s=roof_s, roofline_fraction=roof_s / s_per_step,
         peak_flops=roofline.PEAK_FLOPS, hbm_bw=roofline.HBM_BW,
         card=card_line(), torch=torch.__version__)
    if real["flops_per_device"] != fake["flops_per_device"] or \
            real["bytes_per_device"] != fake["bytes_per_device"]:
        raise AssertionError(f"launch: the card's count {real} differs from "
                             f"the fake tensors' {fake}")
    want = (2 * cfg.n_layers, cfg.n_layers)
    if launched != want or calls != want:
        raise AssertionError(f"launch: {launched} flash launches and {calls} "
                             f"counted fake calls, not {want}")


# ---------------------------------------------------------------------------
# The VLM, audio, MoE, SSM and hybrid families: card against CPU, then
# full-width cells
# ---------------------------------------------------------------------------

FAMILY_SEED = 2468
#: family_parity's models at full width, cut in depth: (layers, batch,
#: positions); paligemma's 288 are 256 patch embeddings and 32 tokens;
#: rwkv6's 160 two WKV chunks of 64 and a tail, zamba2's 288 an SSD chunk
#: of 256 and a tail, its 12 layers two groups (two shared-block caches).
FAMILY_PARITY = {"paligemma-3b": (2, 2, 288), "musicgen-large": (2, 2, 64),
                 "moonshot-v1-16b-a3b": (2, 2, 64), "rwkv6-3b": (2, 2, 160),
                 "zamba2-2.7b": (12, 2, 288)}
FAMILY_STEPS = 8
#: family_parity's float32 gradients: (layers, batch, positions);
#: paligemma's 512 are 256 patch embeddings and 256 tokens; zamba2's 6
#: layers one group, its 320 positions an SSD chunk and a tail.
FAMILY_TRAIN = {"paligemma-3b": (2, 2, 512), "zamba2-2.7b": (6, 1, 320)}
FAMILY_SMOKE = ("paligemma-3b", "musicgen-large", "moonshot-v1-16b-a3b",
                "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "zamba2-2.7b")
MOE_ARCH = "moonshot-v1-16b-a3b"
#: serve_full's slot loop for family_full's token cells: the MoE, SSM and
#: hybrid models; users serve long prompts, and the SSM's and hybrid's
#: decode state does not grow with context (the hybrid's KV caches do).
SLOT_ARCHS = (MOE_ARCH, "rwkv6-3b", "zamba2-2.7b")
SLOTS, SLOT_REQUESTS, SLOT_PROMPT, SLOT_NEW_TOKENS = 4, 8, 2048, 16
#: family_full's embedding-input cells: (requests, positions, new tokens).
EMBED_CELLS = {"paligemma-3b": (4, 2048, 16),
               "musicgen-large": (4, 1024, 32)}


def attention_calls(cfg) -> int:
    """Attention layers one forward runs: none in RWKV-6, the hybrid's
    shared block once a group, else one a layer."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def recurrences(cfg) -> dict:
    """The recurrence functions of an SSM or hybrid model, by span label:
    (module, attribute) for the chunked form (train, prefill) and the
    per-step form (decode)."""
    from repro_torch.models import mamba2, rwkv6
    if cfg.family == "ssm":
        return {"wkv_chunked": (rwkv6, "_wkv_chunked"),
                "wkv_scan": (rwkv6, "_wkv_scan")}
    if cfg.family == "hybrid":
        return {"ssd_chunked": (mamba2, "_ssd_chunked"),
                "ssd_scan": (mamba2, "_ssd_scan")}
    return {}


class RouteRecorder:
    """Wraps ``layers.moe_route``: counts each MoE layer's dropped (token,
    expert) entries on the card, split by ``kind`` (the caller sets
    "prefill" or "decode"), and with ``keep_routes`` keeps each call's
    expert choices and kept masks on the host.  It launches no kernel of
    the port's; the counts are a sum on the card, read at the end."""

    def __init__(self, n_layers: int, device, keep_routes: bool = False):
        import torch
        from repro_torch.models import layers
        self.layers, self.inner, self.n = layers, layers.moe_route, n_layers
        self.keep_routes, self.routes, self.calls = keep_routes, [], 0
        self.kind = "prefill"
        self.dropped = {k: torch.zeros(n_layers, dtype=torch.int64,
                                       device=device)
                        for k in ("prefill", "decode")}
        self.entries = {"prefill": 0, "decode": 0}
        layers.moe_route = self

    def close(self) -> dict:
        """Restores ``moe_route``; returns the drops per layer and the
        entries routed, by kind."""
        self.layers.moe_route = self.inner
        return {k: {"dropped_per_layer": v.tolist(),
                    "entries_routed": self.entries[k]}
                for k, v in self.dropped.items()}

    def __call__(self, logits, k, capacity):
        r = self.inner(logits, k, capacity)
        layer = self.calls % self.n
        self.calls += 1
        self.dropped[self.kind][layer] += (~r["keep"]).sum()
        self.entries[self.kind] += r["keep"].numel()
        if self.keep_routes:
            self.routes.append((r["expert_idx"].cpu(), r["keep"].cpu()))
        return r


def family_cut(arch: str, layers: int):
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), n_layers=layers)


def family_weights(cfg):
    """The port's model of ``cfg`` in float32 on the host, drawn by its own
    init from a CPU torch.Generator (bf16-exact values, zero norms)."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, "cpu")
    return model.init_params(torch.Generator().manual_seed(
        FAMILY_SEED)).float()


def family_inputs(cfg, batch: int, positions: int):
    """A prompt batch (embeds and/or tokens from a numpy seed) and each
    decode step's frame embeddings for the audio family."""
    import numpy as np
    rng = np.random.default_rng(FAMILY_SEED)
    d = cfg.d_model
    out = {}
    if cfg.embed_input:
        n = cfg.prefix_len if cfg.family == "vlm" else positions
        out["embeds"] = rng.standard_normal((batch, n, d), dtype=np.float32)
    if cfg.family != "audio":
        n = positions - cfg.prefix_len if cfg.family == "vlm" else positions
        out["tokens"] = rng.integers(0, cfg.vocab, (batch, n))
    frames = rng.standard_normal((FAMILY_STEPS, batch, 1, d),
                                 dtype=np.float32)
    return out, frames


def cache_to(cache, device):
    """A decode cache's copy on ``device`` (nested dicts of tensors and an
    int index)."""
    if isinstance(cache, dict):
        return {k: cache_to(v, device) for k, v in cache.items()}
    return cache.to(device, copy=True) if hasattr(cache, "to") else cache


def family_serve_run(device, cfg, params, batch: int, positions: int,
                     record: bool = False, replay=None) -> dict:
    """A prefill and FAMILY_STEPS greedy decode steps (the audio family fed
    seeded frames): tokens (codes), each step's logits on the host, every
    MoE call's routes, the flash launches and the seconds.  ``record``
    keeps a host copy of the cache before each decode step (``states``);
    ``replay`` (another run's result with ``states``) also runs each step
    from that run's cache and token, its logits as ``replayed``."""
    import torch
    from repro_torch import serve
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, device)
    inputs, frames = family_inputs(cfg, batch, positions)
    recorder = (RouteRecorder(cfg.n_layers, device, keep_routes=True)
                if cfg.moe is not None else None)
    reset_flash_counts()
    t0 = time.perf_counter()
    try:
        prefill_fn, decode_fn = serve.build_serve_fns(
            model, positions + FAMILY_STEPS)
        logits, cache = prefill_fn(params, inputs)
        out_logits, toks, states, replayed = [logits.float().cpu()], [], \
            [], []
        for i in range(FAMILY_STEPS):
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok.cpu())
            if recorder is not None:
                recorder.kind = "decode"
            step = ({"embeds": frames[i]} if cfg.family == "audio"
                    else {"tokens": tok})
            if record:
                states.append(cache_to(cache, "cpu"))
            if replay is not None:
                replayed.append(decode_fn(
                    params, {"tokens": replay["tokens"][:, i:i + 1]},
                    cache_to(replay["states"][i], device))[0].float().cpu())
            logits, cache = decode_fn(params, step, cache)
            out_logits.append(logits.float().cpu())
    finally:
        drops = recorder.close() if recorder is not None else None
    fwd, _, routes, _ = flash_counts()
    return {"tokens": torch.cat(toks, 1), "logits": out_logits,
            "states": states, "replayed": replayed,
            "routes": recorder.routes if recorder is not None else [],
            "drops": drops, "flash_launches": fwd, "flash_by_route": routes,
            "seconds": time.perf_counter() - t0}


def family_train_batch(cfg) -> dict:
    """FAMILY_TRAIN's batch: family_inputs' embeddings and tokens, and
    seeded targets, -1 over a VLM's prefix."""
    import numpy as np
    shape = FAMILY_TRAIN[cfg.name][1:]
    batch, _ = family_inputs(cfg, *shape)
    targets = np.random.default_rng(FAMILY_SEED + 1).integers(
        0, cfg.vocab, shape)
    targets[:, :cfg.prefix_len] = -1
    return dict(batch, targets=targets)


def family_train_run(device, cfg, params) -> dict:
    """The loss and every gradient (float32, on the host) at FAMILY_TRAIN's
    batch (for paligemma 256 patch embeddings and 256 text tokens a row,
    the prefix's targets ignored).  The token embedding's gradient is kept
    for the rows the batch reads; ``embed_other_rows_zero`` says the others
    are 0."""
    import numpy as np
    import torch
    from repro_torch.models import build_model, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, device)
    batch = family_train_batch(cfg)
    transformer.trainable(params)
    reset_flash_counts()
    t0 = time.perf_counter()
    try:
        names, leaves = zip(*params.named_parameters())
        loss = model.loss_fn(params, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    finally:
        for p in params.parameters():
            p.requires_grad_(False)
    rows = torch.as_tensor(np.unique(batch["tokens"]), device=device)
    used = torch.zeros(cfg.vocab, dtype=torch.bool, device=device)
    used[rows] = True
    embed = grads.pop("embed")
    out = {n: g.float().cpu() for n, g in grads.items()}
    out["embed_rows"] = embed[rows].float().cpu()
    zero_elsewhere = not bool(embed[~used].abs().max())
    del grads, embed
    fwd, bwd, routes, bwd_routes = flash_counts()
    return {"loss": float(loss.detach()), "grads": out,
            "embed_other_rows_zero": zero_elsewhere,
            "seconds": time.perf_counter() - t0,
            "counts": (fwd, bwd, routes, bwd_routes)}


def family_parity_cpu(path: str) -> dict:
    """family_parity's CPU side in a spawned process on two threads: each
    model's serving run, then its loss and gradients where FAMILY_TRAIN
    names it; the results go to the torch.save file ``path``."""
    import torch
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    out = {}
    for arch, (layers, batch, positions) in FAMILY_PARITY.items():
        cfg = family_cut(arch, layers)
        params = family_weights(cfg)
        out[arch] = family_serve_run(cpu, cfg, params, batch, positions,
                                     record=cfg.family == "hybrid")
        if arch in FAMILY_TRAIN:
            cfg = family_cut(arch, FAMILY_TRAIN[arch][0])
            if cfg.n_layers != layers:
                params = family_weights(cfg)
            out[f"{arch} train"] = family_train_run(cpu, cfg, params)
        del params
    torch.save(out, path)
    return {arch: r["seconds"] for arch, r in out.items()}


def start_family_parity_cpu():
    """Starts family_parity's CPU side in a spawned process and, in a
    thread of this one, draws the card side's host weights (the same CPU
    generator, one core); returns a function that waits for both and gives
    (the CPU side's results, {arch: host weights})."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import os
    import tempfile
    import threading
    import torch
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    pool = cf.ProcessPoolExecutor(max_workers=1,
                                  mp_context=mp.get_context("spawn"))
    future = pool.submit(family_parity_cpu, path)
    pool.shutdown(wait=False)
    weights = {}

    def draw():
        for arch, (layers, _, _) in FAMILY_PARITY.items():
            weights[arch] = family_weights(family_cut(arch, layers))
            train_layers = FAMILY_TRAIN.get(arch, (layers,))[0]
            if train_layers != layers:
                weights[f"{arch} train"] = family_weights(
                    family_cut(arch, train_layers))
    thread = threading.Thread(target=draw, daemon=True)
    thread.start()

    def result() -> tuple:
        future.result()
        thread.join()
        out = torch.load(path)
        os.remove(path)
        return out, weights
    return result


def smoke_train_parity(device) -> None:
    """One float32 AdamW step of each FAMILY_SMOKE config on the card and
    on the CPU from the same weights (drawn by the port's init from a CPU
    generator): loss, gradient norm and every parameter after the step."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, transformer
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_opt_state)
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                              eps=1e-3)
    for arch in FAMILY_SMOKE:
        cfg = get_arch(arch, smoke=True)
        weights = build_model(cfg, "cpu").init_params(
            torch.Generator().manual_seed(FAMILY_SEED)).float()
        batch, _ = family_inputs(cfg, 2, 32)
        batch["targets"] = np.random.default_rng(FAMILY_SEED).integers(
            0, cfg.vocab, (2, 32))
        runs = {}
        for dev in (device, torch.device("cpu")):
            params = transformer.trainable(copy.deepcopy(weights).to(dev))
            state = {"params": params, "opt": init_opt_state(params,
                                                             opt_cfg)}
            reset_flash_counts()
            state, metrics = build_train_step(build_model(cfg, dev),
                                              opt_cfg)(state, batch)
            runs[dev.type] = (float(metrics["loss"]),
                              float(metrics["grad_norm"]),
                              {n: p.detach().cpu() for n, p in
                               state["params"].named_parameters()},
                              flash_counts()[:2])
        card, host = runs[device.type], runs["cpu"]
        worst = max(float((card[2][n] - p).abs().max())
                    for n, p in host[2].items())
        row = {"arch": arch, "loss_card": card[0], "loss_cpu": host[0],
               "grad_norm_card": card[1], "grad_norm_cpu": host[1],
               "worst_param_err": worst, "flash_launches_card": card[3]}
        emit("family_parity", part="smoke train step", **row)
        if (abs(card[0] - host[0]) > 1e-5 * abs(host[0])
                or abs(card[1] - host[1]) > 1e-4 * abs(host[1])
                or worst > 2e-6):
            raise AssertionError(f"family_parity: {arch}'s smoke train step "
                                 f"differs card vs CPU: {row}")
        calls = attention_calls(cfg)
        if device.type == "cuda" and card[3] != (2 * calls, calls):
            raise AssertionError(f"family_parity: {arch}'s smoke step made "
                                 f"{card[3]} flash launches")


def as_init_dtypes(cfg, params) -> None:
    """Casts each parameter, in place, to the dtype the port's init gives
    it (read from the smoke config's init, whose names are the same but
    for layer indices): bf16 matrices, float32 norms, lerps and the
    hybrid's conv weights."""
    import re
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    def key(name):
        return re.sub(r"\.\d+\.", ".", name)
    smoke = get_arch(cfg.name, smoke=True)
    dtypes = {key(n): p.dtype for n, p in build_model(smoke, "cpu")
              .init_params(torch.Generator().manual_seed(0))
              .named_parameters()}
    for n, p in params.named_parameters():
        p.data = p.data.to(dtypes[key(n)])


def phase_family_parity(device, host) -> None:
    """Card against CPU in float32 (TF32 off) at full width, cut in depth
    (FAMILY_PARITY): each model's greedy tokens (codes) over a prefill and
    FAMILY_STEPS decode steps equal, every step's logits within 1e-3 x
    max |logit|, the MoE's expert choices and kept masks equal at every
    layer; for FAMILY_TRAIN's models the loss and every gradient within
    train_parity (a)'s limits (paligemma: the backward's prefix path at dh
    256 with one KV head; zamba2: the shared block at dh 80), and a bf16
    train step of the same weights on the tensor-core route; then each
    FAMILY_SMOKE config's train step.  ``host`` is
    start_family_parity_cpu's function."""
    import torch
    from repro_torch.models import build_model, transformer
    from repro_torch.train import (OptimizerConfig, build_train_step,
                                   init_opt_state)
    t0 = time.perf_counter()
    cpu_runs, weights = host()
    waited = time.perf_counter() - t0
    for arch, (layers, batch, positions) in FAMILY_PARITY.items():
        cfg = family_cut(arch, layers)
        calls = attention_calls(cfg)
        params = weights.pop(arch).to(device)
        cpu = cpu_runs[arch]
        # The hybrid's conv state is rounded to bf16 after every step (the
        # reference's cast): a float32 value within rounding of the CPU's
        # can round to the other bf16 neighbour, and the two chains part
        # by more than rounding.  Each decode step is also run from the
        # CPU's cache and token and held to 1e-3 there; the own chain to
        # 1e-2.
        hybrid = cfg.family == "hybrid"
        card = family_serve_run(device, cfg, params, batch, positions,
                                replay=cpu if hybrid else None)

        def rel_err(got, want):
            return max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(got, want))
        rel = rel_err(card["logits"], cpu["logits"])
        same = {}
        if hybrid:
            same["max_rel_logit_err_same_state"] = rel_err(
                card["logits"][:1] + card["replayed"], cpu["logits"])
        finite = all(bool(torch.isfinite(x).all()) for x in card["logits"])
        equal = torch.equal(card["tokens"], cpu["tokens"])
        routes_equal = len(card["routes"]) == len(cpu["routes"]) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(card["routes"], cpu["routes"]))
        emit("family_parity", model=f"{arch} full width, {layers} layers",
             batch=batch, positions=positions, steps=FAMILY_STEPS,
             dtype="float32", tokens_equal=equal, max_rel_logit_err=rel,
             **same, finite=finite, moe_calls=len(card["routes"]),
             routes_equal=routes_equal, moe_drops=card["drops"],
             card_seconds=card["seconds"], cpu_seconds=cpu["seconds"],
             flash_launches_card=card["flash_launches"],
             flash_launches_by_route=card["flash_by_route"])
        close = (rel <= 1e-2 and same["max_rel_logit_err_same_state"]
                 <= 1e-3) if hybrid else rel <= 1e-3
        if not (equal and finite and close and routes_equal):
            raise AssertionError(f"family_parity: {arch} differs card vs "
                                 f"CPU (tokens {equal}, logits {rel} "
                                 f"{same}, routes {routes_equal})")
        if card["flash_launches"] != calls or (
                cfg.moe is not None and not card["routes"]):
            raise AssertionError(f"family_parity: {arch} made "
                                 f"{card['flash_launches']} flash launches "
                                 f"and {len(card['routes'])} MoE calls")
        if arch not in FAMILY_TRAIN:
            del params
            release(device)
            continue
        if FAMILY_TRAIN[arch][0] != layers:
            del params
            release(device)
            cfg = family_cut(arch, FAMILY_TRAIN[arch][0])
            calls = attention_calls(cfg)
            params = weights.pop(f"{arch} train").to(device)
        got = family_train_run(device, cfg, params)
        want = cpu_runs[f"{arch} train"]
        worst = 0.0
        for n, g in want["grads"].items():
            err = float((got["grads"][n] - g).abs().max())
            scale = float(g.abs().max())
            if not (err <= 1e-4 * scale or err == 0.0):
                raise AssertionError(f"family_parity: {arch}'s gradient "
                                     f"{n} differs card vs CPU by {err} "
                                     f"(max |g| {scale})")
            worst = max(worst, err / scale if scale else 0.0)
        loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        fwd, bwd, routes, bwd_routes = got["counts"]
        # The same weights in their init dtypes (each is bf16-exact): one
        # AdamW step through the tensor-core routes.
        as_init_dtypes(cfg, params)
        model = build_model(cfg, device)
        opt_cfg = OptimizerConfig()
        transformer.trainable(params)
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        reset_flash_counts()
        _, metrics = build_train_step(model, opt_cfg)(state,
                                                      family_train_batch(cfg))
        bf16_loss = float(metrics["loss"])
        bf16 = flash_counts()
        emit("family_parity", part=f"{arch} train, {cfg.n_layers} layers",
             tokens=list(FAMILY_TRAIN[arch][1:]), prefix_len=cfg.prefix_len,
             dtype="float32", loss_card=got["loss"], loss_cpu=want["loss"],
             loss_rel_err=loss_rel, worst_grad_err_over_max=worst,
             embed_other_rows_zero=[got["embed_other_rows_zero"],
                                    want["embed_other_rows_zero"]],
             card_seconds=got["seconds"], cpu_seconds=want["seconds"],
             flash_launches_card=fwd, flash_launches_by_route=routes,
             flash_bwd_launches_card=bwd,
             flash_bwd_launches_by_route=bwd_routes,
             bf16_step_loss=bf16_loss, bf16_step_flash_launches=bf16[0],
             bf16_step_flash_by_route=bf16[2],
             bf16_step_flash_bwd_launches=bf16[1],
             bf16_step_flash_bwd_by_route=bf16[3])
        if loss_rel > 1e-5 or not (got["embed_other_rows_zero"]
                                   and want["embed_other_rows_zero"]):
            raise AssertionError(f"family_parity: {arch}'s loss differs "
                                 f"card vs CPU ({loss_rel})")
        if (fwd, bwd) != (2 * calls, calls) or bwd_routes["scalar"] != bwd:
            raise AssertionError(f"family_parity: {arch}'s float32 "
                                 f"gradients made {fwd} forward and {bwd} "
                                 f"backward ({bwd_routes}) launches")
        if not abs(bf16_loss - got["loss"]) <= 2e-2 * abs(got["loss"]) \
                or bf16[:2] != (2 * calls, calls) \
                or bf16[3]["tensor_core"] != calls:
            raise AssertionError(f"family_parity: {arch}'s bf16 step: "
                                 f"loss {bf16_loss}, launches {bf16}")
        del params, state, model, got, want
        release(device)
    smoke_train_parity(device)
    emit("family_parity", waited_for_cpu_seconds=waited,
         seconds=time.perf_counter() - t0)


def cell_embed_serve(device, arch: str) -> int:
    """paligemma-3b-serve or musicgen-large-serve: the model at full width
    and depth in bf16, weights drawn on the card from a seeded generator,
    EMBED_CELLS[arch]'s requests served as one batch: a prefill of seeded
    patch embeddings and text tokens (paligemma) or frame embeddings
    (musicgen), then greedy decode steps, fed each step's token (paligemma)
    or a seeded frame embedding (musicgen).  Returns the flash launches."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    requests, positions, new_tokens = EMBED_CELLS[arch]
    name = f"{arch}-serve"
    cfg = get_arch(arch)
    model = build_model(cfg, device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device).manual_seed(
        FAMILY_SEED))
    gen = torch.Generator(device).manual_seed(FAMILY_SEED + 1)
    n_embeds = cfg.prefix_len if cfg.family == "vlm" else positions
    batch = {"embeds": torch.randn((requests, n_embeds, cfg.d_model),
                                   generator=gen, device=device).to(
        torch.bfloat16)}
    if cfg.family == "vlm":
        batch["tokens"] = torch.as_tensor(np.random.default_rng(
            FAMILY_SEED).integers(0, cfg.vocab, (requests,
                                                 positions - n_embeds)),
            device=device)
    frames = torch.randn((new_tokens, requests, 1, cfg.d_model),
                         generator=gen, device=device).to(torch.bfloat16)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    max_len = positions + new_tokens
    spec = model.cache_spec(requests, max_len)["k"]
    cache_bytes = 2 * int(np.prod(spec[0])) * spec[1].itemsize
    prefill_fn, decode_fn = serve.build_serve_fns(model, max_len)
    audit = FlashAudit(every=10)
    reset_flash_counts()
    finite = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite &= bool(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1)[:, None]
        out = []
        t0 = time.perf_counter()
        for i in range(new_tokens):
            step = ({"embeds": frames[i]} if cfg.family == "audio"
                    else {"tokens": tok})
            logits, cache = decode_fn(params, step, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        generated = torch.cat(out, 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        finite &= bool(torch.isfinite(logits).all())
    finally:
        audit.close()
    launches, _, routes, _ = flash_counts()
    completed = int(((generated >= 0)
                     & (generated < cfg.vocab)).all(1).sum())
    emit("family_full", cell=name, source=cfg.source,
         params=cfg.num_params(), weight_bytes=sum(
             p.numel() * p.element_size() for p in params.parameters()),
         init_seconds=init_seconds, requests=requests, positions=positions,
         prefix_len=cfg.prefix_len, new_tokens=new_tokens, max_len=max_len,
         kv_cache_bytes=cache_bytes, prefill_seconds=prefill_s,
         prompt_tokens_per_s=requests * positions / prefill_s,
         decode_seconds=decode_s,
         seconds_per_output_token=decode_s / new_tokens,
         decode_tokens_per_s=requests * new_tokens / decode_s,
         requests_completed=completed,
         tokens_generated=int(generated.numel()), flash_launches=launches,
         flash_launches_by_route=routes, flash_checked=audit.checked,
         flash_max_abs_err=audit.max_abs_err, logits_finite=finite,
         peak_bytes=torch.cuda.max_memory_allocated(device),
         card=card_line())
    pre = profile_window(lambda: prefill_fn(params, batch),
                         focus="flash_attention")
    emit("family_full", cell=name, profile="prefill (the request batch)",
         **pre)
    if completed != requests or generated.shape != (requests, new_tokens):
        raise AssertionError(f"{name}: {completed} of {requests} requests "
                             f"completed")
    if launches != cfg.n_layers or routes["tensor_core"] != launches:
        raise AssertionError(f"{name}: {launches} flash launches "
                             f"({routes}) for one prefill")
    if not finite or not audit.checked:
        raise AssertionError(f"{name}: non-finite logits or no flash launch "
                             f"checked")
    return launches


def phase_family_full(device) -> dict:
    """The five family cells, each alone on the card; returns each main
    path's launch counts (none for rwkv6, which runs no kernel of the
    port's)."""
    from repro_torch.configs import get_arch
    runs = {}
    for arch in EMBED_CELLS:
        runs[f"{arch}-serve"] = {"flash_attention": cell_embed_serve(device,
                                                                     arch)}
        release(device)
    for arch in SLOT_ARCHS:
        launches = cell_serve(device, SLOTS, SLOT_REQUESTS, SLOT_PROMPT,
                              SLOT_NEW_TOKENS,
                              SLOT_PROMPT + 2 * SLOT_NEW_TOKENS, arch=arch,
                              phase="family_full")
        runs[f"{arch}-serve"] = ({"flash_attention": launches}
                                 if attention_calls(get_arch(arch)) else {})
        release(device)
    return runs


# ---------------------------------------------------------------------------
# Z-order keys and the paper's evaluation baselines: the zorder kernel,
# the six methods card against CPU, and the tpch-sf10-zorder cell
# ---------------------------------------------------------------------------

INT_OPS_PER_S = FP32_OPS_PER_S  # no integer row in the data sheet's table:
#                                 integer operations count at the float32 rate
ZORDER_METHODS = ("Static", "Greedy", "Regret", "OREO", "MTS Optimal",
                  "Offline Optimal")
# (name, entry, rows, columns, key columns, bits, narrow, layout, k): entry
# "a" is zorder_keys (float32), "b" zorder_keys64, "route" zorder_route64;
# layout "row" is a row-major table, "col" a column-major one, "stride2" a
# view of every other column of a row-major table twice as wide.
ZORDER_CASES = [
    ("a: bench 1,000,000 x 3, bits 10", "a", 1_000_000, 3, 3, 10, False,
     "row", None),
    ("a: m 4, bits 8, values past lo/hi", "a", 4_097, 4, 4, 8, True, "row",
     None),
    ("a: m 5, bits 6, values past lo/hi", "a", 1_025, 5, 5, 6, True, "row",
     None),
    ("a: m 1, bits 16", "a", 64, 1, 1, 16, False, "row", None),
    ("a: m 2, bits 16, a flat column (hi == lo)", "a", 1_024, 2, 2, 16,
     True, "row", None),
    ("a: m 32, bits 1", "a", 77, 32, 32, 1, False, "row", None),
    ("a: one row", "a", 1, 3, 3, 10, False, "row", None),
    ("b: sample 1,199,721 x 3, contiguous", "b", 1_199_721, 3, 3, 16,
     False, "row", None),
    ("b: sample 1,199,721 rows of 32 columns, 3 keyed in place", "b",
     1_199_721, 32, 3, 16, False, "row", None),
    ("b: column-major 1,199,721 x 32, 3 keyed", "b", 1_199_721, 32, 3, 16,
     False, "col", None),
    ("b: column stride 2, m 4 of 8 columns, values past lo/hi", "b", 4_099,
     8, 4, 16, True, "stride2", None),
    ("b: m 4 of 8 columns, values past lo/hi", "b", 4_099, 8, 4, 16, True,
     "row", None),
    ("b: m 5 of 8 columns, bits past 63 dropped", "b", 4_099, 8, 5, 16,
     True, "row", None),
    ("b: one row", "b", 1, 8, 3, 16, False, "row", None),
    ("route: 1,199,721 rows of 32 columns in place, k 32, values past "
     "lo/hi", "route", 1_199_721, 32, 3, 16, True, "row", 32),
    ("route: column-major 1,199,721 x 32, k 32, values past lo/hi",
     "route", 1_199_721, 32, 3, 16, True, "col", 32),
    ("route: column stride 2, m 3 of 8 columns, k 32", "route", 4_099, 8, 3,
     16, True, "stride2", 32),
    ("route: k 1", "route", 4_099, 8, 3, 16, True, "row", 1),
    ("route: k 2", "route", 4_099, 8, 3, 16, True, "row", 2),
    ("route: k 1,024", "route", 100_003, 8, 3, 16, True, "row", 1_024),
    ("route: m 5 of 8 columns, k 32, bits past 63 dropped", "route", 4_099,
     8, 5, 16, True, "row", 32),
    ("route: one row, k 32", "route", 1, 8, 3, 16, False, "row", 32),
]
ZORDER_MAIN = "b: sample 1,199,721 x 3, contiguous"  # a Z-order build's keys
# zorder_keys64's `path` codes, each forced in zorder_full beside the choice.
ZORDER_PATHS = {1: "one_row_a_thread", 2: "four_rows_a_thread",
                3: "warp_tile"}


def zorder_bound(rows: int, m: int, bits: int, itemsize: int,
                 parts: int = 0) -> dict:
    """Least time for ``rows`` keys of ``m`` columns: each value read once,
    lo/hi read once, one int64 key (or partition id) written per row; per
    value 4 float operations (subtract, divide, clamp, multiply) in the
    value's type and 4 integer operations per kept bit (shift, mask, shift,
    or).  ``parts`` > 0 routes to that many partitions: its ``parts - 1``
    boundaries read once and one compare per step of a binary search."""
    nbytes = (rows * m * itemsize + 2 * m * itemsize + rows * 8
              + max(parts - 1, 0) * 8)
    float_ops = 4 * rows * m
    int_ops = (4 * rows * min(m * bits, 64)
               + rows * (max(parts - 2, 0).bit_length() + 1 if parts > 1
                         else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (float_ops / (FP64_OPS_PER_S if itemsize == 8
                          else FP32_OPS_PER_S)
             + int_ops / INT_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "ops": float_ops + int_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sector_floor_ms(rows: int, zcols, strides, itemsize: int = 8) -> float:
    """Least time to read the distinct 32-byte sectors that hold the key
    columns (each once) and write one int64 a row, for a table at a
    32-byte-aligned base with these (row, column) strides in elements: the
    sectors of the first 1,024 rows counted and scaled to ``rows``."""
    import numpy as np
    span = max(1, min(rows, 1024))
    addr = (np.arange(span)[:, None] * strides[0]
            + np.asarray(zcols)[None, :] * strides[1]) * itemsize
    sectors = len(np.unique(addr // 32))
    return (sectors * 32 * rows / span + rows * 8) / HBM_BYTES_PER_S * 1e3


def zorder_operands(rng, lane, rows, columns, m, narrow, layout, device):
    """Values (lane a: (rows, m) float32) or a table (lanes b and route:
    (rows, columns) float64 with m key columns, in ``layout``), and lo/hi;
    ``narrow`` takes lo/hi from the first third of the rows and flattens
    one column (hi == lo)."""
    import numpy as np
    import torch
    if lane == "a":
        vals = rng.uniform(-5, 5, (rows, m)).astype(np.float32)
        cols = list(range(m))
    else:
        vals = rng.uniform(-50, 150, (rows, columns))
        cols = sorted(rng.choice(columns, m, replace=False).tolist())
    sub = vals[: max(1, rows // 3) if narrow else rows][:, cols]
    lo, hi = sub.min(0), sub.max(0)
    if narrow:
        hi[0] = lo[0]

    def dev(a):
        return torch.as_tensor(a, device=device)
    table = dev(vals)
    if layout == "col":
        table = table.t().contiguous().t()
    elif layout == "stride2":
        wide = torch.zeros((rows, 2 * columns), dtype=table.dtype,
                           device=device)
        wide[:, ::2] = table
        table = wide[:, ::2]
    return table, cols, dev(lo), dev(hi)


def zorder_boundaries(keys, k: int):
    """A Z-order build's k - 1 key-quantile boundaries of ``keys`` (so the
    keys of k - 1 rows equal a boundary)."""
    import numpy as np
    import torch
    n = len(keys)
    cut = np.minimum((np.arange(1, k) * n) // k, n - 1)
    return torch.sort(keys).values[torch.as_tensor(cut,
                                                   device=keys.device)]


def phase_zorder_kernel(device) -> dict:
    """The zorder kernel's three entries against their plain versions,
    bitwise, at the bench shape, the shapes of the main path, column-major
    and column-stride-2 tables, routes to 1, 2, 32 and 1,024 partitions
    (keys on a boundary, values past lo/hi) and edge shapes, timed by CUDA
    events; returns the summary of the main path's sample keys."""
    import ctypes
    import numpy as np
    import torch
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(15)
    lib = zorder._lib()
    if lib.zorder_max_parts() != zorder.MAX_PARTS:
        raise AssertionError(f"zorder: the kernel takes "
                             f"{lib.zorder_max_parts()} partitions, the "
                             f"wrapper {zorder.MAX_PARTS}")
    stream = torch.cuda.current_stream(device).cuda_stream
    results = []
    for (name, lane, rows, columns, m, bits, narrow, layout,
         k) in ZORDER_CASES:
        vals, cols, lo, hi = zorder_operands(rng, lane, rows, columns, m,
                                             narrow, layout, device)
        out = torch.empty(rows, dtype=torch.int64, device=device)
        host_cols = (ctypes.c_int64 * m)(*cols)
        extra = {}
        if lane == "a":
            def wrapper():
                return zorder.zorder_keys(vals, lo, hi, bits)

            def plain():
                return zref.zorder_keys(vals, lo, hi, bits)

            def raw():
                lib.zorder_keys32(vals.data_ptr(), lo.data_ptr(),
                                  hi.data_ptr(), out.data_ptr(), rows, m,
                                  bits, stream)
        elif lane == "b":
            def wrapper():
                return zorder.zorder_keys64(vals, cols, lo, hi)

            def plain():
                return zref.zorder_keys64(vals, cols, lo, hi)

            def raw():
                lib.zorder_keys64(vals.data_ptr(), vals.stride(0),
                                  vals.stride(1), ctypes.addressof(host_cols),
                                  lo.data_ptr(), hi.data_ptr(),
                                  out.data_ptr(), rows, m, 0, stream)
        else:
            keys = zref.zorder_keys64(vals, cols, lo, hi)
            bnd = zorder_boundaries(keys, k)
            extra = {"k": k, "keys_on_a_boundary":
                     int(torch.isin(keys, bnd).sum())}
            if k > 1 and not extra["keys_on_a_boundary"]:
                raise AssertionError(f"zorder case {name}: no key equals a "
                                     f"boundary")

            def wrapper():
                return zorder.zorder_route64(vals, cols, lo, hi, bnd, k)

            def plain():
                return zref.zorder_route64(vals, cols, lo, hi, bnd, k)

            def raw():
                lib.zorder_route64(vals.data_ptr(), vals.stride(0),
                                   vals.stride(1),
                                   ctypes.addressof(host_cols),
                                   lo.data_ptr(), hi.data_ptr(),
                                   bnd.data_ptr(), k, out.data_ptr(), rows,
                                   m, 0, stream)
        got, want = wrapper(), plain()
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        if mismatches:
            raise AssertionError(f"zorder kernel disagrees at {name}: "
                                 f"{mismatches} of {rows} outputs differ")
        reps = 200 if rows > 10_000 else 1000
        row = {"shape": name, "lane": lane, "rows": rows,
               "columns": columns, "zcols": cols if lane != "a" else None,
               "strides": list(vals.stride()), "bits": bits, "equal": True,
               "max_abs_err": 0, **extra,
               "ms": cuda_time_ms(raw, reps),
               "wrapper_ms": cuda_time_ms(wrapper, reps),
               "plain_ms": cuda_time_ms(plain, 20),
               **zorder_bound(rows, m, bits, vals.element_size(), k or 0)}
        if lane != "a":
            row["sector_floor_ms"] = sector_floor_ms(rows, cols,
                                                     vals.stride())
        results.append(row)
        emit("kernel", kernel="zorder", **row)
    main = next(r for r in results if r["shape"] == ZORDER_MAIN)
    return {"name": "zorder", "route": "cuda",
            "source": "src/repro_torch/csrc/zorder.cu",
            "replaces": "src/repro/kernels/zorder/zorder.py:49",
            "max_abs_err": 0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None}


def sass_memory_ops(library) -> dict:
    """The global loads and stores of each kernel in a built library, as
    ``cuobjdump -sass`` prints them: {kernel: {opcode: count}}.  An
    ``LTC128B``/``LTC256B`` suffix is an L2 prefetch of that many bytes."""
    import re
    from repro_torch.kernels import _backend
    tool = str(Path(_backend._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops, kernel = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            ops[kernel] = {}
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?((?:LDG|STG)\S*)", line)
        if op and kernel:
            ops[kernel][op.group(1)] = ops[kernel].get(op.group(1), 0) + 1
    return ops


def zorder_methods(data, stream, alpha, parts, gen):
    """Makers of the six methods of Figs. 3 and 4 over one generator."""
    from repro_torch import engine
    makers = policies(data, stream, alpha, parts, gen=gen)
    return {
        "Static": makers["Static"], "Greedy": makers["Greedy"],
        "Regret": makers["Regret"], "OREO": makers["OREO"],
        "MTS Optimal": lambda: engine.MTSOptimalPolicy(
            data, stream, gen, alpha, target_partitions=parts),
        "Offline Optimal": lambda: engine.OfflineOptimalPolicy(
            data, stream, gen, alpha, target_partitions=parts)}


def zorder_bench(dataset: str, rows: int, queries: int):
    """benchmarks/common.py build_bench, cut to ``rows`` rows, 16 columns
    (telemetry keeps its 9 and its own templates), 8 templates, 6
    segments; the table on the CPU."""
    import numpy as np
    from repro_torch import core
    from repro_torch.data import DATASETS, telemetry_templates, widen_columns
    data, _ = DATASETS[dataset](rows, seed=0, device="cpu")
    rng = np.random.default_rng(10)
    if dataset == "telemetry":
        templates = telemetry_templates(data.shape[1], seed=0)
    else:
        data = widen_columns(data, 16, seed=0)
        templates = core.make_templates(8, 16, rng, cols_per_template=(1, 2),
                                        selectivity_range=(0.02, 0.10))
    stream = core.generate_workload(
        templates, data.amin(dim=0).numpy(), data.amax(dim=0).numpy(),
        total_queries=queries, seed=20, num_segments=6)
    return data, stream


def phase_zorder_parity(device, rows: int = 20_000,
                        queries: int = 1_500) -> int:
    """The six methods under the Z-order generator on tpch, tpcds and
    telemetry, card against CPU; traces bitwise equal.  Returns the card
    runs' zorder launches."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.zorder import zorder
    launches = 0
    for dataset in ("tpch", "tpcds", "telemetry"):
        base, stream = zorder_bench(dataset, rows, queries)
        traces = {}
        for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
            data = base.to(dev)
            before = (zorder.zorder_keys64.launches
                      + zorder.zorder_route64.launches)
            gen = core.make_generator("zorder")
            for name, make in zorder_methods(data, stream, 40.0, 16,
                                             gen).items():
                t0 = time.perf_counter()
                res = engine.LayoutEngine(make(), engine.InMemoryBackend(
                    data)).run(stream, name=name)
                traces[side, name] = (res, time.perf_counter() - t0)
            if side == "card":
                launches += (zorder.zorder_keys64.launches
                             + zorder.zorder_route64.launches - before)
        for name in ZORDER_METHODS:
            (a, ta), (b, tb) = traces["card", name], traces["cpu", name]
            same = (np.array_equal(a.query_costs, b.query_costs)
                    and a.reorg_indices == b.reorg_indices
                    and np.array_equal(a.state_seq, b.state_seq))
            emit("zorder_parity", dataset=dataset, method=name,
                 bitwise_equal=same, total_cost=a.total_cost,
                 moves=a.num_reorgs, card_seconds=ta, cpu_seconds=tb)
            if not same:
                raise AssertionError(f"zorder_parity: {dataset} {name} "
                                     f"trace differs card vs CPU")
    if launches <= 0:
        raise AssertionError("zorder_parity: the card runs never launched "
                             "the zorder kernel")
    emit("zorder_parity", rows=rows, queries=queries,
         zorder_launches_card=launches)
    return launches


class ZOrderAudit:
    """Holds the first and every ``every``-th launch of each zorder entry
    of a main path (``zorder_keys64``: a build's sample keys;
    ``zorder_route64``: a table routed through a layout) against the plain
    version on the same card tensors (in row chunks, so the check's
    temporaries stay small beside the table).  It calls the wrapper once
    per call and launches no kernel itself."""

    ENTRIES = ("zorder_keys64", "zorder_route64")

    def __init__(self, every: int, chunk: int = 1 << 22):
        import functools
        from repro_torch.kernels.zorder import ops
        self.ops, self.every, self.chunk = ops, every, chunk
        self.inner = {e: getattr(ops, e) for e in self.ENTRIES}
        self.calls = dict.fromkeys(self.ENTRIES, 0)
        self.checked = dict.fromkeys(self.ENTRIES, 0)
        self.rows_checked = 0
        for e in self.ENTRIES:
            setattr(ops, e, functools.partial(self._call, e))

    def close(self) -> None:
        for e, fn in self.inner.items():
            setattr(self.ops, e, fn)

    def short(self) -> list:
        """The entries audited fewer times than every ``every``-th call."""
        return [e for e in self.ENTRIES
                if self.checked[e] < -(-self.calls[e] // self.every)]

    def _call(self, entry, table, zcols, col_lo, col_hi, *rest):
        import torch
        from repro_torch.kernels.zorder import ref as zref
        got = self.inner[entry](table, zcols, col_lo, col_hi, *rest)
        self.calls[entry] += 1
        if (self.calls[entry] - 1) % self.every == 0:
            plain = getattr(zref, entry)
            for s in range(0, len(table), self.chunk):
                want = plain(table[s:s + self.chunk], zcols, col_lo, col_hi,
                             *rest)
                if not torch.equal(got[s:s + self.chunk], want):
                    raise AssertionError(f"zorder_full: {entry} call "
                                         f"{self.calls[entry]} differs from "
                                         f"the plain version at rows {s}..")
            self.checked[entry] += 1
            self.rows_checked += len(table)
        return got


def zorder_stages(device, data, stream) -> dict:
    """Seconds and device memory above the resident table of one Z-order
    build, measured alone, beside the host's share of it: the sample draw
    (numpy's ``choice`` without replacement, the reference's stream)."""
    import numpy as np
    import torch
    from repro_torch.core import make_generator
    n = len(data)
    m = min(max(int(n * 0.02), min(n, 4096)), n)
    t0 = time.perf_counter()
    np.random.default_rng(0).choice(n, size=m, replace=False)
    draw = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    make_generator("zorder")(10_000, data, stream.queries[:200], PARTITIONS)
    torch.cuda.synchronize()
    return {"build_seconds": time.perf_counter() - t0,
            "build_bytes": torch.cuda.max_memory_allocated(device) - base,
            "sample_rows": m, "host_sample_draw_seconds": draw}


def cell_zorder(device, data, stream) -> dict:
    """tpch-sf10-zorder: tpch-sf10-oreo's table and traffic under the
    Z-order generator (3 key columns, 16 bits, a 2 % sample), the six
    methods of Figs. 3 and 4; returns the main path's launch counts."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.kernels.pruning import pruning, ref
    from repro_torch.kernels.zorder import zorder
    queries = len(stream)
    entries = (zorder.zorder_keys, zorder.zorder_keys64,
               zorder.zorder_route64)
    results, counts = {}, {"zorder": 0, "pruning": 0}
    for name in ZORDER_METHODS:
        gen = TimedGenerator(core.make_generator("zorder"))
        make = zorder_methods(data, stream, ALPHA, PARTITIONS, gen)[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        audit = ZOrderAudit(every=10)
        for fn in entries:
            fn.launches = 0
        pruning.scan_matrix.launches = 0
        try:
            t0 = time.perf_counter()
            policy = make()
            backend = engine.InMemoryBackend(data)
            meter = EstimateMeter(backend)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = engine.LayoutEngine(policy, backend).run(stream, name=name)
            torch.cuda.synchronize()
            run_wall = time.perf_counter() - t0
        finally:
            audit.close()
        launched = {"zorder": sum(fn.launches for fn in entries),
                    "pruning": pruning.scan_matrix.launches}
        for k, v in launched.items():
            counts[k] += v
        costs = res.query_costs
        if not (len(costs) == queries and np.isfinite(costs).all()
                and (costs >= 0).all() and (costs <= 1).all()
                and len(res.state_seq) == queries):
            raise AssertionError(f"zorder_full: {name} trace malformed")
        if launched["zorder"] <= 0 or audit.short():
            raise AssertionError(f"zorder_full: {name} made "
                                 f"{launched['zorder']} zorder launches, "
                                 f"audited {audit.checked} of "
                                 f"{audit.calls} calls")
        if zorder.zorder_keys64.launches != gen.calls:
            raise AssertionError(f"zorder_full: {name} made "
                                 f"{zorder.zorder_keys64.launches} key "
                                 f"launches for {gen.calls} builds")
        results[name] = res
        emit("zorder_full", method=name, total_cost=res.total_cost,
             query_cost=res.total_query_cost,
             reorg_cost=res.total_reorg_cost, moves=res.num_reorgs,
             setup_seconds=setup, decide_seconds=res.decide_seconds,
             reorg_seconds=res.reorg_seconds,
             serve_seconds=res.serve_seconds, run_wall_seconds=run_wall,
             zorder_launches=launched["zorder"],
             zorder_key_launches=zorder.zorder_keys64.launches,
             zorder_route_launches=zorder.zorder_route64.launches,
             pruning_launches=launched["pruning"], **meter.fields(),
             zorder_audited=audit.checked,
             zorder_rows_audited=audit.rows_checked,
             zorder_builds=gen.calls, zorder_build_seconds=gen.seconds,
             peak_bytes=torch.cuda.max_memory_allocated(device),
             info={k: v for k, v in res.info.items()
                   if isinstance(v, (int, float))})
        if name == "Static":
            layout = backend.serving_layout
            meta = layout.true_meta
            q_lo, q_hi = core.stack_queries(stream.queries)
            scanned = ref.scan_matrix(torch.as_tensor(q_lo),
                                      torch.as_tensor(q_hi),
                                      meta.mins.cpu(), meta.maxs.cpu())
            want = (core.layouts.scanned_dot(scanned.numpy(),
                                             meta.rows_host)
                    / max(meta.total_rows, 1))
            if not np.array_equal(want, costs):
                raise AssertionError("zorder_full: Static serve costs differ "
                                     "from the host recomputation")
            route = layout.route
        if name == "Offline Optimal":
            switches = sum(1 for a, b in zip(stream.segments,
                                             stream.segments[1:])
                           if a[2] != b[2])
            if res.num_reorgs != switches:
                raise AssertionError(f"zorder_full: Offline Optimal moved "
                                     f"{res.num_reorgs} times for "
                                     f"{switches} template changes")
    emit("zorder_full", stages=zorder_stages(device, data, stream))
    for row in zorder_full_route(device, data, route):
        emit("zorder_full", kernel="zorder", **row)
    oreo, static = results["OREO"], results["Static"]
    emit("zorder_full", cell="tpch-sf10-zorder",
         oreo_vs_static_pct=100.0 * (static.total_cost - oreo.total_cost)
         / static.total_cost,
         totals={k: r.total_cost for k, r in results.items()},
         launches=counts, card=card_line())
    if counts["zorder"] <= 0:
        raise AssertionError("zorder_full: the main path never launched the "
                             "zorder kernel")
    return counts


def zorder_full_route(device, data, route) -> list:
    """The full-table route of ``route`` (Static's layout) timed alone,
    four ways: keys only on the row-major table (the earlier route's first
    launch), the fused route (``zorder_route64``, what the main path runs),
    ``searchsorted`` + ``clamp_max`` alone over those keys (the earlier
    route's other two launches, what fusion saves), and keys only on a
    column-major copy of the table (made and freed here).  Each output is
    held bitwise against the plain version or the row-major keys; each row
    carries the zcols, the bound and the sector floor."""
    import ctypes
    import torch
    from repro_torch.kernels.zorder import ref as zref, zorder
    lib = zorder._lib()
    n, m, k = len(data), len(route.zcols), route.k
    zcols = route.zcols.tolist()
    lo, hi, bnd = route.col_lo, route.col_hi, route.boundaries
    host_cols = (ctypes.c_int64 * m)(*zcols)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    keys = torch.empty(n, dtype=torch.int64, device=device)
    ids = torch.empty(n, dtype=torch.int64, device=device)

    def keys_only(table, path=0):
        return lambda: lib.zorder_keys64(
            table.data_ptr(), table.stride(0), table.stride(1),
            ctypes.addressof(host_cols), lo.data_ptr(), hi.data_ptr(),
            keys.data_ptr(), n, m, path, cuda_stream)

    def fused():
        lib.zorder_route64(data.data_ptr(), data.stride(0), data.stride(1),
                           ctypes.addressof(host_cols), lo.data_ptr(),
                           hi.data_ptr(), bnd.data_ptr(), k, ids.data_ptr(),
                           n, m, 0, cuda_stream)

    def by_path(table):
        """Keys-only ms with each of the kernel's ways of taking rows forced
        (None where one cannot take the table); the kernel chooses among
        them from the operands."""
        ms = {}
        for path, name in ZORDER_PATHS.items():
            ok = keys_only(table, path)() == 0
            ms[f"ms_{name}"] = (cuda_time_ms(keys_only(table, path), 10)
                                if ok else None)
        return ms

    def searchsorted():
        return torch.clamp_max(torch.searchsorted(bnd, keys, right=True),
                               k - 1)

    def check(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"zorder_full: {what} differs from its "
                                 f"plain version")

    floor_rows = sector_floor_ms(n, zcols, data.stride())
    common = {"rows": n, "columns": data.shape[1], "zcols": zcols,
              "k": k, "card": card_line()}
    rows = []
    ms = cuda_time_ms(keys_only(data), 20)
    want_keys = zref.zorder_keys64(data, zcols, lo, hi)
    check("the full-table keys", keys, want_keys)
    rows.append({"shape": "full-table keys, row-major", **common, "ms": ms,
                 **by_path(data),
                 "plain_ms": cuda_time_ms(lambda: zref.zorder_keys64(
                     data, zcols, lo, hi), 3),
                 "sector_floor_ms": floor_rows, **zorder_bound(n, m, 16, 8)})
    ms = cuda_time_ms(fused, 20)
    want_ids = zref.zorder_route64(data, zcols, lo, hi, bnd, k)
    check("the fused full-table route", ids, want_ids)
    rows.append({"shape": "full-table route, row-major, fused", **common,
                 "ms": ms, "over_keys_only": ms / rows[0]["ms"],
                 "plain_ms": cuda_time_ms(lambda: zref.zorder_route64(
                     data, zcols, lo, hi, bnd, k), 3),
                 "sector_floor_ms": floor_rows,
                 **zorder_bound(n, m, 16, 8, k)})
    keys.copy_(want_keys)
    del want_keys
    ms = cuda_time_ms(searchsorted, 20)
    check("searchsorted + clamp_max", searchsorted(), want_ids)
    rows.append({"shape": "searchsorted + clamp_max over the full table's "
                 "keys (no zorder launch)", **common, "ms": ms,
                 "bound_of_its_bytes_ms": 2 * n * 8 / HBM_BYTES_PER_S * 1e3,
                 "sector_floor_ms": floor_rows,
                 **zorder_bound(n, m, 16, 8, k)})
    del want_ids
    columnar = data.t().contiguous().t()
    ms = cuda_time_ms(keys_only(columnar), 20)
    check("the column-major keys", keys,
          zref.zorder_keys64(data, zcols, lo, hi))
    rows.append({"shape": "full-table keys, column-major copy", **common,
                 "strides": list(columnar.stride()), "ms": ms,
                 **by_path(columnar),
                 "sector_floor_ms": sector_floor_ms(n, zcols,
                                                    columnar.stride()),
                 **zorder_bound(n, m, 16, 8)})
    del columnar
    release(device)
    return rows


# ---------------------------------------------------------------------------
# The routing plane and the serving front end: compute="reference", the
# router and the front end against BENCH_router.json / BENCH_serving.json,
# and the router cell at fleet16's width (inline, front end, processes)
# ---------------------------------------------------------------------------

ROUTER_CELL = "fleet16-sf1-oreo-router"
ROUTER_QUERIES = 500          # fleet16's 1,500 queries per tenant, cut
ROUTER_EXTRA = 100            # queries per tenant after the migration
ROUTER_SHARDS = 4
#: benchmarks/bench_serving.py's OVERLOAD front end (queue 48, block).
SERVING_OVERLOAD = dict(queue_capacity=48, overflow_policy="block",
                        breaker_open_frac=0.5, breaker_close_frac=0.1,
                        breaker_min_open_events=16, pump_chunk=4)


def tenant_traces(res) -> dict:
    """Each tenant's trace, by tenant (a routed result lists its tenants
    shard by shard)."""
    return {tid: run_trace(r) for tid, r in res.per_tenant.items()}


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_tenant(seed: int, rows: int, columns: int, alpha: float,
                 delta: int, partitions: int, device, ingest: bool = False):
    """One OREO tenant of benchmarks/bench_router.py and bench_serving.py
    (tenant_engine: a table drawn from default_rng(100 + seed), window 80,
    gen_every 40, seed 0, the default layout sorted on column 0)."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    data = torch.as_tensor(np.random.default_rng(FLEET_SEED + seed).uniform(
        0, 100, size=(rows, columns)), device=device)
    cfg = core.OreoConfig(alpha=alpha, seed=0, delta=delta,
                          manager=core.LayoutManagerConfig(
                              target_partitions=partitions, window_size=80,
                              gen_every=40))
    policy = engine.OreoPolicy(
        data, core.build_default_layout(0, data, partitions, sort_col=0),
        core.make_generator("qdtree"), cfg)
    return engine.LayoutEngine(
        policy, engine.InMemoryBackend(data), delta=cfg.delta,
        ingest=engine.IngestConfig() if ingest else None)


def fleet16_tenant(seed: int, rows: int, device="cuda"):
    """One tenant of the fleet16 cells (cell_fleet16's): a table drawn from
    default_rng(100 + seed) on ``device``.  Module level, so spawned shard
    workers can unpickle it."""
    import numpy as np
    import torch
    data = torch.as_tensor(np.random.default_rng(FLEET_SEED + seed).uniform(
        0, 100, size=(rows, 8)), device=device)
    return oreo_tenant(data, 20.0, 10, 16, 0, 80, 40)


def router_reference_mode(device, counted) -> None:
    """(a) compute="reference" on the card at parity's 20,000 x 8 config:
    OREO's and Static's traces equal the default mode's."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 100, size=(20_000, 8))
    templates = core.make_templates(4, 8, rng)
    stream = core.generate_workload(templates, table.min(0), table.max(0),
                                    total_queries=1500, seed=1,
                                    segment_length=(300, 500))
    data = torch.as_tensor(table, device=device)
    makers = policies(data, stream, 40.0, 16)
    for name in ("OREO", "Static"):
        traces, fields = {}, {}
        for compute in ("state_matrix", "reference"):
            t0 = time.perf_counter()
            res, launched = counted(lambda: engine.LayoutEngine(
                makers[name](), engine.InMemoryBackend(
                    data, compute=compute)).run(stream))
            traces[compute] = run_trace(res)
            fields[compute] = {"seconds": time.perf_counter() - t0,
                               "pruning_launches": launched["pruning"],
                               "total_cost": res.total_cost,
                               "moves": res.num_reorgs}
        if traces["reference"] != traces["state_matrix"]:
            raise AssertionError(f"router_parity: {name}'s reference-mode "
                                 f"trace differs from the default mode's")
        if device.type == "cuda" and not fields["reference"][
                "pruning_launches"]:
            raise AssertionError("router_parity: the reference path never "
                                 "launched the pruning kernel")
        emit("router_parity", case="compute='reference' 20,000 x 8",
             policy=name, bitwise_equal_to_default=True, **fields)


def bench_router_fields(device, counted, cpu=None) -> dict:
    """(b) BENCH_router.json's deterministic fields: events per shard at
    1, 2, 4 and 8 shards (each shard's drain timed alone, as the benchmark
    does), the 1-shard router equal to a plain fleet, and the migration
    section (4 shards, every 4th tenant moved at half the stream, traces
    equal to the unsharded fleet's).  With ``cpu``, the migration router's
    trace is also held card against CPU."""
    import numpy as np
    from repro_torch import core, engine
    bench = json.loads((ROOT / "BENCH_router.json").read_text())
    cfg = bench["config"]
    args = (cfg["rows"], cfg["columns"], cfg["alpha"], cfg["delta"],
            cfg["partitions"])
    stream = core.make_drift_scenario(
        cfg["scenario"], np.zeros(cfg["columns"]),
        np.full(cfg["columns"], 100.0), num_tenants=cfg["tenants"],
        queries_per_tenant=cfg["queries_per_tenant"], seed=7)
    events = list(stream)

    def tenants(dev):
        return {f"t{t}": bench_tenant(t, *args, device=dev)
                for t in range(cfg["tenants"])}

    bad, rows = [], []
    unsharded, launched = counted(lambda: engine.FleetEngine(
        tenants(device)).run(stream))
    for want in bench["results"]:
        n = want["num_shards"]
        router = engine.FleetRouter(tenants(device), num_shards=n)
        for ev in events:
            router.submit(ev)
        depths = {sid: router.shard(sid).queue_depth
                  for sid in router.shard_ids}
        walls = {}
        for sid in router.shard_ids:
            t0 = time.perf_counter()
            counted(router.shard(sid).drain)
            sync(device)
            walls[sid] = time.perf_counter() - t0
        res = router.result()
        if depths != want["events_per_shard"] or res.ticks != len(events):
            bad.append(("events_per_shard", n, depths,
                        want["events_per_shard"]))
        if n == 1 and fleet_trace(res) != fleet_trace(unsharded):
            bad.append(("one-shard router differs from the plain fleet",))
        rows.append({"num_shards": n, "events_per_shard": depths,
                     "critical_path_events_per_second":
                         len(events) / max(walls.values()),
                     "serial_events_per_second":
                         len(events) / sum(walls.values())})

    def migrated(dev):
        router = engine.FleetRouter(tenants(dev), num_shards=4)
        half = len(events) // 2
        for ev in events[:half]:
            router.submit(ev)
        router.drain()
        moved = 0
        for tid in list(router.tenant_ids)[::4]:
            src = router.shard_of(tid)
            dst = next(s for s in router.shard_ids if s != src)
            moved += router.migrate_tenant(tid, dst)
        for ev in events[half:]:
            router.submit(ev)
        router.drain()
        return router, moved

    (router, moved), _ = counted(lambda: migrated(device))
    res = router.result()
    migration = {"num_shards": 4, "tenants_migrated": moved,
                 "directory_overrides": len(router.directory.overrides),
                 "traces_bit_identical":
                     tenant_traces(res) == tenant_traces(unsharded)}
    if migration != bench["migration"]:
        bad.append(("migration", migration, bench["migration"]))
    card_equals_cpu = None
    if cpu is not None:
        (cpu_router, _), _ = counted(lambda: migrated(cpu), dev=cpu)
        card_equals_cpu = (fleet_trace(cpu_router.result())
                           == fleet_trace(res))
        if not card_equals_cpu:
            bad.append(("the migration router's card trace differs from "
                        "the CPU's",))
    emit("router_parity", case="BENCH_router.json", tenants=cfg["tenants"],
         shard_sweep=rows, migration=migration,
         card_equals_cpu=card_equals_cpu, equal_to_file=not bad)
    if bad:
        raise AssertionError(f"router_parity: differs from "
                             f"BENCH_router.json: {bad}")
    return migration


def bench_serving_fields(device, counted, cpu=None,
                         overload_queries: int = 400) -> dict:
    """(c) BENCH_serving.json's deterministic fields: for flash_crowd and
    ingest_burst, the closed serving loop (benchmarks/bench_serving.py's
    serving_config: queue 64, block, pump 8) equals the direct run, with
    its events, cache counters and breaker opens; then the overload cell
    (flash_crowd, 400 queries a tenant, K = 1, queue 48): breaker opens
    and closes, shed counts, no query dropped, the charge ledger that of
    the unshedded run.  With ``cpu``, the overload front end's trace and
    counters are also held card against CPU."""
    import numpy as np
    from repro_torch import core, engine, serve
    bench = json.loads((ROOT / "BENCH_serving.json").read_text())
    cfg = bench["config"]
    host = {f"t{t}": np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(cfg["rows"], cfg["columns"]))
        for t in range(cfg["tenants"])}
    lo = np.min([d.min(0) for d in host.values()], axis=0)
    hi = np.max([d.max(0) for d in host.values()], axis=0)
    args = (cfg["rows"], cfg["columns"], cfg["alpha"], cfg["delta"],
            cfg["partitions"])

    def stream_of(scenario, qpt):
        make = (core.make_ingest_scenario if scenario == "ingest_burst"
                else core.make_drift_scenario)
        return make(scenario, lo, hi, num_tenants=cfg["tenants"],
                    queries_per_tenant=qpt, seed=7)

    def fleet(dev, scenario, scheduler):
        return engine.FleetEngine(
            {f"t{t}": bench_tenant(t, *args, device=dev,
                                   ingest=scenario == "ingest_burst")
             for t in range(cfg["tenants"])}, scheduler())

    bad, rows = [], []
    for want in bench["results"]:
        scenario = want["scenario"]
        fs = stream_of(scenario, cfg["queries_per_tenant"])
        direct, _ = counted(lambda: fleet(device, scenario,
                                          engine.UnlimitedScheduler).run(fs))
        fe = serve.ServeFrontend(
            fleet(device, scenario, engine.UnlimitedScheduler),
            serve.FrontendConfig(queue_capacity=64, overflow_policy="block",
                                 pump_chunk=8, record_latency=True))

        def loop():
            for event in fs:
                fe.submit_blocking(event)
                fe.pump()
            fe.flush()
        t0 = time.perf_counter()
        counted(loop)
        wall = time.perf_counter() - t0
        stats = fe.stats()
        got = {"scenario": scenario, "tenants": len(fs.tenant_ids),
               "events": len(fs), "queries_per_tenant":
                   cfg["queries_per_tenant"],
               "cache": stats["cache"],
               "breaker_opens": stats["breaker"]["opens"]}
        lat = np.asarray(fe.latencies) * 1e3
        same = tenant_traces(fe.result()) == tenant_traces(direct)
        file_fields = {k: want[k] for k in ("scenario", "tenants", "events",
                                            "queries_per_tenant")}
        file_fields["cache"] = want["frontend"]["cache"]
        file_fields["breaker_opens"] = want["frontend"]["breaker_opens"]
        if got != file_fields or not same:
            bad.append((scenario, got, file_fields, same))
        rows.append({**got, "trace_equals_direct": same,
                     "events_per_second": len(fs) / wall,
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99))})

    fs = stream_of("flash_crowd", overload_queries)

    def overload(dev):
        ref = fleet(dev, "flash_crowd",
                    lambda: engine.KConcurrentScheduler(1)).run(fs)
        fe = serve.ServeFrontend(
            fleet(dev, "flash_crowd", lambda: engine.KConcurrentScheduler(1)),
            serve.FrontendConfig(record_latency=False, **SERVING_OVERLOAD))
        got = fe.run(fs)
        stats = fe.stats()
        dropped = sum(overload_queries - len(got.per_tenant[t].query_costs)
                      for t in fs.tenant_ids)
        ledger = all(got.per_tenant[t].reorg_indices
                     == ref.per_tenant[t].reorg_indices
                     and np.array_equal(got.per_tenant[t].state_seq,
                                        ref.per_tenant[t].state_seq)
                     for t in fs.tenant_ids)
        return {"scenario": "flash_crowd",
                "queue_capacity": SERVING_OVERLOAD["queue_capacity"],
                "scheduler": "k-concurrent(1)",
                "breaker_opens": stats["breaker"]["opens"],
                "breaker_closes": stats["breaker"]["closes"],
                "shed_count": stats["shed_count"],
                "shed_attempts": stats["shed_attempts"],
                "queries_dropped": dropped,
                "charge_ledger_identical": ledger}, (fleet_trace(got), stats)

    (over, card), _ = counted(lambda: overload(device))
    if over != bench["overload"]:
        bad.append(("overload", over, bench["overload"]))
    card_equals_cpu = None
    if cpu is not None:
        (_, on_cpu), _ = counted(lambda: overload(cpu), dev=cpu)
        card_equals_cpu = on_cpu == card
        if not card_equals_cpu:
            bad.append(("the overload front end's card trace or counters "
                        "differ from the CPU's",))
    emit("router_parity", case="BENCH_serving.json", scenarios=rows,
         overload=over, card_equals_cpu=card_equals_cpu,
         equal_to_file=not bad)
    if bad:
        raise AssertionError(f"router_parity: differs from "
                             f"BENCH_serving.json: {bad}")
    return over


def router_incremental_parity(device, counted, cpu, rows: int = 20_000,
                              queries: int = 150) -> None:
    """(d) Incremental tenants (600 rows a tick) migrated between 2 shards
    at a third of the stream, the router on run_batched's fleet_scan lane:
    traces and ledgers equal the unsharded fleet's, card and CPU."""
    import numpy as np
    from repro_torch import core, engine
    tables, lo, hi = ingest_tables(device, 4, rows, 8)
    host = {tid: d.cpu() for tid, d in tables.items()}
    stream = core.make_drift_scenario("sudden_shift", lo, hi, num_tenants=4,
                                      queries_per_tenant=queries, seed=11)
    events = list(stream)

    def tenants(data):
        return {tid: oreo_tenant(data[tid], 10.0, 5, 8, 2, 60, 30,
                                 incremental=True, rows_per_tick=600)
                for tid in stream.tenant_ids}

    def routed(data):
        router = engine.FleetRouter(tenants(data), num_shards=2)
        third = len(events) // 3
        for ev in events[:third]:
            router.submit(ev)
        router.drain(batched=True, compute="fleet_scan")
        for tid in stream.tenant_ids:
            src = router.shard_of(tid)
            router.migrate_tenant(tid, next(s for s in router.shard_ids
                                            if s != src))
        for ev in events[third:]:
            router.submit(ev)
        router.drain(batched=True, compute="fleet_scan")
        return router

    got = {}
    for dev, data in ((device, tables), (cpu, host)):
        fleet = engine.FleetEngine(tenants(data))
        ref, _ = counted(lambda: fleet.run(stream), dev=dev)
        router, _ = counted(lambda: routed(data), dev=dev)
        res = router.result()
        got[dev.type] = (tenant_traces(res), {
            tid: engine_ledgers(router.tenant(tid))
            for tid in stream.tenant_ids})
        want = (tenant_traces(ref), {tid: engine_ledgers(fleet.tenant(tid))
                                      for tid in stream.tenant_ids})
        if got[dev.type] != want:
            raise AssertionError(f"router_parity: the incremental router "
                                 f"on {dev.type} differs from the "
                                 f"unsharded fleet")
    migrations = sum(len(v) for v in got[device.type][1].values())
    if got[device.type] != got[cpu.type] or not migrations:
        raise AssertionError("router_parity: the incremental router's card "
                             "trace differs from the CPU's, or it planned "
                             "no migration")
    emit("router_parity", case="incremental router, 4 tenants of 20,000 x "
         "8, all migrated", migrations=migrations, card_equals_cpu=True,
         equal_to_unsharded=True)


def phase_router_parity(device) -> dict:
    """(a) compute="reference" against the default mode; (b) and (c) the
    router and the front end against BENCH_router.json and
    BENCH_serving.json, card against CPU where stated; (d) an incremental
    router's migrations card against CPU.  Returns the card's launches."""
    import torch
    cpu = torch.device("cpu")
    counters = kernel_counters()
    launched = {k: 0 for k in counters}
    t0 = time.perf_counter()

    def counted(fn, dev=device):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        now = {k: c.launches - before[k] for k, c in counters.items()}
        for k, n in now.items():
            if dev.type == "cuda":
                launched[k] += n
            elif n:
                raise AssertionError("router_parity: a CPU run launched a "
                                     "kernel")
        return out, now

    router_reference_mode(device, counted)
    emit("router_parity", part="a", seconds=time.perf_counter() - t0)
    bench_router_fields(device, counted, cpu)
    emit("router_parity", part="b", seconds=time.perf_counter() - t0)
    bench_serving_fields(device, counted, cpu)
    emit("router_parity", part="c", seconds=time.perf_counter() - t0)
    router_incremental_parity(device, counted, cpu)
    if device.type == "cuda" and not all(launched[k] for k in (
            "pruning", "fleet_scan", "move_score")):
        raise AssertionError(f"router_parity: the card runs did not launch "
                             f"every kernel of the router's paths: "
                             f"{launched}")
    emit("router_parity", launches_card=launched,
         seconds=time.perf_counter() - t0)
    return launched


class ShardTimer:
    """Times each shard fleet's drains inside a router's: the critical path
    of one router drain is its slowest shard's drain (shards share no
    state), summed over the router's drains (benchmarks/bench_router.py's
    definition, per drain)."""

    def __init__(self, router, device):
        self.critical = self.serial = 0.0
        self.drains = 0
        self._walls = {}
        inner_router = router.drain
        for sid in router.shard_ids:
            shard = router.shard(sid)
            shard.drain = self._timed(shard.drain, sid, device)

        def drain(**kw):
            self._walls = {}
            out = inner_router(**kw)
            if self._walls:
                self.critical += max(self._walls.values())
                self.serial += sum(self._walls.values())
                self.drains += 1
            return out
        router.drain = drain

    def _timed(self, inner, sid, device):
        def call(**kw):
            t0 = time.perf_counter()
            out = inner(**kw)
            sync(device)
            self._walls[sid] = self._walls.get(sid, 0.0) + (
                time.perf_counter() - t0)
            return out
        return call


def router_arm(label, fn, device) -> tuple:
    """One arm's main path: counts zeroed just before ``fn``, read just
    after, the first and every 50th fleet pass audited against the plain
    version; returns (fn's output, launches, wall seconds)."""
    import torch
    counters = kernel_counters()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for c in counters.values():
        c.launches = 0
    audit = ScanAudit(every=50)
    t0 = time.perf_counter()
    try:
        out = fn()
        sync(device)
    finally:
        audit.close()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if audit.checked < -(-audit.calls // 50):
        raise AssertionError(f"{ROUTER_CELL} {label}: only {audit.checked} "
                             f"of {audit.calls} passes were audited")
    emit("router_full", cell=ROUTER_CELL, arm=label,
         passes_scored=audit.calls, passes_audited=audit.checked)
    if device.type == "cuda" and not (launches["decision_fused"]
                                      and launches["pruning"]):
        raise AssertionError(f"{ROUTER_CELL} {label}: the arm did not launch "
                             f"decision_fused and pruning: {launches}")
    return out, launches, wall


def process_arm(spec_path: str) -> int:
    """Arm C's parent process (``--process-arm SPEC``): a ProcessShardSet
    of ROUTER_SHARDS workers on the card, driven through the stream, one
    cross-process migration and a tail of traffic.  This process never
    touches CUDA itself; it writes its traces and measurements next to
    the spec as a pickle."""
    import functools
    import pickle
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch.launch import shard_host
    spec = json.loads(Path(spec_path).read_text())
    lo, hi = np.array(spec["lo"]), np.array(spec["hi"])
    stream = core.make_drift_scenario(
        "sudden_shift", lo, hi, num_tenants=spec["tenants"],
        queries_per_tenant=spec["queries"], seed=7)
    extra = core.make_drift_scenario(
        "sudden_shift", lo, hi, num_tenants=spec["tenants"],
        queries_per_tenant=spec["extra"], seed=8)
    factories = {f"t{t}": functools.partial(fleet16_tenant, t, spec["rows"],
                                            spec["device"])
                 for t in range(spec["tenants"])}
    out = {}
    t0 = time.perf_counter()
    procs = shard_host.ProcessShardSet(
        factories, num_shards=spec["shards"],
        scheduler=engine.SchedulerSpec.k_concurrent(1))
    try:
        out["spawn_seconds"] = time.perf_counter() - t0
        hosts = [procs.host(sid) for sid in procs.shard_ids]
        for h in hosts:
            h.kernel_launches(reset=True)
        drains = []
        for ev in stream:
            procs.submit(ev)
        t0 = time.perf_counter()
        procs.drain(batched=True, compute="decision_fused")
        drains.append(time.perf_counter() - t0)
        res = procs.result()
        out["trace"] = (tenant_traces(res), res.ticks, res.swaps_deferred,
                        res.deferred_ticks, res.scheduler_stats)
        t0 = time.perf_counter()
        procs.migrate_tenant(spec["migrate"], spec["to"])
        out["migration_seconds"] = time.perf_counter() - t0
        for ev in extra:
            procs.submit(ev)
        t0 = time.perf_counter()
        procs.drain(batched=True, compute="decision_fused")
        drains.append(time.perf_counter() - t0)
        res = procs.result()
        out["trace_after_migration"] = (
            tenant_traces(res), res.ticks, res.swaps_deferred,
            res.deferred_ticks, res.scheduler_stats)
        out["drain_seconds"] = drains
        launches = [h.kernel_launches() for h in hosts]
        out["launches"] = {k: sum(n[k] for n in launches)
                           for k in launches[0]}
        out["worker_max_memory_allocated"] = {
            sid: procs.host(sid).max_memory_allocated()
            for sid in procs.shard_ids}
        out["placement"] = {tid: procs.shard_of(tid) for tid in factories}
    finally:
        procs.close()
    out["parent_cuda_initialized"] = torch.cuda.is_initialized()
    with open(spec_path + ".out", "wb") as f:
        pickle.dump(out, f)
    return 0


def phase_router_full(device, rows: int = SF1_ROWS, tenants: int = 16,
                      queries: int = ROUTER_QUERIES,
                      extra: int = ROUTER_EXTRA,
                      processes: bool = True) -> dict:
    """The fleet16-sf1-oreo-router cell: fleet16-sf1-oreo-k1's width and
    traffic (16 OREO tenants of 6,001,215 x 8, sudden_shift seed 7, alpha
    20, delta 10, P 16, window 80) with queries per tenant cut to
    ROUTER_QUERIES, behind the routing plane on one card.  (A) a 4-shard
    FleetRouter, unlimited, run_batched on decision_fused, four tenants
    migrated at half the stream: traces equal the unsharded fleet's; (B)
    ServeFrontend(batched=True) with bench_serving's OVERLOAD settings
    over a 4-shard router with K = 1 per shard: charge ledgers equal the
    same router's without the front end; (C) a ProcessShardSet of 4
    workers on the card (in a child process that never touches CUDA) with
    one cross-process migration and a tail of traffic: traces equal the
    inline router's doing the same.  Returns each arm's launches."""
    import numpy as np
    import tempfile
    import torch
    from repro_torch import core, engine, serve
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 8)
    sync(device)
    table_seconds = time.perf_counter() - t0
    lo = torch.stack([d.amin(0) for d in tables.values()]).amin(0).cpu()
    hi = torch.stack([d.amax(0) for d in tables.values()]).amax(0).cpu()
    lo, hi = lo.numpy(), hi.numpy()
    stream = core.make_drift_scenario("sudden_shift", lo, hi,
                                      num_tenants=tenants,
                                      queries_per_tenant=queries, seed=7)
    events = list(stream)
    emit("router_full", cell=ROUTER_CELL, tenants=tenants, rows=rows,
         columns=8, queries_per_tenant=queries,
         reduced={"queries_per_tenant": f"1500 -> {queries}"},
         shards=ROUTER_SHARDS, events=len(events),
         table_bytes=sum(d.numel() * 8 for d in tables.values()),
         table_seconds=table_seconds)

    def tenants_of(**kw):
        return {tid: oreo_tenant(tables[tid], 20.0, 10, 16, 0, 80, 40, **kw)
                for tid in stream.tenant_ids}

    runs = {}
    peak = (torch.cuda.max_memory_allocated if device.type == "cuda"
            else lambda *_: 0)

    # (A) migration under the unlimited scheduler.
    ref = engine.FleetEngine(tenants_of()).run_batched(
        events, compute="decision_fused")
    router = engine.FleetRouter(tenants_of(), num_shards=ROUTER_SHARDS)
    timer = ShardTimer(router, device)
    moved = stream.tenant_ids[::tenants // 4][:4]

    def arm_a():
        half = len(events) // 2
        for ev in events[:half]:
            router.submit(ev)
        router.drain(batched=True, compute="decision_fused")
        for tid in moved:
            src = router.shard_of(tid)
            router.migrate_tenant(tid, next(s for s in router.shard_ids
                                            if s != src))
        for ev in events[half:]:
            router.submit(ev)
        router.drain(batched=True, compute="decision_fused")
        return router.result()

    res, launches, wall = router_arm("A", arm_a, device)
    if tenant_traces(res) != tenant_traces(ref) or res.num_reorgs <= 0:
        raise AssertionError(f"{ROUTER_CELL} A: the migrated router's traces "
                             f"differ from the unsharded fleet's, or no "
                             f"tenant reorganized")
    runs["A-migration"] = launches
    emit("router_full", cell=ROUTER_CELL, arm="A: 4 shards, unlimited, "
         "4 tenants migrated", migrated=moved, traces_equal_unsharded=True,
         events_per_second=len(events) / wall,
         critical_path_events_per_second=len(events) / timer.critical,
         serial_events_per_second=len(events) / timer.serial,
         run_wall_seconds=wall, moves=res.num_reorgs,
         total_cost=res.total_cost, launches=launches,
         peak_bytes=peak(device), placement=router.placement())
    del ref, router, res
    if device.type == "cuda":
        release(device)

    # (B) the front end under overload, and the same router without it.
    k1 = engine.SchedulerSpec.k_concurrent(1)
    plain = engine.FleetRouter(tenants_of(), num_shards=ROUTER_SHARDS,
                               scheduler=k1)
    timer = ShardTimer(plain, device)
    want, want_launches, want_wall = router_arm(
        "B without the front end",
        lambda: plain.run_batched(events, compute="decision_fused"), device)
    want_critical = timer.critical
    fronted = engine.FleetRouter(tenants_of(), num_shards=ROUTER_SHARDS,
                                 scheduler=k1)
    timer = ShardTimer(fronted, device)
    fe = serve.ServeFrontend(fronted, serve.FrontendConfig(
        batched=True, compute="decision_fused", record_latency=True,
        **SERVING_OVERLOAD))
    got, launches, wall = router_arm("B", lambda: fe.run(events), device)
    stats = fe.stats()
    ledger = all(got.per_tenant[t].reorg_indices
                 == want.per_tenant[t].reorg_indices
                 and np.array_equal(got.per_tenant[t].state_seq,
                                    want.per_tenant[t].state_seq)
                 and len(got.per_tenant[t].query_costs) == queries
                 for t in stream.tenant_ids)
    if not (ledger and stats["breaker"]["opens"]):
        raise AssertionError(f"{ROUTER_CELL} B: the front end changed a "
                             f"charge ledger or dropped a query, or its "
                             f"breaker never opened")
    lat = np.asarray(fe.latencies) * 1e3
    runs["B-frontend"] = launches
    runs["B-router"] = want_launches
    emit("router_full", cell=ROUTER_CELL, arm="B: ServeFrontend(batched) "
         "over 4 shards, K=1 each, queue 48 block",
         charge_ledgers_equal_router=True, breaker=stats["breaker"],
         shed_count=stats["shed_count"],
         shed_attempts=stats["shed_attempts"], cache=stats["cache"],
         p50_ms=float(np.percentile(lat, 50)),
         p99_ms=float(np.percentile(lat, 99)),
         events_per_second=len(events) / wall,
         critical_path_events_per_second=len(events) / timer.critical,
         run_wall_seconds=wall, launches=launches,
         router_events_per_second=len(events) / want_wall,
         router_critical_path_events_per_second=len(events) / want_critical,
         router_launches=want_launches, moves=got.num_reorgs,
         swaps_deferred=got.swaps_deferred,
         router_swaps_deferred=want.swaps_deferred, peak_bytes=peak(device))
    del fronted, fe, got
    if not processes:
        return runs

    # (C) process shards: the same K = 1 router (plain) over 4 workers,
    # then one migration and a tail of traffic, inline and over processes.
    tid = stream.tenant_ids[0]
    dst = next(s for s in plain.shard_ids if s != plain.shard_of(tid))
    tail = core.make_drift_scenario("sudden_shift", lo, hi,
                                    num_tenants=tenants,
                                    queries_per_tenant=extra, seed=8)
    plain.migrate_tenant(tid, dst)
    after = plain.run_batched(tail, compute="decision_fused")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spec = Path(tmp) / "arm_c.json"
        spec.write_text(json.dumps({
            "lo": lo.tolist(), "hi": hi.tolist(), "tenants": tenants,
            "rows": rows, "queries": queries, "extra": extra,
            "shards": ROUTER_SHARDS, "migrate": tid, "to": dst,
            "device": device.type}))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--process-arm", str(spec)],
                              capture_output=True, text=True, timeout=600)
        child_seconds = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"{ROUTER_CELL} C: the process arm failed "
                                 f"({proc.returncode}):\n{proc.stderr}")
        import pickle
        with open(str(spec) + ".out", "rb") as f:
            out = pickle.load(f)
    def counters(res):
        return (tenant_traces(res), res.ticks, res.swaps_deferred,
                res.deferred_ticks, res.scheduler_stats)

    same = (out["trace"] == counters(want)
            and out["trace_after_migration"] == counters(after)
            and out["placement"] == plain.placement())
    if not same or out["parent_cuda_initialized"]:
        raise AssertionError(f"{ROUTER_CELL} C: the process shards' traces "
                             f"differ from the inline router's, or their "
                             f"parent initialized CUDA")
    launches = out["launches"]
    if device.type == "cuda" and not (launches["decision_fused"]
                                      and launches["pruning"]):
        raise AssertionError(f"{ROUTER_CELL} C: the workers did not launch "
                             f"decision_fused and pruning: {launches}")
    runs["C-processes"] = launches
    n = len(events) + len(tail)
    drain = sum(out["drain_seconds"])
    emit("router_full", cell=ROUTER_CELL, arm="C: ProcessShardSet, 4 "
         "workers on the card, 1 migration", migrated={tid: dst},
         traces_equal_inline_router=True,
         parent_cuda_initialized=out["parent_cuda_initialized"],
         spawn_seconds=out["spawn_seconds"],
         migration_seconds=out["migration_seconds"],
         drain_seconds=out["drain_seconds"],
         events_per_second=n / drain,
         critical_path_events_per_second=n / drain,
         worker_max_memory_allocated=out["worker_max_memory_allocated"],
         child_process_seconds=child_seconds, launches=launches,
         card=card_line() if device.type == "cuda" else None)
    return runs


# ---------------------------------------------------------------------------
# The forecast plane
# ---------------------------------------------------------------------------

FORECAST_CELL = "fleet16-sf1-forecast-cyclic_diurnal"
FORECAST_QUERIES = 400        # BENCH_forecast.json's 1,500, cut for the
#                               whole script's time (the training phases)
FORECAST_SCENARIO_SEED = 7    # benchmarks/bench_forecast.py: bench_cell seed
FORECAST_WORKERS = 4          # the spawned processes of ingest_parity's
#                               file section, reorg_parity, router_parity,
#                               fleet_parity and forecast_parity
FORECAST_LABELS = ("unlimited", "k1", "bucket")
#: The scenarios without pre-positions whose unlimited full-section row
#: forecast_parity runs (all eight before the family phases; the five
#: ingest scenarios' rows are cut for the whole script's time).
FORECAST_FULL_UNLIMITED = ("sudden_shift", "flash_crowd", "template_churn")
#: The full section's rows run on run_batched, whose traces are run's bit
#: for bit (the smoke section, the churn fleet and forecast_full's arm C
#: hold that): it primes each event's estimate from the pass's one launch
#: where ``run`` launches a scan per event, about a third of a row's time
#: on the card.
FORECAST_FULL_LANE = "decision_fused"
#: BENCH_forecast.json's fields that do not depend on the machine.
FORECAST_FIELDS = ("scenario", "family", "forecastable", "scheduler",
                   "tenants", "reactive_total", "forecast_total",
                   "cost_ratio", "reactive_reorgs", "forecast_reorgs",
                   "prepositions", "grown_admitted", "forecasts",
                   "forecast_accuracy")


def forecast_schedulers(section: str) -> dict:
    """benchmarks/bench_forecast.py:149-166's schedulers, by label: the
    smoke config's token bucket (0.005, capacity 1, empty) or the full
    config's (0.002, capacity 2)."""
    from repro_torch import engine
    return {"unlimited": engine.UnlimitedScheduler,
            "k1": lambda: engine.KConcurrentScheduler(1),
            "bucket": (lambda: engine.TokenBucketScheduler(
                rate=0.005, capacity=1.0, initial=0.0))
            if section == "smoke" else
            (lambda: engine.TokenBucketScheduler(rate=0.002, capacity=2.0))}


def forecast_tenant(data, alpha: float, delta: int, partitions: int,
                    forecast: bool, ingest: bool = False):
    """One tenant of benchmarks/bench_forecast.py (tenant_engine: window
    80, gen_every 40, seed 0, the arrival-order default layout), its policy
    wrapped in ForecastPolicy at the default ForecastConfig when
    ``forecast``; ingest scenarios compact on debt (threshold 1)."""
    from repro_torch import core, engine
    from repro_torch import forecast as fc
    cfg = core.OreoConfig(alpha=alpha, seed=0, delta=delta,
                          manager=core.LayoutManagerConfig(
                              target_partitions=partitions, window_size=80,
                              gen_every=40))
    policy = engine.OreoPolicy(data, core.build_default_layout(
        0, data, partitions), core.make_generator("qdtree"), cfg)
    if forecast:
        policy = fc.ForecastPolicy(policy, config=fc.ForecastConfig())
    return engine.LayoutEngine(
        policy, engine.InMemoryBackend(data), delta=cfg.delta,
        ingest=engine.IngestConfig(debt_threshold=1.0) if ingest else None)


def forecast_churn_tenant(t: int, rows: int = 3_000, device="cuda",
                          **engine_kw):
    """One tenant of tests/test_forecast_churn.py's churn fleet
    (forecast_engine: a rows x 6 table from default_rng(100 + t), alpha
    10, delta 5, seed 2, P 8, window 60, gen_every 30) whose ForecastPolicy
    grows eagerly: every forecast source, no gain, cost or alpha bar, one
    live grown state, retired after 30 idle queries.  Module level, so
    spawned shard workers can unpickle it; ``engine_kw`` reaches
    ``LayoutEngine``."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    from repro_torch import forecast as fc
    data = torch.as_tensor(np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(rows, 6)), device=device)
    cfg = core.OreoConfig(alpha=10.0, seed=2, delta=5,
                          manager=core.LayoutManagerConfig(
                              target_partitions=8, window_size=60,
                              gen_every=30))
    inner = engine.OreoPolicy(data, core.build_default_layout(0, data, 8),
                              core.make_generator("qdtree"), cfg)
    policy = fc.ForecastPolicy(
        inner, config=fc.ForecastConfig(
            grow=True, max_grown=1, grow_retire_after=30,
            grow_sources=("period", "trend", "adversarial")),
        grower=fc.QdTreeGrower(data, 8, min_queries=4, gain=0.0,
                               cost_floor=0.0, alpha=0.0, seed=103))
    return engine.LayoutEngine(policy, engine.InMemoryBackend(data),
                               delta=cfg.delta, **engine_kw)


def churn_bounds(rows: int, tenants: int = 3) -> tuple:
    """The column bounds the churn fleet's streams are drawn over."""
    import numpy as np
    host = [np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(rows, 6)) for t in range(tenants)]
    return (np.min([d.min(0) for d in host], axis=0),
            np.max([d.max(0) for d in host], axis=0))


def forecast_digest(res) -> str:
    """A fleet run's trace and every tenant's ``info()``, hashed."""
    import hashlib
    import pickle
    return hashlib.sha256(pickle.dumps((fleet_trace(res), tuple(
        (tid, sorted(r.info.items())) for tid, r in res.per_tenant.items()))
    )).hexdigest()


def forecast_bench_cells(job: dict, device) -> dict:
    """One scenario of benchmarks/bench_forecast.py at ``job``'s config,
    both arms under each of ``job``'s schedulers, with FleetEngine.run (or
    run_batched on ``job["lane"]``, bitwise the same): the benchmark's
    row fields (rounded as bench_forecast.py:82-101 rounds them) and each
    arm's digest."""
    import numpy as np
    import torch
    from repro_torch import core, engine
    cfg, scenario = job["config"], job["scenario"]
    host = {f"t{t}": np.random.default_rng(FLEET_SEED + t).uniform(
        0, 100, size=(cfg["rows"], cfg["columns"]))
        for t in range(cfg["tenants"])}
    lo = np.min([d.min(0) for d in host.values()], axis=0)
    hi = np.max([d.max(0) for d in host.values()], axis=0)
    data = {tid: torch.as_tensor(d, device=device) for tid, d in host.items()}
    info = core.workload.SCENARIO_INFO[scenario]
    maker = (core.make_drift_scenario if info.family == "drift"
             else core.make_ingest_scenario)
    fs = maker(scenario, lo, hi, num_tenants=cfg["tenants"],
               queries_per_tenant=cfg["queries_per_tenant"],
               seed=FORECAST_SCENARIO_SEED)
    rows, digests = {}, {}
    for label in job["schedulers"]:
        factory = forecast_schedulers(job["section"])[label]
        arms = {}
        for forecast in (False, True):
            fleet = engine.FleetEngine(
                {tid: forecast_tenant(data[tid], cfg["alpha"], cfg["delta"],
                                      cfg["partitions"], forecast,
                                      ingest=info.family == "ingest")
                 for tid in fs.tenant_ids}, factory())
            arms[forecast] = (fleet.run_batched(fs, compute=job["lane"])
                              if job["lane"] else fleet.run(fs))
        reactive, forecasted = arms[False], arms[True]
        infos = [forecasted.per_tenant[tid].info for tid in fs.tenant_ids]
        checks = sum(i["forecast_checks"] for i in infos)
        hits = sum(i["forecast_hits"] for i in infos)
        rows[label] = {
            "scenario": scenario, "family": info.family,
            "forecastable": info.forecastable,
            "scheduler": reactive.scheduler, "tenants": len(fs.tenant_ids),
            "reactive_total": round(reactive.total_cost, 3),
            "forecast_total": round(forecasted.total_cost, 3),
            "cost_ratio": round(reactive.total_cost
                                / forecasted.total_cost, 6),
            "reactive_reorgs": reactive.num_reorgs,
            "forecast_reorgs": forecasted.num_reorgs,
            "prepositions": sum(i["prepositions"] for i in infos),
            "grown_admitted": sum(i["grown_admitted"] for i in infos),
            "forecasts": sum(i["forecasts"] for i in infos),
            "forecast_accuracy": round(hits / checks, 3) if checks else None}
        digests[label] = (forecast_digest(reactive),
                          forecast_digest(forecasted))
    return {"rows": rows, "digests": digests}


def forecast_churn_runs(job: dict, device) -> dict:
    """(c) The churn fleet (3 tenants, 120 queries each) under one drift
    scenario and each scheduler: ``run``, and on the card also
    run_batched on both lanes and the unbounded incremental fleet on both
    planner lanes (every migration must close on alpha at once)."""
    from repro_torch import core, engine
    lo, hi = churn_bounds(job["rows"])
    fs = core.make_drift_scenario(job["scenario"], lo, hi, num_tenants=3,
                                  queries_per_tenant=120, seed=7)
    modes = ["run"]
    if job["all_modes"]:
        modes += ["fleet_scan", "decision_fused", "incremental/move_score",
                  "incremental/decision_fused"]
    digests, admitted, migrations = {}, {}, 0
    for label, factory in fleet_schedulers().items():
        for mode in modes:
            kw = ({"incremental": True,
                   "reorg_compute": mode.split("/")[1]}
                  if mode.startswith("incremental") else {})
            fleet = engine.FleetEngine(
                {tid: forecast_churn_tenant(int(tid[1:]), job["rows"],
                                            device, **kw)
                 for tid in fs.tenant_ids}, factory())
            res = (fleet.run_batched(fs, compute=mode)
                   if mode in ("fleet_scan", "decision_fused")
                   else fleet.run(fs))
            digests[f"{label}/{mode}"] = forecast_digest(res)
            admitted[f"{label}/{mode}"] = sum(
                r.info["grown_admitted"] for r in res.per_tenant.values())
            for tid in fleet.tenant_ids:
                ex = fleet.tenant(tid).reorg_executor
                for m in (ex.migrations if ex is not None else ()):
                    migrations += 1
                    if not (m.completed_at == m.begun_at
                            and m.charged == m.alpha):
                        raise AssertionError(
                            f"forecast_parity: {job['scenario']} {label} "
                            f"{mode} {tid}: a migration did not close on "
                            f"alpha at once")
    return {"digests": digests, "admitted": admitted,
            "migrations": migrations}


def forecast_shard_checks(job: dict, device) -> dict:
    """(c)'s checks that spawn or save engines: the saved forecast engine
    and the process shards (whose workers' launches count here)."""
    spool = forecast_spool_check(device, job["rows"])
    shards = forecast_process_shards(device, job["rows"])
    return {"spool": spool, "shards": shards,
            "worker_launches": shards.pop("launches")}


def forecast_job(job: dict) -> dict:
    """One forecast_parity job, run in a spawned worker process on the
    device it names; returns its results, seconds and this job's kernel
    launches (none may come from a CPU job)."""
    import torch
    torch.set_num_threads(1)
    device = torch.device(job["device"])
    counters = kernel_counters()
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    run = {"bench": forecast_bench_cells, "churn": forecast_churn_runs,
           "shards": forecast_shard_checks}[job["kind"]]
    out = run(job, device)
    sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: c.launches - before[k]
                       + out.get("worker_launches", {}).get(k, 0)
                       for k, c in counters.items()}
    return out


def forecast_spool_check(device, rows: int = 3_000) -> dict:
    """A churn tenant with a live grown state, saved mid-run with
    torch.save and loaded again (the file a process-shard migration
    writes): the grower's table is the manager's and the backend's, one
    storage in a file of about one table, and the loaded engine's
    continuation equals the uninterrupted one's."""
    import io
    import torch
    from repro_torch import core
    lo, hi = churn_bounds(rows)
    fs = core.make_drift_scenario("cyclic_diurnal", lo, hi, num_tenants=1,
                                  queries_per_tenant=300, seed=7)
    queries = fs.per_tenant[fs.tenant_ids[0]].queries
    straight = forecast_churn_tenant(0, rows, device)
    for q in queries:
        straight.step_fast(q)
    resumed = forecast_churn_tenant(0, rows, device)
    cut = None
    for k, q in enumerate(queries):
        resumed.step_fast(q)
        if k >= 100 and resumed.policy._grown:
            cut = k
            break
    if cut is None:
        raise AssertionError("forecast_parity: the churn tenant held no "
                             "grown state to save")
    live = list(resumed.policy._grown)
    buf = io.BytesIO()
    torch.save(resumed, buf)
    size = buf.tell()
    buf.seek(0)
    resumed = torch.load(buf, weights_only=False)
    pol = resumed.policy
    data = pol.inner.manager.data
    one_storage = (pol.grower.data is data and resumed.backend.data is data
                   and data.device.type == device.type)
    for q in queries[cut + 1:]:
        resumed.step_fast(q)
    same = (run_trace(straight.result()) == run_trace(resumed.result())
            and straight.result().info == resumed.result().info)
    table_bytes = data.numel() * data.element_size()
    if not (one_storage and same and live and size < 2 * table_bytes):
        raise AssertionError(f"forecast_parity: the saved forecast engine "
                             f"is not one table ({size} bytes for a "
                             f"{table_bytes}-byte table, one storage "
                             f"{one_storage}) or its continuation differs "
                             f"({same})")
    return {"saved_at": cut, "live_grown": live, "file_bytes": size,
            "table_bytes": table_bytes, "one_storage": one_storage,
            "continuation_equal": same}


def forecast_process_shards(device, rows: int = 3_000) -> dict:
    """(c) The churn fleet (cyclic_diurnal, 3 tenants) behind 2 process
    shards on the card, one tenant migrated cross-process while it holds
    a live grown state: traces and infos equal an inline router doing the
    same, and the parent opens no engine file.  Returns the workers'
    launches."""
    import functools
    import torch
    from repro_torch import core, engine
    from repro_torch.launch import shard_host
    lo, hi = churn_bounds(rows)
    fs = core.make_drift_scenario("cyclic_diurnal", lo, hi, num_tenants=3,
                                  queries_per_tenant=120, seed=7)
    events = list(fs)
    chunk = 30
    router = engine.FleetRouter(
        {tid: forecast_churn_tenant(int(tid[1:]), rows, device)
         for tid in fs.tenant_ids}, num_shards=2)
    moved = cut = None
    for start in range(0, len(events), chunk):
        for ev in events[start:start + chunk]:
            router.submit(ev)
        router.drain(batched=True, compute="decision_fused")
        if moved is None and start >= len(events) // 3:
            moved = next((tid for tid in fs.tenant_ids
                          if router.tenant(tid).policy._grown), None)
            if moved is not None:
                cut = start + chunk
                dst = next(s for s in router.shard_ids
                           if s != router.shard_of(moved))
                live = list(router.tenant(moved).policy._grown)
                router.migrate_tenant(moved, dst)
    if moved is None:
        raise AssertionError("forecast_parity: no churn tenant held a live "
                             "grown state to migrate")
    want = router.result()
    factories = {tid: functools.partial(forecast_churn_tenant, int(tid[1:]),
                                        rows, device.type)
                 for tid in fs.tenant_ids}
    opened = []
    real_load = torch.load

    def recorded_load(*args, **kw):
        opened.append(args[:1])
        return real_load(*args, **kw)
    t0 = time.perf_counter()
    torch.load = recorded_load
    try:
        with shard_host.ProcessShardSet(factories, num_shards=2) as procs:
            spawn = time.perf_counter() - t0
            for h in (procs.host(s) for s in procs.shard_ids):
                h.kernel_launches(reset=True)
            for start in range(0, len(events), chunk):
                for ev in events[start:start + chunk]:
                    procs.submit(ev)
                procs.drain(batched=True, compute="decision_fused")
                if start + chunk == cut:
                    procs.migrate_tenant(moved, dst)
            got = procs.result()
            launches = [procs.host(s).kernel_launches()
                        for s in procs.shard_ids]
            placement = {tid: procs.shard_of(tid) for tid in factories}
    finally:
        torch.load = real_load
    same = (tenant_traces(got) == tenant_traces(want)
            and {t: r.info for t, r in got.per_tenant.items()}
            == {t: r.info for t, r in want.per_tenant.items()}
            and placement == router.placement())
    admitted = sum(r.info["grown_admitted"] for r in got.per_tenant.values())
    if not (same and admitted and not opened):
        raise AssertionError(f"forecast_parity: the process shards differ "
                             f"from the inline router ({same}), grew "
                             f"nothing ({admitted}) or the parent opened an "
                             f"engine file ({opened})")
    return {"migrated": moved, "to": dst, "after_event": cut,
            "live_grown_at_migration": live, "grown_admitted": admitted,
            "equal_to_inline_router": same, "spawn_seconds": spawn,
            "parent_engine_loads": len(opened),
            "launches": {k: sum(n[k] for n in launches)
                         for k in launches[0]}}


def forecast_jobs(device, bench: dict, churn_rows: int) -> list:
    """forecast_parity's jobs, the longest first: (c)'s saved engine and
    process shards, (b) the full section's rows on the card, (a) the smoke
    section on the card and the CPU, (c)'s churn fleet on the card (every
    mode) and the CPU (``run``)."""
    cfg = {k: bench["config"][k] for k in (
        "tenants", "rows", "columns", "queries_per_tenant", "alpha", "delta",
        "partitions")}
    smoke = {k: bench["forecast_smoke"]["config"][k] for k in cfg}
    scenarios = list(bench["forecast_vs_reactive"])
    sides = (("card", device.type), ("cpu", "cpu"))
    jobs = [{"kind": "shards", "scenario": None, "rows": churn_rows,
             "side": "card", "device": device.type}]
    for scenario in scenarios:
        labels = (FORECAST_LABELS if scenario in bench["forecastable_scenarios"]
                  else FORECAST_LABELS[:1]
                  if scenario in FORECAST_FULL_UNLIMITED else ())
        jobs += [{"kind": "bench", "section": "full", "config": cfg,
                  "scenario": scenario, "schedulers": [label],
                  "lane": FORECAST_FULL_LANE, "side": "card",
                  "device": device.type} for label in labels]
    for side, dev in sides:
        jobs += [{"kind": "bench", "section": "smoke", "config": smoke,
                  "scenario": s, "schedulers": list(FORECAST_LABELS),
                  "lane": None, "side": side, "device": dev}
                 for s in scenarios]
    for side, dev in sides:
        jobs += [{"kind": "churn", "scenario": s, "rows": churn_rows,
                  "all_modes": side == "card", "side": side, "device": dev}
                 for s in FLEET_SCENARIOS]
    return jobs


def start_forecast_parity(device, pool, workers: int = FORECAST_WORKERS,
                          churn_rows: int = 3_000, bench=None):
    """Submits forecast_parity's jobs now to ``pool``, ``workers`` spawned
    processes (the loops are the host's), so they run beside the parity
    phases, which time nothing; returns a function that waits for them and
    runs phase_forecast_parity's checks."""
    bench = bench or json.loads((ROOT / "BENCH_forecast.json").read_text())
    t0 = time.perf_counter()
    jobs = forecast_jobs(device, bench, churn_rows)
    futures = [pool.submit(forecast_job, job) for job in jobs]

    def result() -> dict:
        t1 = time.perf_counter()
        results = [f.result() for f in futures]
        return phase_forecast_parity(device, bench, jobs, results, workers,
                                     t0, waited=time.perf_counter() - t1)
    return result


def parity_job(name: str, device_type: str) -> dict:
    """Runs the phase ``name`` (reorg_parity or router_parity) whole in a
    spawned worker, on one thread; its lines go to the shared stdout.
    Returns its card launches and seconds."""
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    run = {"reorg_parity": phase_reorg_parity,
           "router_parity": phase_router_parity}[name]
    return {"launches": run(torch.device(device_type)),
            "seconds": time.perf_counter() - t0}


def start_parity_job(device, pool, name: str):
    """Submits parity_job(name) now to ``pool``; returns a function that
    waits for it and gives its result."""
    return pool.submit(parity_job, name, device.type).result


def start_host_pool(workers: int = FORECAST_WORKERS):
    """The spawned processes that run ingest_parity's file section,
    router_parity and reorg_parity, fleet_parity's and forecast_parity's
    jobs, in the order they are submitted."""
    import concurrent.futures as cf
    import multiprocessing as mp
    return cf.ProcessPoolExecutor(max_workers=workers,
                                  mp_context=mp.get_context("spawn"))


def phase_forecast_parity(device, bench: dict, jobs: list, results: list,
                          workers: int, t0: float, waited: float) -> dict:
    """(a) BENCH_forecast.json's forecast_smoke section in full, card ==
    file and card == CPU; (b) the full section's rows with pre-positions
    (gradual_drift and cyclic_diurnal, every scheduler) and the unlimited
    row of FORECAST_FULL_UNLIMITED's scenarios, card == file field for
    field; (c) the churn fleet: run_batched on both lanes and the
    incremental fleet on both planner lanes equal run, card == CPU, then a
    cross-process migration of a tenant holding a live grown state equal
    to the inline router, and a saved forecast engine that stays one
    table.  ``results`` are forecast_job's for ``jobs``, which ran in
    ``workers`` spawned processes from ``t0`` on (start_forecast_parity);
    ``waited`` is how long this process waited for them.  Returns the
    card's launches."""
    checks = results[0]
    emit("forecast_parity", case="torch.save of a forecast engine with a "
         "live grown state", **checks["spool"])
    emit("forecast_parity", case="ProcessShardSet, 2 shards, a grown-state "
         "tenant migrated", **checks["shards"],
         launches_over_workers=checks["worker_launches"],
         seconds=checks["seconds"])
    launched = dict.fromkeys(results[0]["launches"], 0)
    for job, out in zip(jobs, results):
        for k, n in out["launches"].items():
            if job["side"] == "cpu" and n:
                raise AssertionError("forecast_parity: a CPU job launched a "
                                     "kernel")
            launched[k] += n
    by = {(j["kind"], j.get("section"), j["scenario"], j["side"],
           tuple(j.get("schedulers", ()))): r for j, r in zip(jobs, results)}
    card, cpu = "card", "cpu"

    # (b) the full section's rows, field for field.
    want = {(r["scenario"], label): r for r, label in zip(
        bench["results"], FORECAST_LABELS * len(bench["forecast_vs_reactive"]))}
    bad, ran = [], []
    for job, out in zip(jobs, results):
        if job["kind"] != "bench" or job["section"] != "full":
            continue
        for label, got in out["rows"].items():
            ref = {k: want[job["scenario"], label][k] for k in FORECAST_FIELDS}
            if got != ref:
                bad.append((job["scenario"], label, got, ref))
            ran.append({**got, "label": label,
                        "seconds_on_card": out["seconds"]})
    emit("forecast_parity", case="BENCH_forecast.json full section",
         drive=f"run_batched({FORECAST_FULL_LANE})",
         rows_run=len(ran), rows=ran, equal_to_file=not bad,
         why="every scheduler of the two scenarios with pre-positions, the "
             "unlimited row of the three other drift scenarios: the "
             "script's time limit")
    # (a) the smoke section: card == file and card == CPU.
    smoke = bench["forecast_smoke"]["forecast_vs_reactive"]
    ratios, same = {}, True
    for scenario in smoke:
        key = ("bench", "smoke", scenario)
        on_card = by[key + (card, FORECAST_LABELS)]
        on_cpu = by[key + (cpu, FORECAST_LABELS)]
        ratios[scenario] = {label: row["cost_ratio"]
                            for label, row in on_card["rows"].items()}
        same &= (on_card["digests"] == on_cpu["digests"]
                 and on_card["rows"] == on_cpu["rows"])
    if ratios != smoke:
        bad.append(("forecast_smoke", ratios, smoke))
    if not same:
        bad.append(("forecast_smoke: card traces differ from the CPU's",))
    emit("forecast_parity", case="BENCH_forecast.json forecast_smoke",
         forecast_vs_reactive=ratios, equal_to_file=ratios == smoke,
         card_equals_cpu=same)
    # (c) the churn fleet: every mode == run, card == CPU.
    churn = {}
    for scenario in FLEET_SCENARIOS:
        on_card = by[("churn", None, scenario, card, ())]
        on_cpu = by[("churn", None, scenario, cpu, ())]
        for key, digest in on_card["digests"].items():
            label, mode = key.split("/", 1)
            if digest != on_card["digests"][f"{label}/run"]:
                bad.append(("churn", scenario, key, "differs from run"))
        for key, digest in on_cpu["digests"].items():
            if on_card["digests"][key] != digest:
                bad.append(("churn", scenario, key, "card differs from CPU"))
        churn[scenario] = {"grown_admitted": on_card["admitted"],
                           "incremental_migrations": on_card["migrations"]}
    modes = {k.split("/", 1)[1] for r in churn.values()
             for k in r["grown_admitted"]}
    for mode in modes:
        if not sum(n for r in churn.values()
                   for k, n in r["grown_admitted"].items()
                   if k.endswith("/" + mode)):
            bad.append(("churn", mode, "grew nothing"))
    emit("forecast_parity", case="churn fleet: run_batched x 2 lanes, "
         "incremental x 2 planners == run, card == CPU", scenarios=churn,
         modes=sorted(modes), bitwise_equal=not bad)
    if bad:
        raise AssertionError(f"forecast_parity: {bad[:5]}")
    if device.type == "cuda" and not all(launched[k] for k in (
            "pruning", "fleet_scan", "decision_fused", "move_score")):
        raise AssertionError(f"forecast_parity: the card runs did not launch "
                             f"every kernel of the forecast paths: "
                             f"{launched}")
    emit("forecast_parity", jobs=len(jobs), workers=workers,
         job_seconds=sum(r["seconds"] for r in results),
         launches_card=launched, seconds=time.perf_counter() - t0,
         waited_seconds=waited)
    return launched


class PruningAudit:
    """Checks the first and then every ``every``-th pruning call of a run,
    inside the run: the scan the main path's own launch returned against
    the plain version on CPU copies of the same bounds and zone-map rows.
    It wraps the kernel's entry as the engine's compute module sees it and
    launches nothing itself."""

    def __init__(self, every: int, name: str):
        import types
        from repro_torch.engine import compute
        self.compute, self.every, self.name = compute, every, name
        self.calls = self.checked = 0
        self._module = compute.pruning
        inner = compute.pruning.scan_matrix

        def scan_matrix(q_lo, q_hi, p_min, p_max, *args, **kw):
            got = inner(q_lo, q_hi, p_min, p_max, *args, **kw)
            self.calls += 1
            if (self.calls - 1) % self.every == 0:
                self.check(q_lo, q_hi, p_min, p_max, got)
                self.checked += 1
            return got
        compute.pruning = types.SimpleNamespace(scan_matrix=scan_matrix)

    def close(self) -> None:
        self.compute.pruning = self._module

    def check(self, q_lo, q_hi, p_min, p_max, got) -> None:
        import torch
        from repro_torch.kernels.pruning import ref
        want = ref.scan_matrix(q_lo.cpu(), q_hi.cpu(), p_min.cpu(),
                               p_max.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{self.name}: the pruning kernel's scan of "
                                 f"call {self.calls} differs from the plain "
                                 f"version")


class ForecastMeter:
    """Seconds every tenant's ForecastPolicy spends outside its inner
    policy's ``decide``, and its grower's proposals and the qd-tree builds
    inside them (each ends in a copy to the host, so the time is the
    device's too).  It wraps the instances' methods and launches
    nothing."""

    def __init__(self, fleet):
        from repro_torch.core import qdtree
        self.qdtree, self._build = qdtree, qdtree.build_qdtree_layout
        self.seconds = {"decide": 0.0, "inner": 0.0, "propose": 0.0,
                        "build": 0.0}
        self.builds = 0
        self._proposing = False
        for tid in fleet.tenant_ids:
            policy = fleet.tenant(tid).policy
            if not hasattr(policy, "forecaster"):
                continue
            policy.decide = self._timed(policy.decide, "decide")
            policy.inner.decide = self._timed(policy.inner.decide, "inner")
            if policy.grower is not None:
                policy.grower.propose = self._timed(policy.grower.propose,
                                                    "propose")
        qdtree.build_qdtree_layout = self._built

    def close(self) -> None:
        self.qdtree.build_qdtree_layout = self._build

    def _timed(self, inner, key: str):
        def call(*args):
            t0 = time.perf_counter()
            self._proposing |= key == "propose"
            try:
                return inner(*args)
            finally:
                self._proposing &= key != "propose"
                self.seconds[key] += time.perf_counter() - t0
        return call

    def _built(self, *args, **kw):
        if not self._proposing:
            return self._build(*args, **kw)
        t0 = time.perf_counter()
        try:
            return self._build(*args, **kw)
        finally:
            self.seconds["build"] += time.perf_counter() - t0
            self.builds += 1

    def fields(self) -> dict:
        s = self.seconds
        return {"forecast_seconds": s["decide"] - s["inner"],
                "inner_decide_seconds": s["inner"],
                "grower_propose_seconds": s["propose"],
                "grower_build_seconds": s["build"],
                "grower_builds": self.builds}


def forecast_arm(label: str, fleet, stream, lane, device) -> tuple:
    """One arm of the forecast cell: counts zeroed just before the run and
    read just after; the first and every 50th fleet pass and every 100th
    pruning call audited against the plain versions; ``lane`` None drives
    ``run``, else ``run_batched`` on that lane.  Returns (result, line
    fields)."""
    import numpy as np
    import torch
    counters = kernel_counters()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for c in counters.values():
        c.launches = 0
    meter = ForecastMeter(fleet)
    passes = ScanAudit(every=50)
    scans = PruningAudit(every=100, name=f"{FORECAST_CELL} {label}")
    events = len(stream)
    t0 = time.perf_counter()
    try:
        res = (fleet.run(stream) if lane is None
               else fleet.run_batched(stream, compute=lane))
        sync(device)
    finally:
        meter.close()
        passes.close()
        scans.close()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for tid, r in res.per_tenant.items():
        costs = r.query_costs
        if not (np.isfinite(costs).all() and (costs >= 0).all()
                and (costs <= 1).all() and len(r.state_seq) == len(costs)):
            raise AssertionError(f"{FORECAST_CELL} {label}: {tid}'s trace "
                                 f"is malformed")
    if (passes.checked < -(-passes.calls // 50)
            or scans.checked < -(-scans.calls // 100)):
        raise AssertionError(f"{FORECAST_CELL} {label}: a pass or a pruning "
                             f"call went unaudited")
    if device.type == "cuda" and not (launches["pruning"] and (
            lane is None or launches[lane])):
        raise AssertionError(f"{FORECAST_CELL} {label}: the arm did not "
                             f"launch pruning and its lane: {launches}")
    infos = [r.info for r in res.per_tenant.values()]

    def total(key):
        return sum(i.get(key) or 0 for i in infos)
    checks = total("forecast_checks")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return res, {
        "lane": lane or "run", "events": events, "run_wall_seconds": wall,
        "events_per_second": events / wall,
        "decide_seconds": res.decide_seconds,
        "reorg_seconds": res.reorg_seconds,
        "serve_seconds": res.serve_seconds, **meter.fields(),
        "total_cost": res.total_cost, "query_cost": res.total_query_cost,
        "reorg_cost": res.total_reorg_cost, "moves": res.num_reorgs,
        "prepositions": total("prepositions"),
        "forecasts": total("forecasts"), "forecast_checks": checks,
        "forecast_accuracy": (total("forecast_hits") / checks
                              if checks else None),
        "grown_proposed": total("grown_proposed"),
        "grown_admitted": total("grown_admitted"),
        "launches": launches, "passes_scored": passes.calls,
        "passes_audited": passes.checked, "pruning_calls": scans.calls,
        "pruning_calls_audited": scans.checked, "peak_bytes": peak}


def phase_forecast_full(device, rows: int = SF1_ROWS, tenants: int = 16,
                        queries: int = FORECAST_QUERIES) -> dict:
    """The fleet16-sf1-forecast-cyclic_diurnal cell: BENCH_forecast.json's
    full config (alpha 20, delta 10, P 16, window 80, gen_every 40, the
    default ForecastConfig) at fleet16's width, 16 tenants of 6,001,215 x
    8 (default_rng(100 + t)), cyclic_diurnal seed 7, unlimited.  Arms: (A)
    reactive OREO, run_batched on decision_fused; (B) ForecastPolicy,
    ``run``; (C) ForecastPolicy, run_batched on decision_fused, bitwise
    (B); (D) gradual_drift under ForecastPolicy, ``run`` (trend forecasts,
    so grower proposals build qd-trees over the 6M-row tables).  Returns
    each arm's launches."""
    import torch
    from repro_torch import core, engine
    t0 = time.perf_counter()
    tables = fleet_tables(device, tenants, rows, 8)
    sync(device)
    table_seconds = time.perf_counter() - t0
    lo = torch.stack([d.amin(0) for d in tables.values()]).amin(0).cpu()
    hi = torch.stack([d.amax(0) for d in tables.values()]).amax(0).cpu()
    streams = {s: core.make_drift_scenario(
        s, lo.numpy(), hi.numpy(), num_tenants=tenants,
        queries_per_tenant=queries, seed=FORECAST_SCENARIO_SEED)
        for s in ("cyclic_diurnal", "gradual_drift")}
    emit("forecast_full", cell=FORECAST_CELL, tenants=tenants, rows=rows,
         columns=8, queries_per_tenant=queries,
         reduced=({"queries_per_tenant": f"1500 -> {queries}"}
                  if queries < 1500 else {}),
         alpha=20.0, delta=10, partitions=16, scheduler="unlimited",
         table_bytes=sum(d.numel() * 8 for d in tables.values()),
         table_seconds=table_seconds)
    arms = [("A", "reactive OREO, run_batched(decision_fused)", False,
             "cyclic_diurnal", "decision_fused"),
            ("B", "ForecastPolicy, run", True, "cyclic_diurnal", None),
            ("C", "ForecastPolicy, run_batched(decision_fused)", True,
             "cyclic_diurnal", "decision_fused"),
            ("D", "gradual_drift, ForecastPolicy, run", True,
             "gradual_drift", None)]
    runs, totals, digests = {}, {}, {}
    for label, what, forecast, scenario, lane in arms:
        fleet = engine.FleetEngine(
            {tid: forecast_tenant(tables[tid], 20.0, 10, 16, forecast)
             for tid in streams[scenario].tenant_ids},
            engine.UnlimitedScheduler())
        res, fields = forecast_arm(label, fleet, streams[scenario], lane,
                                   device)
        totals[label] = res.total_cost
        digests[label] = forecast_digest(res)
        runs[f"{label}-{scenario}"] = fields["launches"]
        extra = {}
        if label == "B":
            extra["reactive_over_forecast"] = totals["A"] / totals["B"]
        if label == "C":
            extra["bitwise_equal_B"] = digests["C"] == digests["B"]
        emit("forecast_full", cell=FORECAST_CELL, arm=f"{label}: {what}",
             scenario=scenario, **fields, **extra,
             card=card_line() if device.type == "cuda" else None)
        del fleet, res
        if device.type == "cuda":
            release(device)
    if digests["C"] != digests["B"]:
        raise AssertionError(f"{FORECAST_CELL}: run_batched's trace (C) "
                             f"differs from run's (B)")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         f"(env and kernel always run)")
    ap.add_argument("--queries", type=int, default=QUERIES,
                    help=f"full-width query count (>= {MIN_QUERIES}; the "
                         f"cell's is {FULL_QUERIES})")
    ap.add_argument("--process-arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process_arm:
        return process_arm(args.process_arm)
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _backend

    # The tpch-sf10 table is drawn on the host from now on.
    sf10_host = (start_sf10_inputs(torch.device("cuda", 0), args.queries)
                 if phases & {"full", "zorder_full"} else None)
    device = torch.device("cuda", 0)
    card = card_line()
    clock = [time.perf_counter()]
    phase_seconds = {}

    def done(name: str) -> None:
        now = time.perf_counter()
        phase_seconds[name] = now - clock[0]
        clock[0] = now
    _backend.build()
    try:
        zorder_sass = sass_memory_ops(_backend.build_dir() / "libzorder.so")
    except (OSError, subprocess.SubprocessError) as e:
        zorder_sass = {"not read": str(e)}
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         build_seconds=_backend.build_seconds,
         build_dir=str(_backend.build_dir().relative_to(ROOT)),
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "ptxas" in ln or "spill" in ln]
                for k, v in _backend.build_logs.items()},
         zorder_sass=zorder_sass)
    train_host = (start_train_parity_cpu() if "train_parity" in phases
                  else None)
    launch_host = start_launch_dryrun() if "launch" in phases else None
    done("env")

    kernels = {"pruning": phase_kernel(device), **phase_fleet_kernels(device),
               "move_score": phase_move_score_kernel(device),
               "flash_attention": phase_flash_kernel(device),
               "flash_attention_bwd": phase_flash_bwd_kernel(device),
               "zorder": phase_zorder_kernel(device)}
    release(device)
    done("kernel")
    # Work that times nothing runs from here beside the parity phases,
    # which time nothing either: ingest_parity's file section,
    # router_parity and reorg_parity whole, fleet_parity's and
    # forecast_parity's jobs in spawned processes, whose results are read
    # after the parity phases that stay here (train_parity among them, so
    # this process has work while the workers finish).  This process runs
    # on two threads meanwhile: the host's cores are the workers'.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    ingest_host = fleet_host = forecast_host = None
    pooled = {}
    if phases & {"fleet_parity", "reorg_parity", "ingest_parity",
                 "router_parity", "forecast_parity"}:
        pool = start_host_pool()
        if "ingest_parity" in phases:
            ingest_host = start_ingest_file(device, pool)
        for name in ("router_parity", "reorg_parity"):
            if name in phases:
                pooled[name] = start_parity_job(device, pool, name)
        if "fleet_parity" in phases:
            fleet_host = start_fleet_parity(device, pool)
        if "forecast_parity" in phases:
            forecast_host = start_forecast_parity(device, pool)
        pool.shutdown(wait=False)
    if "parity" in phases:
        phase_parity(device)
        done("parity")
    if "serve_parity" in phases:
        phase_serve_parity(device)
        release(device)
        done("serve_parity")
    if "zorder_parity" in phases:
        phase_zorder_parity(device)
        done("zorder_parity")
    if "ingest_parity" in phases:
        phase_ingest_parity(device, file_host=ingest_host)
        release(device)
        done("ingest_parity")
    if "train_parity" in phases:
        phase_train_parity(device, host=train_host)
        release(device)
        done("train_parity")
    for name, host in pooled.items():
        host()
        done(f"{name} (waiting for its worker)")
    if "fleet_parity" in phases:
        phase_fleet_parity(device, host=fleet_host)
        done("fleet_parity (waiting for its workers)")
    if "forecast_parity" in phases:
        forecast_host()
        done("forecast_parity (waiting for its workers)")
    torch.set_num_threads(threads)
    family_host = (start_family_parity_cpu() if "family_parity" in phases
                   else None)
    runs = {}
    if phases & {"full", "zorder_full"}:
        data, stream = sf10_host()
        torch.cuda.reset_peak_memory_stats(device)
        if "full" in phases:
            runs["tpch-sf10-oreo"] = {"pruning": phase_full(device, data,
                                                            stream)}
            release(device)
            done("full")
        if "zorder_full" in phases:
            runs["tpch-sf10-zorder"] = cell_zorder(device, data, stream)
            done("zorder_full")
        del data
        release(device)
    if "fleet_full" in phases:
        runs.update(phase_fleet_full(device))
        done("fleet_full")
    if "reorg_full" in phases:
        for arm, counts in cell_reorg(device).items():
            runs[f"fleet16-sf1-oreo-incr-bucket/{arm}"] = counts
        release(device)
        done("reorg_full")
    if "serve_full" in phases:
        runs[f"{SERVE_ARCH}-serve"] = {"flash_attention": cell_serve(device)}
        release(device)
        done("serve_full")
    if "ingest_full" in phases:
        for arm, counts in phase_ingest_full(device).items():
            runs[f"{INGEST_CELL}/{arm}"] = counts
        release(device)
        done("ingest_full")
    if "router_full" in phases:
        for arm, counts in phase_router_full(device).items():
            runs[f"{ROUTER_CELL}/{arm}"] = counts
        release(device)
        done("router_full")
    if "forecast_full" in phases:
        for arm, counts in phase_forecast_full(device).items():
            runs[f"{FORECAST_CELL}/{arm}"] = counts
        release(device)
        done("forecast_full")
    if phases & {"train_full", "launch"}:
        runs[f"{TRAIN_ARCH}-train"] = cell_train(
            device, launch="launch" in phases)
        release(device)
        done("train_full")
    if "family_parity" in phases:
        phase_family_parity(device, host=family_host)
        release(device)
        done("family_parity")
    if "family_full" in phases:
        runs.update(phase_family_full(device))
        release(device)
        done("family_full")
    if "launch" in phases:
        phase_launch(launch_host)
        done("launch")
    for name, summary in kernels.items():
        summary["launches"] = (sum(r.get(name, 0) for r in runs.values())
                               if runs else None)
    emit("timing", phase_seconds=phase_seconds,
         total_seconds=sum(phase_seconds.values()))
    emit("launches", per_main_path=runs)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
