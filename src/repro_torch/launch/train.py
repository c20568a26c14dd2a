"""End-to-end training driver; the counterpart of ``repro.launch.train``.

Runs a registered architecture (reduced ``--smoke`` configs on the CPU,
full configs on the card) with the OREO-managed data pipeline, AdamW,
per-layer remat, checkpoint/restart and metric logging, and writes
``train_summary.json`` into the checkpoint directory.  ``--device`` picks
the device (the card by default).  Every family runs: the transformer's,
RWKV-6 (``--arch rwkv6-3b``) and the Mamba-2 hybrid (``--arch
zamba2-2.7b``).

Stub frontends (``cfg.embed_input``) take embeddings: each step's tokens
become seeded (B, T, d_model) bf16 embeddings (:func:`stub_embeds`),
cached with the step's batch so a restart replays them.  They are drawn
from a ``torch.Generator`` seeded with the step, not from the reference's
``jax.random`` stream, which cannot be reproduced without JAX: the same
step gives the same embeddings on one device, not the reference's.  As in
the reference, the tokens are dropped, so the VLM (patch embeddings and
text tokens) does not run here.

Example (CPU, the smoke config, a few steps)::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-1.7b --smoke --steps 20 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.data import pipeline as dpipe
from repro_torch.models import build_model
from repro_torch.train import (FaultTolerantTrainer, OptimizerConfig,
                               TrainOptions, build_train_step,
                               init_train_state)


def scale_config(cfg, d_model=None, n_layers=None, vocab=None):
    """Optionally resize a config (e.g. ~100M params for the CPU driver)."""
    updates = {}
    if d_model:
        updates["d_model"] = d_model
        updates["d_ff"] = d_model * 4
    if n_layers:
        updates["n_layers"] = n_layers
    if vocab:
        updates["vocab"] = vocab
    return dataclasses.replace(cfg, **updates) if updates else cfg


def stub_embeds(shape, d_model: int, step: int,
                device: torch.device) -> torch.Tensor:
    """A stub frontend's embeddings for the tokens of one step: normal
    draws of ``shape + (d_model,)`` from a generator seeded with
    ``step`` on ``device``, rounded to bf16."""
    gen = torch.Generator(device=device).manual_seed(step)
    return torch.randn(tuple(shape) + (d_model,), generator=gen,
                       device=device).to(torch.bfloat16)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--corpus-docs", type=int, default=20_000)
    ap.add_argument("--oreo-alpha", type=float, default=80.0)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = scale_config(get_arch(args.arch, smoke=args.smoke),
                       d_model=args.d_model, n_layers=args.n_layers,
                       vocab=args.vocab)
    model = build_model(cfg, device=args.device)
    dev = model.device
    print(f"arch={cfg.name} family={cfg.family} params~{cfg.num_params():,} "
          f"device={dev}")
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    options = TrainOptions(microbatches=1)
    train_step = build_train_step(model, opt_cfg, options)
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             opt_cfg, options)

    # OREO-managed data pipeline over a synthetic corpus.
    meta, tokens = dpipe.synth_corpus(args.corpus_docs, doc_len=args.seq,
                                      vocab=cfg.vocab)
    recipe = dpipe.mixture_recipe(meta, total_steps=args.steps + 1)
    pipe = dpipe.OreoDataPipeline(meta, tokens, recipe,
                                  batch_size=args.batch, seq_len=args.seq,
                                  alpha=args.oreo_alpha, device=dev)
    pipe_iter = iter(pipe)
    cache = {}

    def batch_fn(step: int):
        # Deterministic per-step batches (replayable on restart).
        if step not in cache:
            cache[step] = {k: torch.as_tensor(v, device=dev)
                           for k, v in next(pipe_iter).items()}
            if cfg.embed_input:          # stub frontends take embeddings
                tok = cache[step].pop("tokens")
                cache[step]["embeds"] = stub_embeds(tok.shape, cfg.d_model,
                                                    step, dev)
        return cache[step]

    trainer = FaultTolerantTrainer(train_step, state, batch_fn,
                                   ckpt_dir=args.ckpt_dir,
                                   ckpt_every=args.ckpt_every)
    t0 = time.time()
    state = trainer.run(args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    losses = [m["loss"] for m in trainer.metrics_log]
    for m in trainer.metrics_log[::max(args.log_every, 1)]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"OREO pipeline: mean scan fraction "
          f"{pipe.stats.mean_scan_fraction:.3f}, reorgs {pipe.stats.reorgs}")
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "seconds": dt, "device": str(dev),
           "pipeline": dataclasses.asdict(pipe.stats)}
    with open(os.path.join(args.ckpt_dir, "train_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
