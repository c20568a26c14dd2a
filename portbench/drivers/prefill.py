"""Prefill cells: the port's slot loop (``serve.serve_requests``) serving
closed rounds of requests that each want one new token.

A round submits ``slots`` prompts whose tokens are drawn from the seed.
The lengths of a block of ``rounds`` rounds are the midpoint quantiles of
a clipped log-normal, and a round holds neighbouring lengths: the pool
batches its queue by length, since the loop takes one prompt length.
Blocks hold each round once, in an order drawn from the seed: every seed
offers the same work, in its own order, and a run that would need more
blocks than ``blocks`` fails.  Each prompt is padded on the left with
token 0 to the round's longest, rounded up to ``pad_to``, and the model
attends the padding as part of the prompt.  The next round is submitted
when the last completes.  Set-up makes the weights on the device and
warms up each round's padded length.  Every request yields two served
tokens: the prefill's greedy token (read from the prefill's logits as the
loop hands them on) and the one decode step's, which the loop records.
The check runs a sample of the completed requests, the longest among
them, through the reference and takes the widest gap by which a served
token's logit lies below the reference's best at its position.

Traffic keys: ``slots``, ``rounds``, ``blocks``, ``median``, ``sigma``,
``min_len``, ``max_len``, ``pad_to``, ``check_requests``,
``traced_units``, ``limits``.
"""
from __future__ import annotations

import gc
import math

import numpy as np
import torch

from portbench import generate, harness


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from repro_torch.models import build_model, layers
        cfg, mix = cell.config, cell.mix
        self.cell, self.device, self.spans = cell, device, spans
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.traced_units = mix["traced_units"]
        self.slots = mix["slots"]
        self.arch = cell.model()
        with spans("setup.weights"):
            self.model = build_model(self.arch.arch_config(cfg), device)
            self.params = self.arch.port_params(
                self.arch.make_weights(cfg, harness.torch_seed(seed, 0),
                                       device), cfg)
        rounds = generate.length_rounds(generate.prompt_lengths(
            mix["rounds"] * self.slots, mix["median"], mix["sigma"],
            mix["min_len"], mix["max_len"]), self.slots)
        self.lengths = generate.round_blocks(
            rounds, mix["blocks"], harness.numpy_rng(seed, 1)).reshape(-1)
        self.tokens_rng = harness.numpy_rng(seed, 2)
        self.flash = harness.Recorder.install(layers, "flash_attention",
                                              harness.attention_shape)
        self.rounds = []
        with spans("setup.warmup"):
            for padded in sorted({self.padded(i)
                                  for i in range(mix["rounds"])}):
                zeros = np.zeros((self.slots, padded), np.int64)
                self.serve(padded, list(zeros))
        self.units_done = 0

    def padded(self, i: int) -> int:
        longest = int(self.lengths[i * self.slots:(i + 1) * self.slots].max())
        return math.ceil(longest / self.mix["pad_to"]) * self.mix["pad_to"]

    def serve(self, padded: int, prompts: list) -> tuple:
        """One round through the slot loop: (the prefill's greedy tokens,
        the recorded tokens), in submission order."""
        from repro_torch import serve
        batcher = serve.SlotBatcher(self.slots)
        for rid, p in enumerate(prompts):
            batcher.submit(serve.Request(rid, p, max_new_tokens=1))
        prefill_fn, decode_fn = serve.build_serve_fns(self.model, padded + 2)
        first = {}

        def prefill(params, batch):
            logits, cache = prefill_fn(params, batch)
            first["tokens"] = torch.argmax(logits[:, -1], dim=-1)
            return logits, cache
        serve.serve_requests(batcher, prefill, decode_fn, self.params, padded,
                             padded + 2, self.device)
        done = sorted(batcher.completed, key=lambda r: r.request_id)
        if len(done) != len(prompts):
            raise harness.BenchError(f"{len(done)} of {len(prompts)} "
                                     f"requests completed")
        return (first["tokens"].cpu().numpy(),
                np.array([r.generated[0] for r in done]))

    def unit(self, i: int) -> None:
        if (i + 1) * self.slots > len(self.lengths):
            raise harness.BenchError("the rounds ran dry; raise the "
                                     "traffic's blocks")
        lens = self.lengths[i * self.slots:(i + 1) * self.slots]
        padded = self.padded(i)
        prompts = [np.concatenate([np.zeros(padded - n, np.int64),
                                   self.tokens_rng.integers(
                                       0, self.arch.vocab_size(self.cfg),
                                       n)])
                   for n in lens]
        with self.spans("round"):
            t0, t1 = self.serve(padded, prompts)
        self.rounds.append({"lengths": lens, "padded": padded,
                            "prompts": prompts, "t0": t0, "t1": t1})
        self.units_done += 1

    def window_work(self, first: int, units: int) -> dict:
        rounds = self.rounds[first:first + units]
        self.window_lengths = [int(n) for r in rounds for n in r["lengths"]]
        return {"prompt_lengths": self.window_lengths}

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"prompt_tokens_per_s": sum(self.window_lengths) / seconds}

    def counters(self) -> dict:
        from repro_torch.kernels.flash_attention import flash_attention as fa
        return {"flash_fwd": fa.flash_attention.launches}

    def begin_trace(self) -> None:
        self.flash.calls, self.flash.on = [], True

    def end_trace(self) -> dict:
        self.flash.on = False
        return {"flash_fwd": self.flash.calls}

    def finish(self) -> None:
        del self.params, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """(round, slot) of the requests the check runs: the longest
        completed request and others drawn from the seed."""
        pairs = [(r, s) for r in range(len(self.rounds))
                 for s in range(self.slots)]
        longest = max(pairs, key=lambda p: self.rounds[p[0]]["lengths"][p[1]])
        rng = harness.numpy_rng(self.seed, 3)
        rest = [pairs[k] for k in rng.permutation(len(pairs))
                if pairs[k] != longest]
        return sorted([longest] + rest[:self.mix["check_requests"] - 1])

    def served_logits(self, precision: str = None) -> tuple:
        """Reference logits (n, 2, V) at the positions of the sampled
        requests' two served tokens, and those tokens (n, 2); the
        reference's own precision unless ``precision`` names another."""
        w = self.arch.make_weights(self.cfg, harness.torch_seed(self.seed, 0),
                                   self.device)
        w = {n: t.float() for n, t in w.items()}
        ref = self.cell.reference()
        logits, served = [], []
        by_round = {}
        for r, s in self.sample():
            by_round.setdefault(r, []).append(s)
        for r, slots in by_round.items():
            rd = self.rounds[r]
            seqs = np.stack([np.append(rd["prompts"][s], rd["t0"][s])
                             for s in slots])
            logits.append(ref.last_logits(self.cfg, w, seqs, self.device,
                                          precision).cpu())
            served.append(np.stack([rd["t0"][slots], rd["t1"][slots]], 1))
        return torch.cat(logits), np.concatenate(served)

    def check(self) -> tuple:
        logits, served = self.served_logits()
        self.ref_logits, self.served_tokens = logits, served
        picked = logits.gather(-1, torch.as_tensor(served)[..., None])[..., 0]
        gap = float((logits.amax(-1) - picked).max())
        requests = len(self.rounds) * self.slots
        return ({"logit_gap": (gap, self.mix["limits"]["logit_gap"])},
                requests, 0)
