"""Training cells: AdamW steps of the port's ``build_train_step`` on batches
that the port's ``OreoDataPipeline`` selects from a synthetic corpus.

Set-up builds one training state (weights made from the seed, the port's
optimizer state) and drives it through its first ``check_steps`` steps by
the window's own call and feed, reading what the check compares: each
step's loss, each leaf's first gradient as the optimizer took it (its
first moment after one step over ``1 - b1``) and each leaf's change after
those steps.  The window continues the same state.  After it the state is
freed and the reference follows the first steps from the same weights on
the same batches; every batch the pipeline gave is held to the selection
query it answered.

Traffic keys: ``batch``, ``seq_len``, ``docs``, ``recipe_steps``,
``segment_length``, ``alpha``, ``partitions``, ``check_steps``,
``traced_units``, ``optimizer`` (the port's ``OptimizerConfig`` fields),
``options`` (the port's ``TrainOptions`` fields) and ``limits``.
"""
from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from portbench import generate, harness


def leaf_gap(prog: dict, ref: dict, names) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in names)


class Driver:
    def __init__(self, cell, seed: int, device, spans):
        from repro_torch import train as port_train
        from repro_torch.data import OreoDataPipeline
        from repro_torch.models import build_model, layers
        from repro_torch.models.transformer import trainable
        from repro_torch.train import compression, optimizer
        cfg, mix = cell.config, cell.mix
        self.cell, self.device, self.spans = cell, device, spans
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.traced_units = mix["traced_units"]
        self.arch = cell.model()
        with spans("setup.weights"):
            self.model = build_model(self.arch.arch_config(cfg), device)
            w = self.arch.make_weights(cfg, harness.torch_seed(seed, 0),
                                       device)
            params = trainable(self.arch.port_params(w, cfg))
            del w
            opt_cfg = port_train.OptimizerConfig(**mix["optimizer"])
            options = port_train.TrainOptions(**mix["options"])
            self.state = {"params": params,
                          "opt": optimizer.init_opt_state(params, opt_cfg)}
            if options.compress_grads:
                self.state["ef_residual"] = compression.init_residual(params)
            self.step_fn = port_train.build_train_step(self.model, opt_cfg,
                                                       options)
        with spans("setup.corpus"):
            meta, self.tokens = generate.corpus(
                mix["docs"], mix["seq_len"], self.arch.vocab_size(cfg),
                harness.numpy_rng(seed, 1))
        self.meta = meta
        self.queries = []
        with spans("setup.pipeline"):
            self.pipe = OreoDataPipeline(
                meta, self.tokens,
                self._recipe(meta, harness.numpy_rng(seed, 2)),
                batch_size=mix["batch"], seq_len=mix["seq_len"],
                alpha=mix["alpha"], target_partitions=mix["partitions"],
                seed=seed % 2 ** 32, device=device)
        self.flash = harness.Recorder.install(layers, "flash_attention",
                                              harness.attention_shape)
        self.batches, self.losses = [], []
        self.units_done = 0
        self.readings = {}
        b1 = mix["optimizer"]["b1"]
        with spans("setup.checked_steps"):
            for i in range(mix["check_steps"]):
                self.unit(i)
                if i == 0:
                    self.readings["grad_norms"] = {
                        n: float(torch.linalg.vector_norm(m.float()))
                        / (1 - b1)
                        for n, m in self.state["opt"]["m"].items()}
        with spans("setup.change_norms"):
            w0 = self.arch.make_weights(cfg, harness.torch_seed(seed, 0),
                                        device)
            with torch.no_grad():
                self.readings["change_norms"] = {
                    n: float(torch.linalg.vector_norm(p.float()
                                                      - w0[n].float()))
                    for n, p in self.state["params"].named_parameters()}
            del w0
        self.readings["losses"] = list(self.losses)

    def _recipe(self, meta, rng):
        from repro_torch.core.workload import Query
        for lo, hi, kind in generate.recipe(meta, self.mix["recipe_steps"],
                                            rng, self.mix["segment_length"]):
            self.queries.append((lo, hi))
            yield Query(lo=lo, hi=hi, template_id=kind)

    def unit(self, i: int) -> None:
        with self.spans("pipeline"):
            try:
                batch = next(self.pipe)
            except StopIteration:
                raise harness.BenchError(
                    f"the recipe ran dry after {len(self.queries)} steps; "
                    f"raise recipe_steps") from None
        self.batches.append(batch)
        with self.spans("train_step"):
            dev = {k: torch.as_tensor(v, device=self.device)
                   for k, v in batch.items()}
            self.state, metrics = self.step_fn(self.state, dev)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.losses.append(float(metrics["loss"]))
        self.units_done += 1

    def window_work(self, first: int, units: int) -> dict:
        return {}

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"train_tokens_per_s":
                units * self.mix["batch"] * self.mix["seq_len"] / seconds}

    def counters(self) -> dict:
        from repro_torch.kernels.flash_attention import flash_attention as fa
        return {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd": fa.flash_attention_bwd.launches}

    def begin_trace(self) -> None:
        self.flash.calls, self.flash.on = [], True

    def end_trace(self) -> dict:
        self.flash.on = False
        return {"flash_fwd": self.flash.calls}

    def finish(self) -> None:
        del self.state, self.step_fn, self.pipe, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def bad_batches(self) -> int:
        """Batches with a row that is not the head of a document matching
        its selection query (any document where none matches), or whose
        targets are not its tokens shifted by one."""
        seq = self.mix["seq_len"]
        index = {row[:8].tobytes(): d for d, row in enumerate(self.tokens)}
        bad = 0
        for batch, (lo, hi) in zip(self.batches, self.queries):
            match = ((self.meta >= lo) & (self.meta <= hi)).all(axis=1)
            want = np.roll(batch["tokens"], -1, axis=1)
            want[:, -1] = -1
            ok = np.array_equal(batch["targets"], want)
            for row in batch["tokens"]:
                d = index.get(row[:8].tobytes())
                ok &= (d is not None
                       and np.array_equal(row, self.tokens[d, :seq])
                       and (bool(match[d]) or not match.any()))
            bad += not ok
        return bad

    def check(self) -> tuple:
        limits = self.mix["limits"]
        ref = self.cell.reference().train_readings(
            self.cfg, self.arch.make_weights(
                self.cfg, harness.torch_seed(self.seed, 0), self.device),
            self.batches[:self.mix["check_steps"]],
            self.mix["optimizer"], self.device)
        got = self.readings
        loss_gap = max(abs(p - r) / abs(r)
                       for p, r in zip(got["losses"], ref["losses"]))
        names = list(ref["grad_norms"])
        grad_gap = leaf_gap(got["grad_norms"], ref["grad_norms"], names)
        median = float(np.median(list(ref["grad_norms"].values())))
        moving = [n for n in names if ref["grad_norms"][n] >= 1e-3 * median]
        change_gap = leaf_gap(got["change_norms"], ref["change_norms"],
                              moving)
        bad = self.bad_batches()
        print(f"portbench: change_gap over {len(moving)} of {len(names)} "
              f"leaves (the rest under 1e-3 of the median first gradient)",
              file=sys.stderr)
        self.ref = ref
        checks = {"loss_gap": (loss_gap, limits["loss_gap"]),
                  "first_grad_gap": (grad_gap, limits["first_grad_gap"]),
                  "change_gap": (change_gap, limits["change_gap"]),
                  "bad_batches": (bad, 0)}
        return checks, len(self.batches), bad
