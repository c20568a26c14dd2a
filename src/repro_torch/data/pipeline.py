"""OREO-managed training-data pipeline: the paper's technique as a part of
the training framework; the counterpart of ``repro.data.pipeline``.

A tokenized corpus lives in partitions whose zone maps cover metadata
columns (domain, quality score, length bucket, ingest time).  Data-selection
jobs -- mixture sampling, curriculum filtering, decontamination sweeps --
issue conjunctive range predicates over that metadata; every selection pays
for the partitions it cannot skip.  As the selection workload drifts, OREO
decides online when re-partitioning the corpus pays for itself, with the
D-UMTS worst-case guarantee bounding the total (scan + reorganize) cost.

The metadata table is a float64 tensor on the pipeline's device (the card
unless ``device="cpu"``), under the port's layout manager, D-UMTS and
``layouts.eval_cost``, so the ``pruning`` kernel scores it on the card; the
tokens stay a host numpy array.  Batches and :class:`PipelineStats` equal
the reference's bit for bit on the same seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import layout_manager as lm
from repro_torch.core import layouts as L
from repro_torch.core import mts, predictors
from repro_torch.core import workload as wl
from repro_torch.core.qdtree import build_default_layout
from repro_torch.kernels._backend import resolve_device, to_device


@dataclasses.dataclass
class PipelineStats:
    queries: int = 0
    scan_fraction_sum: float = 0.0
    reorgs: int = 0
    alpha: float = 80.0

    @property
    def mean_scan_fraction(self) -> float:
        return self.scan_fraction_sum / max(self.queries, 1)

    @property
    def total_cost(self) -> float:
        return self.scan_fraction_sum + self.reorgs * self.alpha


def synth_corpus(n_docs: int = 100_000, doc_len: int = 128, vocab: int = 50000,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic corpus: metadata (N, 4) [domain, quality, length, time] +
    token matrix (N, doc_len), host arrays drawn as the reference draws
    them."""
    rng = np.random.default_rng(seed)
    domain = rng.integers(0, 32, n_docs).astype(float)
    quality = rng.beta(4, 2, n_docs)
    length = rng.integers(doc_len // 4, doc_len + 1, n_docs).astype(float)
    ingest = np.sort(rng.uniform(0, 1e6, n_docs))
    meta = np.stack([domain, quality, length, ingest], axis=1)
    tokens = rng.integers(0, vocab, (n_docs, doc_len), dtype=np.int32)
    return meta, tokens


class OreoDataPipeline:
    """Iterator of training batches whose selection queries are OREO-managed.

    Each ``next()``: (1) draws a selection query from the recipe stream,
    (2) feeds it to the LAYOUT MANAGER + D-UMTS REORGANIZER, (3) charges the
    scan fraction of the serving layout, (4) yields a (tokens, targets)
    batch of host int32 arrays drawn from the matching documents.
    """

    def __init__(self, meta: np.ndarray, tokens: np.ndarray,
                 recipe: Iterator[wl.Query],
                 batch_size: int = 8, seq_len: int = 128,
                 alpha: float = 80.0, gamma: float = 1.0,
                 technique: str = "qdtree",
                 target_partitions: int = 32,
                 manager_cfg: Optional[lm.LayoutManagerConfig] = None,
                 seed: int = 0,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.meta = to_device(meta, self.device)
        self.tokens = tokens
        self.recipe = recipe
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        init = build_default_layout(0, self.meta, target_partitions)
        init.materialize(self.meta)
        mgr_cfg = manager_cfg or lm.LayoutManagerConfig(
            target_partitions=target_partitions)
        self.manager = lm.LayoutManager(self.meta, lm.make_generator(technique),
                                        init, mgr_cfg, seed=seed)
        self.dumts = mts.DynamicUMTS(
            alpha=alpha, initial_states=[0], seed=seed,
            transition_fn=predictors.gamma_biased_transition(gamma))
        self.cost_model = cm.CostModel(alpha=alpha)
        self.serving = init
        self.stats = PipelineStats(alpha=alpha)

    # ------------------------------------------------------------------
    def _observe(self, q: wl.Query) -> None:
        added, removed = self.manager.on_query(q, self.dumts.current_state)
        for sid in added:
            self.dumts.add_state(sid)
        for sid in removed:
            self.dumts.remove_state(sid)
        costs = {}
        for sid in set(self.dumts.states) | set(self.dumts.pending_additions):
            lay = self.manager.store.get(sid)
            costs[sid] = (self.cost_model.query_cost(lay, q)
                          if lay is not None else 1.0)
        prev = self.dumts.num_moves
        state = self.dumts.observe(costs)
        if self.dumts.num_moves > prev:
            # Background reorganization: materialize the new layout.
            self.stats.reorgs += 1
            lay = self.manager.store.get(state)
            if lay is not None:
                lay.materialize(self.meta)
                self.serving = lay

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        q = next(self.recipe)
        self._observe(q)
        frac = float(L.eval_cost(self.serving.serving_meta(), q.lo, q.hi))
        self.stats.queries += 1
        self.stats.scan_fraction_sum += frac
        # Select matching documents (the actual read).
        lo = torch.as_tensor(q.lo, device=self.device)
        hi = torch.as_tensor(q.hi, device=self.device)
        mask = ((self.meta >= lo[None, :]) & (self.meta <= hi[None, :])
                ).all(dim=1)
        idx = torch.nonzero(mask)[:, 0].cpu().numpy()
        if len(idx) == 0:
            idx = np.arange(len(self.tokens))
        pick = self.rng.choice(idx, size=self.batch_size, replace=True)
        toks = self.tokens[pick][:, :self.seq_len].astype(np.int32)
        targets = np.roll(toks, -1, axis=1)
        targets[:, -1] = -1
        return {"tokens": toks, "targets": targets}


def mixture_recipe(meta: np.ndarray, total_steps: int, seed: int = 0,
                   segment_length: Tuple[int, int] = (200, 600)
                   ) -> Iterator[wl.Query]:
    """Drifting data-selection recipe: phases of domain-focused, quality-
    thresholded, or recency-windowed selection (the drift OREO adapts to).
    ``meta`` is the host metadata array."""
    rng = np.random.default_rng(seed)
    col_lo, col_hi = meta.min(0), meta.max(0)
    c = meta.shape[1]
    step = 0
    while step < total_steps:
        seg = int(rng.integers(*segment_length))
        kind = rng.integers(0, 3)
        lo = np.full(c, -np.inf)
        hi = np.full(c, np.inf)
        if kind == 0:        # domain band
            d0 = rng.integers(0, 28)
            lo[0], hi[0] = d0, d0 + rng.integers(1, 4)
        elif kind == 1:      # quality threshold
            lo[1] = rng.uniform(0.6, 0.9)
        else:                # recency window
            width = (col_hi[3] - col_lo[3]) * rng.uniform(0.05, 0.2)
            start = rng.uniform(col_lo[3], col_hi[3] - width)
            lo[3], hi[3] = start, start + width
        for _ in range(min(seg, total_steps - step)):
            jl, jh = lo.copy(), hi.copy()
            if np.isfinite(hi[3]) and kind == 2:   # jitter time windows
                shift = rng.uniform(-0.01, 0.01) * (col_hi[3] - col_lo[3])
                jl[3] += shift
                jh[3] += shift
            yield wl.Query(lo=jl, hi=jh, template_id=int(kind))
            step += 1
