"""LAYOUT MANAGER: on-the-fly candidate generation + ε-admission (Alg. 5).

The producer side of the dynamic state space:

* keeps a sliding window of recent queries (and, for ablations, a reservoir or
  both) from which new candidate layouts are generated every ``gen_every``
  queries;
* keeps an R-TBS time-biased reservoir of queries on which candidate layouts
  are compared: a candidate is admitted iff the normalized-L1 distance between
  its cost vector and that of *every* existing state is >= epsilon;
* caps the state space at ``max_states`` by evicting the admitted state most
  similar to the rest (never the current state), issuing a remove-state query.

Host control logic, as in the reference; the cost vectors go through the
device scan (:func:`repro_torch.core.layouts.cost_vector`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from . import layouts, qdtree, sampling, workload as wl, zorder

# generate_layout(layout_id, data, window_queries, k) -> Layout
GeneratorFn = Callable[[int, torch.Tensor, Sequence[wl.Query], int],
                       layouts.Layout]


class LayoutGenerator:
    """Picklable :data:`GeneratorFn` for a named technique.

    A plain class rather than a closure so policies holding a generator
    (and therefore whole engines) survive pickling — live tenant
    migration across shard processes ships the engine object.
    """

    def __init__(self, technique: str, seed: int = 0):
        if technique not in ("qdtree", "zorder"):
            raise ValueError(f"unknown technique: {technique}")
        self.technique = technique
        self.seed = seed

    def __call__(self, layout_id, data, queries, k):
        if self.technique == "qdtree":
            return qdtree.build_qdtree_layout(layout_id, data, queries, k,
                                              seed=self.seed + layout_id)
        return zorder.build_zorder_layout(layout_id, data, queries, k)


def make_generator(technique: str, seed: int = 0) -> GeneratorFn:
    return LayoutGenerator(technique, seed=seed)


@dataclasses.dataclass
class LayoutManagerConfig:
    window_size: int = 200          # paper default: most recent 200 queries
    gen_every: int = 100            # generate a candidate every N queries
    epsilon: float = 0.08           # paper default admission threshold
    max_states: int = 8             # state-space cap (|S_max| in Thm IV.1)
    rtbs_size: int = 64             # representative query sample size s
    rtbs_lambda: float = 2e-3
    target_partitions: int = 32
    candidate_source: str = "sw"    # "sw" | "rs" | "sw+rs" (Table II ablation)
    rs_size: int = 200


class LayoutManager:
    """Produces state add/remove events consumed by the REORGANIZER."""

    def __init__(self, data: torch.Tensor, generator: GeneratorFn,
                 initial_layout: layouts.Layout,
                 config: Optional[LayoutManagerConfig] = None,
                 seed: int = 0):
        self.data = data
        self.generator = generator
        self.config = config or LayoutManagerConfig()
        self.rng = np.random.default_rng(seed)
        self.window: sampling.SlidingWindow[wl.Query] = sampling.SlidingWindow(
            self.config.window_size)
        self.reservoir: sampling.ReservoirSample[wl.Query] = (
            sampling.ReservoirSample(self.config.rs_size, seed=seed + 1))
        self.rtbs: sampling.RTBSample[wl.Query] = sampling.RTBSample(
            self.config.rtbs_size, lam=self.config.rtbs_lambda, seed=seed + 2)
        self.store: Dict[int, layouts.Layout] = {
            initial_layout.layout_id: initial_layout}
        self.next_id = initial_layout.layout_id + 1
        self.queries_seen = 0
        self.num_generated = 0
        self.num_admitted = 0
        # Cost vectors of stored layouts, keyed by the R-TBS sample version:
        # valid until the sample itself changes, so the eviction while-loop
        # and periodic pruning stop recomputing the full |S| x |sample|
        # matrix on every iteration.
        self._cv_cache: Dict[int, np.ndarray] = {}
        self._cv_version = -1
        self._cv_bounds: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _sample_bounds(self) -> Optional[tuple]:
        """Stacked (q_lo, q_hi) of the current R-TBS sample, refreshed (and
        the cost-vector cache dropped) whenever the sample version moves."""
        if self.rtbs.version != self._cv_version:
            self._cv_cache.clear()
            self._cv_version = self.rtbs.version
            qs = self.rtbs.sample()
            self._cv_bounds = wl.stack_queries(qs) if qs else None
        return self._cv_bounds

    def _cost_vectors(self, candidates: Dict[int, layouts.Layout]
                      ) -> Dict[int, np.ndarray]:
        bounds = self._sample_bounds()
        if bounds is None:
            return {i: np.zeros(0) for i in candidates}
        q_lo, q_hi = bounds
        out: Dict[int, np.ndarray] = {}
        for i, lay in candidates.items():
            vec = self._cv_cache.get(i)
            if vec is None:
                vec = layouts.cost_vector(lay.meta, q_lo, q_hi)
                # Only layouts actually admitted to the store are cached:
                # a rejected candidate's id is reused by the next candidate.
                if self.store.get(i) is lay:
                    self._cv_cache[i] = vec
            out[i] = vec
        return out

    def _candidate_queries(self) -> List[List[wl.Query]]:
        src = self.config.candidate_source
        out: List[List[wl.Query]] = []
        if src in ("sw", "sw+rs") and len(self.window):
            out.append(self.window.sample())
        if src in ("rs", "sw+rs") and len(self.reservoir):
            out.append(self.reservoir.sample())
        return out

    # ------------------------------------------------------------------
    def on_query(self, query: wl.Query, current_state: int
                 ) -> tuple[List[int], List[int]]:
        """Observe one query; returns (added_state_ids, removed_state_ids)."""
        self.window.add(query)
        self.reservoir.add(query)
        self.rtbs.add(query)
        self.queries_seen += 1
        added: List[int] = []
        removed: List[int] = []
        if (self.queries_seen % self.config.gen_every != 0
                or len(self.window) < self.config.window_size // 2):
            return added, removed

        for qset in self._candidate_queries():
            cand = self.generator(self.next_id, self.data, qset,
                                  self.config.target_partitions)
            self.num_generated += 1
            if self._admit(cand):
                self.store[cand.layout_id] = cand
                added.append(cand.layout_id)
                self.next_id += 1
                self.num_admitted += 1
                removed.extend(self._maybe_evict(current_state))
        return added, removed

    def _admit(self, cand: layouts.Layout) -> bool:
        """Algorithm 5: admit iff >= epsilon from every existing state."""
        vecs = self._cost_vectors({**self.store, cand.layout_id: cand})
        cv = vecs.pop(cand.layout_id)
        if cv.size == 0:
            return False
        for sid, v in vecs.items():
            if layouts.layout_distance(cv, v) < self.config.epsilon:
                return False
        return True

    def _maybe_evict(self, current_state: int) -> List[int]:
        """Keep |S| <= max_states: evict the non-current state whose cost
        vector is closest to some other state (most redundant)."""
        removed = []
        while len(self.store) > self.config.max_states:
            ids = [i for i in self.store if i != current_state]
            if not ids:
                break
            vecs = self._cost_vectors(self.store)
            best, best_d = None, np.inf
            for i in ids:
                d = min(layouts.layout_distance(vecs[i], vecs[j])
                        for j in self.store if j != i)
                if d < best_d:
                    best, best_d = i, d
            if best is None:
                # Every candidate tied at a non-comparable distance (e.g. an
                # empty R-TBS sample yields degenerate cost vectors): evict
                # the newest non-current state so the loop always progresses.
                best = max(ids)
            del self.store[best]
            self._cv_cache.pop(best, None)
            removed.append(best)
        return removed

    # ------------------------------------------------------------------
    def prune_redundant(self, current_state: int) -> List[int]:
        """Optional periodic pruning (§V-B): drop states that have become
        redundant under the *current* query sample."""
        removed = []
        vecs = self._cost_vectors(self.store)
        ids = sorted(self.store)
        for i in ids:
            if i == current_state or i not in self.store:
                continue
            for j in self.store:
                if j == i:
                    continue
                if layouts.layout_distance(vecs[i], vecs[j]) < self.config.epsilon / 2:
                    del self.store[i]
                    self._cv_cache.pop(i, None)
                    removed.append(i)
                    break
        return removed
