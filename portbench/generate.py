"""The benchmark's input generators: everything a cell feeds the program
is drawn here from the run's seed, from the parameters of a traffic file
(``traffic/<mix>.json``) and of a configuration file.

* :func:`corpus` and :func:`recipe`: the training-data pipeline's corpus
  metadata and tokens, and its drifting data-selection queries.
* :func:`prompt_lengths`, :func:`length_rounds` and :func:`round_blocks`:
  rounds of prompt lengths from a clipped log-normal, batched by length,
  the same rounds in every block of every seed, each block in its own
  order.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Training data: corpus and recipe
# ---------------------------------------------------------------------------


def corpus(n_docs: int, doc_len: int, vocab: int,
           rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Metadata (N, 4) float64 [domain, quality, length, ingest time] and
    tokens (N, doc_len) int32."""
    domain = rng.integers(0, 32, n_docs).astype(float)
    quality = rng.beta(4, 2, n_docs)
    length = rng.integers(doc_len // 4, doc_len + 1, n_docs).astype(float)
    ingest = np.sort(rng.uniform(0, 1e6, n_docs))
    meta = np.stack([domain, quality, length, ingest], axis=1)
    tokens = rng.integers(0, vocab, (n_docs, doc_len), dtype=np.int32)
    return meta, tokens


def recipe(meta: np.ndarray, total: int, rng: np.random.Generator,
           segment_length: Sequence[int]) -> Iterator[tuple]:
    """``total`` data-selection queries ``(lo, hi, kind)`` in segments of
    one kind: a band of domains, a quality threshold, or a recency window
    that jitters from query to query."""
    col_lo, col_hi = meta.min(0), meta.max(0)
    c = meta.shape[1]
    step = 0
    while step < total:
        seg = int(rng.integers(*segment_length))
        kind = int(rng.integers(0, 3))
        lo, hi = np.full(c, -np.inf), np.full(c, np.inf)
        if kind == 0:
            d0 = rng.integers(0, 28)
            lo[0], hi[0] = d0, d0 + rng.integers(1, 4)
        elif kind == 1:
            lo[1] = rng.uniform(0.6, 0.9)
        else:
            width = (col_hi[3] - col_lo[3]) * rng.uniform(0.05, 0.2)
            start = rng.uniform(col_lo[3], col_hi[3] - width)
            lo[3], hi[3] = start, start + width
        for _ in range(min(seg, total - step)):
            jl, jh = lo.copy(), hi.copy()
            if kind == 2:
                shift = rng.uniform(-0.01, 0.01) * (col_hi[3] - col_lo[3])
                jl[3] += shift
                jh[3] += shift
            yield jl, jh, kind
            step += 1


# ---------------------------------------------------------------------------
# Prompt lengths
# ---------------------------------------------------------------------------

def prompt_lengths(count: int, median: float, sigma: float, lo: int,
                   hi: int) -> np.ndarray:
    """``count`` lengths at the midpoint quantiles of a log-normal with
    that median and sigma, clipped to [lo, hi], ascending."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((k + 0.5) / count)
                  for k in range(count)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi
                   ).astype(np.int64)


def length_rounds(lengths: np.ndarray, slots: int) -> np.ndarray:
    """Rounds (R, slots) of neighbouring lengths: ``lengths`` sorted and
    cut into consecutive groups, as a prefill pool that batches its queue
    by length forms them."""
    return np.sort(lengths).reshape(-1, slots)


def round_blocks(rounds: np.ndarray, blocks: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``blocks`` blocks of the rounds ``rounds`` (R, slots), each block
    holding every round once in an order drawn from ``rng``: (blocks * R,
    slots).  Every whole block is the same work."""
    return np.concatenate([rounds[rng.permutation(len(rounds))]
                           for _ in range(blocks)])
