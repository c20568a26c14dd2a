"""Loss functions: the counterpart of ``repro.models.losses``.

``chunked_lm_loss`` never materializes the full (B, T, V) logits tensor:
the vocab product and the cross entropy run per sequence chunk, each chunk
under :func:`torch.utils.checkpoint.checkpoint`, so the backward recomputes
a chunk's (B, chunk, V) logits instead of keeping every chunk's.  The target
logit is read with :func:`torch.gather` where the reference sums a one-hot
product; both give the logit itself.  On a vocab-sharded :class:`DTensor`
the chunk takes the reference's one-hot form and a log-sum-exp from its
max and sum, which partition over the shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sharding


def _targets(targets, device) -> torch.Tensor:
    return torch.as_tensor(targets, device=device).long()


def lm_loss(logits: torch.Tensor, targets) -> torch.Tensor:
    """Next-token cross entropy.  ``targets`` aligned with ``logits``
    positions; positions with target < 0 are ignored (e.g. a VLM image
    prefix)."""
    logits = logits.float()
    targets = _targets(targets, logits.device)
    valid = (targets >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    nll = (lse - tgt) * valid
    return nll.sum() / torch.clamp_min(valid.sum(), 1.0)


def _chunk_nll(h: torch.Tensor, head: torch.Tensor, t: torch.Tensor):
    """(sum of the chunk's nll, its valid positions); the product is in the
    operands' dtype and is cast to float32 after it, as the reference's."""
    logits = (h @ head).float()
    valid = (t >= 0).float()
    if sharding.is_sharded(logits):
        # Reductions over the vocab's shards (small all-reduces) in place
        # of gathering the chunk's logits.
        logits = sharding.constrain(logits, "batch", None, "model")
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
               )[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        hit = vocab == t.clamp_min(0)[..., None]
        tgt = torch.where(hit, logits, 0.0).sum(-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, t.clamp_min(0)[..., None])[..., 0]
    return ((lse - tgt) * valid).sum(), valid.sum()


def chunked_lm_loss(hidden: torch.Tensor, head: torch.Tensor, targets,
                    chunk: int = 512) -> torch.Tensor:
    """CE over sequence chunks: logits (B, chunk, V) are transient.

    hidden: (B, T, d) final normalized hidden states; head: (d, V).
    """
    B, T, d = hidden.shape
    targets = _targets(targets, hidden.device)
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_valid = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T + pad, c):
        s, n = checkpoint(_chunk_nll, hidden[:, i:i + c], head,
                          targets[:, i:i + c], use_reentrant=False)
        nll_sum = nll_sum + s
        n_valid = n_valid + n
    return nll_sum / torch.clamp_min(n_valid, 1.0)
