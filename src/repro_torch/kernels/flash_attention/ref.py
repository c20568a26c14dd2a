"""Plain PyTorch versions of the flash-attention kernel.

* :func:`attention` -- exact softmax attention over ``(BH, T, dh)``, the
  counterpart of ``repro.kernels.flash_attention.ref.attention``.
* :func:`flash_attention` -- the blocked online softmax of
  ``repro.models.layers.flash_attention``, step by step: q-blocks of
  ``q_block`` rows and kv-blocks of ``kv_block`` keys (see
  :func:`set_attn_blocking`), a running max, denominator and accumulator in
  float32, probabilities rounded to the input dtype before P·V, and rows
  with no visible key giving 0.  It is the oracle the CUDA kernel is held
  to and what the wrapper runs on CPU tensors; it runs on any device.
* :func:`flash_attention_bwd` -- its gradient, as the backward kernel
  ``csrc/flash_attention_bwd.cu`` computes it, in the same blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class AttnBlocking:
    q_block: int = 1024
    kv_block: int = 1024


_BLOCKING = AttnBlocking()


def set_attn_blocking(q_block: int, kv_block: int) -> None:
    """The plain version's block sizes (the kernel's tiles are fixed).
    ``repro``'s ``skip_masked_blocks`` flag is not carried: its layer
    never reads it."""
    global _BLOCKING
    _BLOCKING = AttnBlocking(q_block, kv_block)


def get_attn_blocking() -> AttnBlocking:
    return _BLOCKING


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (BH, T, dh); k, v: (BH, S, dh) -> (BH, T, dh); exact softmax."""
    T, S = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(T, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        mask = kpos <= qpos
        if prefix_len > 0:
            mask = mask | (kpos < prefix_len)
        s = torch.where(mask[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def visible(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
            prefix_len: int, kv_limit: int) -> torch.Tensor:
    """(qb, kb) bool mask: True = attend."""
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
        if prefix_len > 0:       # prefix-LM: bidirectional over the prefix
            mask = mask | (kv_pos[None, :] < prefix_len)
    return mask & (kv_pos[None, :] < kv_limit)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, prefix_len: int = 0,
                    kv_valid_len: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention with GQA.

    q: (B, T, Hq, dh); k, v: (B, S, Hkv, dh); Hq % Hkv == 0.  Query head
    ``h`` reads kv head ``h // (Hq // Hkv)``.  Keys at or past
    ``kv_valid_len`` are masked; query ``t`` sits at position
    ``q_offset + t``.
    """
    blocking = _BLOCKING
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if T == 0 or S == 0:
        return torch.zeros_like(q)
    g = Hq // Hkv
    qb = min(blocking.q_block, T)
    kb = min(blocking.kv_block, S)
    nq, nk = -(-T // qb), -(-S // kb)
    scale = dh ** -0.5
    kv_limit = S if kv_valid_len is None else int(kv_valid_len)
    dev = q.device
    outs = []
    for iq in range(nq):
        qblk = q[:, iq * qb:(iq + 1) * qb].float()
        rows = qblk.shape[1]
        qblk = qblk.reshape(B, rows, Hkv, g, dh)
        q_pos = q_offset + iq * qb + torch.arange(rows, device=dev)
        m = torch.full((B, Hkv, g, rows), float("-inf"), device=dev)
        denom = torch.zeros((B, Hkv, g, rows), device=dev)
        acc = torch.zeros((B, Hkv, g, rows, dh), device=dev)
        for ik in range(nk):
            kblk = k[:, ik * kb:(ik + 1) * kb]
            vblk = v[:, ik * kb:(ik + 1) * kb]
            kv_pos = ik * kb + torch.arange(kblk.shape[1], device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk.float()) * scale
            mask = visible(q_pos, kv_pos, causal, prefix_len, kv_limit)
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # Guard fully-masked rows (m_new == -inf).
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            denom = denom * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                              vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(denom, 1e-30)[..., None]
        # (B, Hkv, g, rows, dh) -> (B, rows, Hq, dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, rows, Hq, dh)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, prefix_len: int = 0,
                        kv_valid_len: Optional[int] = None,
                        q_offset: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` given its
    output ``out`` and the output's cotangent ``dout``.

    Step by step in float32 over the forward's blocks: each q-block
    recomputes its rows' max ``m`` and denominator ``l`` over the visible
    keys, then ``D = rowsum(dout * out)`` and, per kv-block, ``P = exp(s -
    m) / max(l, 1e-30)``, ``dV += P^T dO``, ``dP = dO V^T``, ``dS = P (dP -
    D)``, ``dQ += dS K * scale``, ``dK += dS^T Q * scale``.  Each kv head
    sums over its ``Hq / Hkv`` query heads; rows with no visible key give
    zero gradients.  The probabilities are not rounded to the input dtype:
    this is the gradient of the float32 function.  Gradients come out in
    the input dtype.
    """
    blocking = _BLOCKING
    B, T, Hq, dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if T == 0 or S == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    g = Hq // Hkv
    qb = min(blocking.q_block, T)
    kb = min(blocking.kv_block, S)
    nq, nk = -(-T // qb), -(-S // kb)
    scale = dh ** -0.5
    kv_limit = S if kv_valid_len is None else int(kv_valid_len)
    dev = q.device
    dk = torch.zeros((B, S, Hkv, dh), device=dev)
    dv = torch.zeros((B, S, Hkv, dh), device=dev)
    dqs = []
    for iq in range(nq):
        rows_sl = slice(iq * qb, (iq + 1) * qb)
        qblk = q[:, rows_sl].float()
        rows = qblk.shape[1]
        qblk = qblk.reshape(B, rows, Hkv, g, dh)
        doblk = dout[:, rows_sl].float().reshape(B, rows, Hkv, g, dh)
        oblk = out[:, rows_sl].float().reshape(B, rows, Hkv, g, dh)
        q_pos = q_offset + iq * qb + torch.arange(rows, device=dev)

        def scores(ik):
            kblk = k[:, ik * kb:(ik + 1) * kb].float()
            kv_pos = ik * kb + torch.arange(kblk.shape[1], device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
            mask = visible(q_pos, kv_pos, causal, prefix_len, kv_limit)
            return kblk, torch.where(mask, s, float("-inf")), mask

        # Pass 1: the rows' max and denominator, as the forward runs them.
        m = torch.full((B, Hkv, g, rows), float("-inf"), device=dev)
        denom = torch.zeros((B, Hkv, g, rows), device=dev)
        for ik in range(nk):
            _, s, mask = scores(ik)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            denom = denom * corr + p.sum(dim=-1)
            m = m_new
        m_safe = torch.where(torch.isfinite(m), m, 0.0)[..., None]
        inv_l = (1.0 / torch.clamp_min(denom, 1e-30))[..., None]
        # D: (B, rows, Hkv, g) -> (B, Hkv, g, rows, 1)
        big_d = (doblk * oblk).sum(dim=-1).permute(0, 2, 3, 1)[..., None]

        # Pass 2: the gradients.
        dqblk = torch.zeros((B, Hkv, g, rows, dh), device=dev)
        for ik in range(nk):
            kblk, s, mask = scores(ik)
            keys = slice(ik * kb, ik * kb + kblk.shape[1])
            vblk = v[:, keys].float()
            p = torch.where(mask, torch.exp(s - m_safe) * inv_l, 0.0)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doblk, vblk)
            ds = p * (dp - big_d)
            dv[:, keys] += torch.einsum("bhgqk,bqhgd->bkhd", p, doblk)
            dk[:, keys] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qblk) * scale
            dqblk += torch.einsum("bhgqk,bkhd->bhgqd", ds, kblk) * scale
        dqs.append(dqblk.permute(0, 3, 1, 2, 4).reshape(B, rows, Hq, dh))
    dq = torch.cat(dqs, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
