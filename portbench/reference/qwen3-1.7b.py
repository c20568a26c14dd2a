"""Plain PyTorch reference of Qwen3-1.7B (hf:Qwen/Qwen3-1.7B): the decoder's
forward, its next-token loss and gradients, and AdamW, in float32 (its
products in ``PRECISION``), written from the published description and
nothing of the port.

Model: token embedding; per layer a pre-norm (RMS norm, eps from the
config) GQA attention with RMS-normed q and k per head, rotary embedding
(half split, base ``rope_theta``) and causal softmax, then a pre-norm SiLU
gated MLP; a final RMS norm and an untied output head.  Norm scales are
read as ``1 + scale`` (the weights start them at zero, which is Qwen3's
ones).  Departures from the published model, shared with the program run:
the output head is a matrix of its own (``tie_word_embeddings`` false).

Optimizer (the semantics the configuration states): AdamW with a linear
warm-up of the learning rate, the global gradient norm clipped to
``clip_norm``, bias-corrected moments in float32, weight decay on every
leaf but the final norm scale (the per-layer norm scales are rows of one
stacked matrix in the layout the configuration describes), and parameters
held in their served dtype: a bfloat16 leaf takes the float32 update
rounded to bfloat16.

``precision`` names how products are computed: ``"fp32"`` in float32
with TF32 off, ``"tf32"`` on float32 operands with TF32 on (10 mantissa
bits, above the configuration's bfloat16), and ``"fp8"`` with both
operands rounded to float8 e4m3 (per-tensor scale, the step below the
configuration's bfloat16): the control that a comparison has to fail.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0

#: The precision of the reference's products in the benchmark's checks.
PRECISION = "tf32"


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in
    float32; its gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


@contextlib.contextmanager
def products(precision: str):
    """The product function of ``precision``, with TF32 set as it says
    for the block and restored after it."""
    if precision not in ("fp32", "tf32", "fp8"):
        raise ValueError(precision)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if precision == "fp8":
            yield lambda a, b: torch.matmul(_fp8(a), _fp8(b))
        else:
            yield torch.matmul
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x, positions, theta):
    """x (B, T, H, dh): the first and second half of each head rotated as
    one complex pair per frequency."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm, q_block: int):
    """Causal softmax attention, query rows in blocks of ``q_block``:
    q (B, T, Hq, dh), k and v (B, T, Hkv, dh), each kv head shared by
    Hq / Hkv query heads."""
    b, t, hq, dh = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)      # (B, Hq, T, dh)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for s in range(0, t, q_block):
        e = min(t, s + q_block)
        scores = mm(q[:, :, s:e], k.transpose(-1, -2)) * dh ** -0.5
        keys = torch.arange(t, device=q.device)
        rows = torch.arange(s, e, device=q.device)
        scores = scores.masked_fill(keys[None, :] > rows[:, None],
                                    float("-inf"))
        outs.append(mm(torch.softmax(scores, dim=-1), v))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, hq * dh)


def layer(x, w: Dict[str, torch.Tensor], i: int, cfg: dict, positions, mm,
          q_block: int):
    p = f"layers.{i}."
    eps, dh = cfg["rms_norm_eps"], cfg["head_dim"]
    b, t, _ = x.shape
    h = rms_norm(x, w[p + "ln1"], eps)
    q = mm(h, w[p + "attn.wq"]).view(b, t, -1, dh)
    k = mm(h, w[p + "attn.wk"]).view(b, t, -1, dh)
    v = mm(h, w[p + "attn.wv"]).view(b, t, -1, dh)
    q = rope(rms_norm(q, w[p + "attn.q_norm"], eps), positions,
             cfg["rope_theta"])
    k = rope(rms_norm(k, w[p + "attn.k_norm"], eps), positions,
             cfg["rope_theta"])
    x = x + mm(attention(q, k, v, mm, q_block), w[p + "attn.wo"])
    h = rms_norm(x, w[p + "ln2"], eps)
    return x + mm(F.silu(mm(h, w[p + "mlp.w_gate"])) * mm(h, w[p + "mlp.w_up"]),
                  w[p + "mlp.w_down"])


def hidden(w, tokens: torch.Tensor, cfg: dict, mm, remat: bool,
           q_block: int = 1024):
    """Final-normed hidden states (B, T, d) of ``tokens`` (B, T)."""
    x = w["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg["num_hidden_layers"]):
        if remat:
            x = checkpoint(layer, x, w, i, cfg, positions, mm, q_block,
                           use_reentrant=False)
        else:
            x = layer(x, w, i, cfg, positions, mm, q_block)
    return rms_norm(x, w["final_norm"], cfg["rms_norm_eps"])


def _nll_sum(h, head, targets, mm):
    logits = mm(h, head)
    valid = targets >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, targets.clamp_min(0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum()


def decays(name: str) -> bool:
    return name != "final_norm"


def _lr(step: int, opt: dict) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    progress = min(max((step - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0), 1.0)
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (
        1.0 + np.cos(np.pi * progress))


def train_readings(cfg: dict, w0: Dict[str, torch.Tensor],
                   batches: Sequence[dict], opt: dict, device,
                   rows_per_block: int = 2,
                   precision: str = None) -> dict:
    """AdamW steps from the weights ``w0`` over ``batches`` (host int32
    ``tokens`` and ``targets``, target -1 ignored): each step's loss, the
    norm of each leaf's first gradient as the optimizer takes it (after
    clipping), and the norm of each leaf's change after the last step.
    A batch runs in blocks of rows, each block's share of the mean loss
    back-propagated into the summed gradients, each layer recomputed in
    the backward; products in ``precision``, by default ``PRECISION``."""
    with products(precision or PRECISION) as mm:
        return _train(cfg, w0, batches, opt, device, rows_per_block, mm)


def _train(cfg, w0, batches, opt, device, rows_per_block, mm) -> dict:
    served = {n: t.dtype for n, t in w0.items()}
    p = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in w0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        tokens = torch.as_tensor(batch["tokens"], device=device).long()
        targets = torch.as_tensor(batch["targets"], device=device).long()
        count = float((targets >= 0).sum())
        loss = 0.0
        for r in range(0, tokens.shape[0], rows_per_block):
            h = hidden(p, tokens[r:r + rows_per_block], cfg, mm, remat=True)
            part = checkpoint(_nll_sum, h, p["head"],
                              targets[r:r + rows_per_block], mm,
                              use_reentrant=False) / count
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            gnorm = float(torch.sqrt(sum(torch.sum(t.grad.double() ** 2)
                                         for t in p.values())))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
            lr = _lr(step, opt)
            bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for n, t in p.items():
                g = t.grad * scale
                if step == 1:
                    grad_norms[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                delta = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                if decays(n):
                    delta = delta + opt["weight_decay"] * t
                new = t - lr * delta
                t.copy_(new.to(served[n]).float())
                t.grad = None
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(t - w0[n].float()))
                  for n, t in p.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def last_logits(cfg: dict, w: Dict[str, torch.Tensor], seqs: np.ndarray,
                device, precision: str = None,
                rows_per_block: int = 4) -> torch.Tensor:
    """Logits (B, 2, V) in float32 at the last two positions of each of
    ``seqs`` (B, T) token rows of one length, in blocks of rows; products
    in ``precision``, by default ``PRECISION``."""
    tokens = torch.as_tensor(seqs, device=device).long()
    out = []
    with products(precision or PRECISION) as mm:
        for r in range(0, tokens.shape[0], rows_per_block):
            h = hidden(w, tokens[r:r + rows_per_block], cfg, mm, remat=False)
            out.append(mm(h[:, -2:], w["head"]).float())
    return torch.cat(out)
