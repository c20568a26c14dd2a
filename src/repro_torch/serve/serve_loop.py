"""Serving: prefill + decode steps, greedy generation and the slot loop.

``build_serve_fns`` is the counterpart of ``repro.serve.serve_loop``'s:
the two steps run under :func:`torch.inference_mode` (no CUDA graphs and
no ``torch.compile``), and the decode step updates its cache in place
where the reference donates it.  :func:`serve_requests` is the
fixed-slot continuous-batching loop of ``examples/serve_model.py``, line
for line.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.factory import ModelBundle
from repro_torch.serve.batching import SlotBatcher


def build_serve_fns(model: ModelBundle, max_len: int):
    """Returns (prefill_fn, decode_fn); decode updates its cache in place."""
    prefill_fn = torch.inference_mode()(
        functools.partial(_prefill, model, max_len))
    decode_fn = torch.inference_mode()(functools.partial(_decode, model))
    return prefill_fn, decode_fn


def _prefill(model, max_len, params, batch):
    return model.prefill(params, batch, max_len=max_len)


def _decode(model, params, batch, cache):
    return model.decode_step(params, batch, cache)


def _next_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def greedy_generate(model: ModelBundle, params, prompt, steps: int,
                    max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy decoding: prompt (B, T) -> generated (B, steps) int64."""
    prompt = torch.as_tensor(prompt, device=model.device)
    B, T = prompt.shape
    max_len = max_len or (T + steps)
    prefill_fn, decode_fn = build_serve_fns(model, max_len)
    logits, cache = prefill_fn(params, {"tokens": prompt})
    out = []
    tok = _next_token(logits)
    for _ in range(steps):
        out.append(tok)
        logits, cache = decode_fn(params, {"tokens": tok}, cache)
        tok = _next_token(logits)
    return torch.cat(out, dim=1)


def serve_requests(batcher: SlotBatcher, prefill_fn, decode_fn, params,
                   prompt_len: int, max_len: int, device) -> Dict[str, int]:
    """Serve every request of ``batcher`` to completion.

    Whenever slots were refilled, the whole slot batch is prefilled (empty
    slots carry zero prompts); then one decode step over all slots runs per
    token until a slot frees with requests waiting, or until the last
    request ends.  Returns the counts of prefills, decode steps and tokens
    recorded for active slots.
    """
    num_slots = batcher.num_slots
    tokens_out = prefills = decodes = 0
    cache = None
    while batcher.pending or batcher.active:
        newly = batcher.fill_slots()
        if newly or cache is None:
            # (Re)prefill the whole slot batch; empty slots carry zeros.
            prompts = np.zeros((num_slots, prompt_len), np.int64)
            for i, req in enumerate(batcher.slots):
                if req is not None:
                    prompts[i] = req.prompt
            logits, cache = prefill_fn(
                params, {"tokens": torch.as_tensor(prompts, device=device)})
            prefills += 1
            tok = _next_token(logits)
        # decode until some slot finishes
        while batcher.active and not any(
                s is None for s in batcher.slots) or (
                batcher.active and not batcher.pending):
            logits, cache = decode_fn(params, {"tokens": tok}, cache)
            decodes += 1
            tok = _next_token(logits)
            batcher.record_tokens(tok[:, 0].cpu().numpy())
            tokens_out += batcher.active
            if int(cache["index"]) >= max_len - 1:
                break
        if not batcher.pending and not batcher.active:
            break
    return {"prefills": prefills, "decode_steps": decodes,
            "tokens_out": tokens_out}
