"""The port's serving substrate against ``repro``'s.

``SlotBatcher`` is driven through the same operations on both sides; the
slot loop of ``examples/serve_model.py`` runs in ``repro`` (written out
here, as the example hard-codes its sizes) and through the port's
``serve_requests`` on the same float32 weights and prompts, and every
request's generated tokens must be equal; so must ``greedy_generate``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import SlotBatcher as JSlotBatcher
from repro.serve import build_serve_fns as jbuild_serve_fns
from repro.serve import greedy_generate as jgreedy
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import (Request, SlotBatcher, build_serve_fns,
                               greedy_generate, serve_requests)


def test_slot_batcher_lifecycle():
    b = SlotBatcher(num_slots=2)
    for rid in range(5):
        b.submit(Request(rid, np.zeros(4, np.int32), max_new_tokens=3))
    assert b.pending == 5 and b.active == 0
    b.fill_slots()
    assert b.active == 2 and b.pending == 3
    for _ in range(3):                      # 3 decode steps finish both
        b.record_tokens(np.array([7, 8]))
    assert len(b.completed) == 2
    assert b.completed[0].generated == [7, 7, 7]
    b.fill_slots()
    assert b.active == 2 and b.pending == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_batcher_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = SlotBatcher(3), JSlotBatcher(3)
    rid = 0
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(1, 5))
            for b, cls in ((ours, Request), (theirs, JRequest)):
                b.submit(cls(rid, np.zeros(2, np.int32), max_new_tokens=n))
            rid += 1
        elif op == 1:
            assert ours.fill_slots() == theirs.fill_slots()
        else:
            toks = rng.integers(0, 100, 3)
            ours.record_tokens(toks)
            theirs.record_tokens(toks)
        assert (ours.active, ours.pending) == (theirs.active, theirs.pending)
        assert ([r.request_id if r else None for r in ours.slots]
                == [r.request_id if r else None for r in theirs.slots])
    assert ([(r.request_id, r.generated) for r in ours.completed]
            == [(r.request_id, r.generated) for r in theirs.completed])


def reference_slot_loop(model, params, batcher, num_slots, prompt_len,
                        max_len):
    """``examples/serve_model.py``'s loop in ``repro``."""
    prefill_fn, decode_fn = jbuild_serve_fns(model, max_len)
    cache = None
    while batcher.pending or batcher.active:
        newly = batcher.fill_slots()
        if newly or cache is None:
            prompts = np.zeros((num_slots, prompt_len), np.int32)
            for i, req in enumerate(batcher.slots):
                if req is not None:
                    prompts[i] = req.prompt
            logits, cache = prefill_fn(params, {"tokens":
                                                jnp.asarray(prompts)})
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        while batcher.active and not any(
                s is None for s in batcher.slots) or (
                batcher.active and not batcher.pending):
            logits, cache = decode_fn(params, {"tokens": tok}, cache)
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            batcher.record_tokens(np.asarray(tok[:, 0]))
            if int(cache["index"]) >= max_len - 1:
                break
        if not batcher.pending and not batcher.active:
            break


def float32_models(name, seed):
    jm = jbuild_model(jget_arch(name, smoke=True))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(seed)))
    cfg = get_arch(name, smoke=True)
    m = build_model(cfg, device="cpu")
    p = convert.transformer_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu", dtype=torch.float32)
    return jm, jp, m, p


@pytest.mark.parametrize("requests,new_tokens", [(10, 12), (7, 5)])
def test_serve_requests_equals_the_reference_loop(requests, new_tokens):
    jm, jp, m, p = float32_models("qwen3-1.7b", 0)
    num_slots, prompt_len, max_len = 4, 16, 64
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab, prompt_len)
               for _ in range(requests)]
    ours, theirs = SlotBatcher(num_slots), JSlotBatcher(num_slots)
    for rid, prompt in enumerate(prompts):
        ours.submit(Request(rid, prompt, max_new_tokens=new_tokens))
        theirs.submit(JRequest(rid, prompt, max_new_tokens=new_tokens))
    prefill_fn, decode_fn = build_serve_fns(m, max_len)
    counts = serve_requests(ours, prefill_fn, decode_fn, p, prompt_len,
                            max_len, m.device)
    reference_slot_loop(jm, jp, theirs, num_slots, prompt_len, max_len)
    assert len(ours.completed) == requests
    assert ([(r.request_id, r.generated) for r in ours.completed]
            == [(r.request_id, r.generated) for r in theirs.completed])
    assert counts["tokens_out"] <= requests * new_tokens
    assert counts["prefills"] >= -(-requests // num_slots)


def test_greedy_generate_matches_the_reference():
    jm, jp, m, p = float32_models("chatglm3-6b", 2)
    prompt = np.random.default_rng(3).integers(0, m.cfg.vocab, (2, 10))
    got = greedy_generate(m, p, prompt, steps=6)
    assert got.shape == (2, 6) and got.dtype == torch.int64
    want = jgreedy(jm, jp, jnp.asarray(prompt), steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = m.forward(p, {"tokens": prompt})
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  logits[:, -1].argmax(-1).numpy())
