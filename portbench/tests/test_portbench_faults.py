"""Runs with the timed path broken underneath, and the controls, must come
out not correct: the harness's look for a card is skipped and the rest of
a run is driven at a small size on the CPU.  Faults: a step that returns
its state unchanged, half of the batch left out (the mean over the rest),
a token altered where it is produced.  There is no exchange
between chips to leave out: every cell takes one."""
import pytest
import torch

from portbench import calibrate, run
from portbench.tests.conftest import run_tiny, tiny_cell

SEED = 2 ** 31 + 29


def limits_failed(cell, readings) -> bool:
    limits = dict(cell.mix.get("limits", {}))
    checks = {k: (v, limits.get(k, 0)) for k, v in readings.items()}
    return not run.evaluate(checks)


def control(name):
    cell = tiny_cell(name)
    cell.reference = calibrate.memo_reference(cell)
    return cell, calibrate.readings(cell, SEED, "control", 0.3,
                                    torch.device("cpu"))


@pytest.mark.parametrize("name", ["qwen3-1.7b.train", "qwen3-1.7b.prefill"])
def test_control_is_not_correct(name):
    cell, readings = control(name)
    assert limits_failed(cell, readings), readings


def test_train_half_batch_is_not_correct(monkeypatch):
    undo = calibrate.half_batch()
    try:
        out = run_tiny("qwen3-1.7b.train", SEED)
    finally:
        undo()
    assert not out["correct"], out["checks"]


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    from repro_torch.train import optimizer

    def unchanged(params, grads, opt_state, cfg):
        return params, opt_state, {"lr": torch.zeros(()),
                                   "grad_norm": optimizer.global_norm(grads)}
    monkeypatch.setattr(optimizer, "adamw_update", unchanged)
    out = run_tiny("qwen3-1.7b.train", SEED)
    assert not out["correct"]
    assert out["checks"]["change_gap"][0] == pytest.approx(1.0)


def test_prefill_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serve import serve_loop
    inner = serve_loop._next_token

    def altered(logits):
        return (inner(logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(serve_loop, "_next_token", altered)
    out = run_tiny("qwen3-1.7b.prefill", SEED)
    assert not out["correct"]
