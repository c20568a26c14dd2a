"""Shared fixtures of the benchmark's CPU tests: each cell at a tiny size
(the same drivers, generators, references and readers as on the card, the
widths and counts cut so that a run takes seconds on the CPU)."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"name": "tiny-qwen3", "source": "test",
              "hidden_size": 64, "intermediate_size": 192,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 487,
              "rms_norm_eps": 1e-6, "rope_theta": 1e6, "hidden_act": "silu",
              "torch_dtype": "bfloat16"}
#: The training cell's model at a size where its checks separate sound
#: runs from the control and the faults on the CPU (d 256: the program's
#: change gap 0.007-0.011, the int8 control's 0.041-0.046, half a batch's
#: 0.22-0.27 over two seeds), with limits set from those readings.
SMALL_MODEL = dict(TINY_MODEL, name="small-qwen3", hidden_size=256,
                   intermediate_size=1024, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, vocab_size=2048)
TINY_MIX = {"train": {"batch": 4, "seq_len": 128, "docs": 300,
                      "traced_units": 1,
                      "limits": {"loss_gap": 1e-3, "first_grad_gap": 0.01,
                                 "change_gap": 0.025}},
            "prefill": {"slots": 8, "blocks": 512, "median": 48,
                        "min_len": 16, "max_len": 128, "pad_to": 16,
                        "check_requests": 24, "traced_units": 1,
                        "limits": {"logit_gap": 0.05}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def bench() -> dict:
    from portbench import harness
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def tiny_cell(name: str):
    """The cell ``name`` cut to a tiny size."""
    from portbench import harness
    cell = harness.Cell(bench(), name)
    if cell.mix["driver"] == "train":
        cell.config = SMALL_MODEL
    else:
        cell.config = TINY_MODEL
    cell.mix = dict(cell.mix, **TINY_MIX[cell.workload["traffic"]])
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 17, seconds: float = 0.3):
    import torch
    from portbench import run
    return run.run_cell(tiny_cell(name), seed, seconds, False,
                        torch.device("cpu"), time.perf_counter())


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread while a benchmark test runs: the suite runs in
    several worker processes at once, and torch's thread pools would
    oversubscribe the cores (a tiny training run slows from seconds to
    minutes)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
