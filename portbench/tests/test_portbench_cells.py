"""Each cell at a tiny size through the CPU paths of the same drivers,
references and readers the card runs, and the result line they make."""
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness, run
from portbench.tests.conftest import ROOT, bench, run_tiny, tiny_cell

CELLS = [w["name"] for w in bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_is_correct_and_reports_its_metrics(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = tiny_cell(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    line = run.result_line(out, "cpu", 1, "none")
    assert list(line) == KEYS
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.loads(json.dumps(line))


def test_traced_line_carries_device_busy_and_breakdown():
    trace = {"busy_s": 1.0, "window_s": 2.0,
             "breakdown": {"device_ops": [["k", 1.0]],
                           "idle_gaps": [["host", 1.0]]}}
    out = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
           "peak": 5, "trace": trace, "checks": {"x": (0.0, 1.0)}}
    line = run.result_line(out, "gpu", 1, "none")
    assert list(line) == KEYS[:-1] + ["breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.0
    assert line["device"]["window_s"] == 2.0


def test_a_run_without_a_card_exits_2_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1"],
        capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""


def test_same_seed_same_inputs():
    import torch
    from portbench import generate
    cell = tiny_cell("qwen3-1.7b.prefill")
    model = cell.model()
    a = model.make_weights(cell.config, harness.torch_seed(2 ** 33 + 1, 0),
                           torch.device("cpu"))
    b = model.make_weights(cell.config, harness.torch_seed(2 ** 33 + 1, 0),
                           torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert harness.torch_seed(2 ** 33 + 1, 0) == harness.torch_seed(
        2 ** 33 + 1, 0) != harness.torch_seed(2 ** 33 + 1, 1)
    rounds = generate.length_rounds(
        generate.prompt_lengths(64, 2048, 0.7, 512, 8192), 8)
    la = generate.round_blocks(rounds, 3, harness.numpy_rng(1, 1))
    lb = generate.round_blocks(rounds, 3, harness.numpy_rng(2, 1))
    for blk in range(3):      # every block holds each round once
        a, b = la[blk * 8:(blk + 1) * 8], lb[blk * 8:(blk + 1) * 8]
        assert sorted(map(tuple, a)) == sorted(map(tuple, rounds.tolist()))
        assert sorted(map(tuple, b)) == sorted(map(tuple, rounds.tolist()))
    assert not np.array_equal(la, lb)


def test_rounds_hold_neighbouring_lengths():
    from portbench import generate
    lengths = generate.prompt_lengths(256, 2048, 0.7, 512, 8192)
    assert lengths.min() >= 512 and lengths.max() == 8192
    assert np.all(np.diff(lengths) >= 0)
    assert np.median(lengths) == pytest.approx(2048, rel=0.01)
    rounds = generate.length_rounds(lengths[::-1].copy(), 32)
    assert rounds.shape == (8, 32)
    assert np.all(rounds[1:].min(1) >= rounds[:-1].max(1))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         workload, "--seed", str(2 ** 31 + 9), "--seconds", "2"],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
