"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell's configuration, traffic mix, driver, reference and metric
readers by the names the file gives."""
import json
import re

import pytest

from portbench import harness
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_and_size():
    assert set(BENCH) == TOP_KEYS
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_entries_have_the_contract_keys():
    bench = BENCH
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in bench["end_to_end"] + bench["per_layer"])


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    bench = BENCH
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_config_files_hold_the_reduced_keys():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert c["file"].startswith("portbench/configs/")
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_harness_finds_each_cells_files_by_name(workload):
    cell = harness.Cell(BENCH, workload)
    assert hasattr(cell.driver(), "Driver")
    model = cell.model()
    for fn in ("arch_config", "make_weights", "port_params", "vocab_size",
               "train_step_flops", "prefill_flops"):
        assert callable(getattr(model, fn)), fn
    reference = cell.reference()
    assert reference.__doc__
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    for key in ("driver", "why"):
        assert key in cell.mix


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.BenchError):
        harness.Cell(BENCH, "no-such.cell")


def test_traffic_files_are_data():
    for path in (harness.BENCH_DIR / "traffic").iterdir():
        assert path.suffix == ".json"
        json.loads(path.read_text())


def test_shared_files_name_no_model():
    """What belongs to one model (its widths, weights, FLOPs) sits in its
    configuration's files, so a configuration is added as files."""
    for name in ("harness.py", "flops.py", "generate.py", "run.py",
                 "calibrate.py", "drivers/train.py", "drivers/prefill.py"):
        text = (harness.BENCH_DIR / name).read_text()
        for key in ("hidden_size", "num_hidden_layers", "intermediate_size",
                    "num_attention_heads", "vocab_size\"]", "qk_norm"):
            assert key not in text, (name, key)
