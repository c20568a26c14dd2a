"""A run loads neither JAX nor the JAX package ``repro`` (top-level module
names compared whole: ``repro_torch`` is the port), and the plain
references import nothing of the program."""
import ast
import json
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT, bench

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path[:0] = [{root!r}, {src!r}]
from portbench.tests.conftest import run_tiny
from portbench import harness
for name in {cells!r}:
    run_tiny(name, seconds=0.1)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""


def test_tiny_runs_load_no_jax_and_no_repro():
    cells = [w["name"] for w in bench()["workloads"]]
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"),
                                            cells=cells)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    top, flagged = (json.loads(x) for x in proc.stdout.splitlines()[-2:])
    assert "repro_torch" in top and "portbench" in top
    assert not FORBIDDEN & set(top)
    assert flagged == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert harness.forbidden_modules() == sorted(
        m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)
    assert "repro_torch_like" not in harness.forbidden_modules()


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_references_import_nothing_of_the_program():
    refs = sorted((harness.BENCH_DIR / "reference").glob("*.py"))
    assert refs
    for path in refs:
        assert not imported(path) & (FORBIDDEN | {"repro_torch",
                                                  "portbench"}), path


def test_benchmark_sources_import_no_jax_or_repro():
    for path in harness.BENCH_DIR.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path
