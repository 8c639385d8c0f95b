"""What the benchmark may load: never JAX or the JAX package (top-level
names compared whole, since ``sequila_tpu_torch`` begins with
``sequila_tpu``), and, in the reference's files, nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
REFERENCE_FILES = ["benchmark/reference.py", "benchmark/gen.py", "benchmark/roofline.py",
                   "benchmark/control.py"]

SCRIPT = r"""
import importlib, json, sys
sys.path.insert(0, {root!r})
from benchmark import control, harness, reference, run, tracing
for m in harness.manifest()["per_layer"]:
    harness.metric_reader(m["name"])
for w in harness.manifest()["workloads"]:
    harness.answer_kind(harness.cell(w["name"]).traffic["answer"])
    harness.run_cell(w["name"], 1, 0.2, True, 0.0, device="cpu", scale=2000)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_imports(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "sequila_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sequila_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.probe", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "sequila_tpu.probe", sys)
    assert "sequila_tpu" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    for path in REFERENCE_FILES + glob.glob("benchmark/answers/*.py", root_dir=ROOT):
        names = _top_level_imports(path)
        assert not names & {"sequila_tpu_torch", "sequila_tpu", "jax", "jaxlib", "flax"}, path
