"""Every cell on the card, a short window, traced and not: the result
line's shape and ``correct``.  Run on a machine with a card:

    python3 -m pytest benchmark/tests -m cuda -q

A cell that asks for more cards than the machine has is skipped there.
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    chips = harness.cell(name).workload["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} needs {chips} cards; torch.cuda sees {torch.cuda.device_count()}")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        "2718281828", "--seconds", "3", "--trace", str(trace)],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == chips
    c = harness.cell(name)
    wanted = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) == wanted
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10
