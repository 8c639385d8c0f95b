"""``BENCHMARK.json`` against the contract's shape, every entry resolved
to its files by name, and ``run.py`` refusing to run without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import gen, harness

ROOT = harness.ROOT
MANIFEST = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head|expansion|per_tok")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    with open(os.path.join(ROOT, c["file"])) as f:
        body = json.load(f)
    assert body["name"] == c["name"] and body["source"] == c["source"]
    assert body["reduced"] == c["reduced"] and not any(WIDTHS.search(k) for k in c["reduced"])
    assert body["generator"] in gen.GENERATORS and body["assumed"]
    assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    files = [x["file"] for x in MANIFEST["configs"]]
    assert files.count(c["file"]) == 1


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    c = harness.cell(w["name"])
    harness.answer_kind(c.traffic["answer"])
    assert set(c.traffic["join"]) <= set(c.config["tables"])
    ends = {m["name"] for m in c.end_to_end}
    assert "setup_s" in ends and len(ends) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in ends


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_resolves(m):
    assert callable(harness.metric_reader(m["name"]))
    assert {m["moves"]} <= {e["name"] for e in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_run_fails_without_a_card_before_any_input(monkeypatch):
    """Without a card ``main`` returns non-zero and prints nothing on
    standard output; no generator is called."""
    import torch

    from benchmark import run

    def refuse(*a, **k):
        raise AssertionError("an input was generated")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in list(gen.GENERATORS):
        monkeypatch.setitem(gen.GENERATORS, name, refuse)
    cell = MANIFEST["workloads"][0]["name"]
    assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1"]) != 0


def test_run_script_fails_on_this_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = MANIFEST["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr
