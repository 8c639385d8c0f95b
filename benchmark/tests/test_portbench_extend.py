"""A later change adds a configuration, a traffic mix, a per-layer metric
or an answer kind as new files and new entries: the harness lists and
runs them, the control and the fault tests take the kind's hooks from its
module, and no file that was there changes."""

import hashlib
import importlib
import json
import os
import shutil
import sys

import benchmark.answers
from benchmark import control, harness
from benchmark.tests.test_portbench_faults import _altered, _run
from sequila_tpu_torch.session import SessionContext


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_new_files_and_entries_are_enough(tmp_path):
    root = _checkout(tmp_path)
    before = _digests(root / "benchmark")

    config = {
        "name": "tiny-chain", "source": "https://example.org/tiny", "generator": "chain",
        "params": {"median_len": 50_000, "sigma": 1.0, "span": 10_000_000},
        "tables": {"s1": {"rows": 3_000, "seed": 5}, "s2": {"rows": 4_000, "seed": 6}},
        "seed_stride": 2, "reduced": [], "assumed": ["everything"],
    }
    traffic = {
        "query": "SELECT count(*) FROM s2 b JOIN s1 a ON a.contig = b.contig "
                 "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end",
        "join": ["s2", "s1"], "answer": "count",
    }
    reader = "def read(run):\n    return float(len(run.queries))\n"
    (root / "benchmark/configs/tiny-chain.json").write_text(json.dumps(config))
    (root / "benchmark/traffic/tiny-count.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/queries_seen.py").write_text(reader)

    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-chain", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/tiny-chain.json", "reduced": [],
                         "why": "a throwaway configuration"})
    m["workloads"].append({"name": "tiny-count", "config": "tiny-chain",
                           "traffic": "tiny-count", "chips": 1, "why": "a throwaway cell"})
    m["per_layer"].append({"name": "queries_seen", "unit": "queries", "better": "higher",
                           "source": "host_clock", "layer": "client",
                           "moves": "pairs_per_s", "workloads": ["tiny-count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cells = [w["name"] for w in harness.manifest(str(root))["workloads"]]
    assert "tiny-count" in cells
    c = harness.cell("tiny-count", str(root))
    assert [x["name"] for x in c.per_layer if x["name"] == "queries_seen"]
    for trace in (False, True):
        out = harness.run_cell("tiny-count", 3, 0.2, trace, 0.0, device="cpu", root=str(root))
        assert out["result"]["correct"]
    assert out["result"]["metrics"]["queries_seen"]["value"] == len(out["run"].queries)
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/tiny-chain.json", "traffic/tiny-count.json",
                                        "metrics/queries_seen.py"}


# A throwaway kind: the pairs' total returned as a one-row table, judged
# whole, with its control and its fault as the hooks of its module.
KIND = """
import pyarrow as pa

from benchmark import reference


def take(result, keep):
    return {"value": int(result.column_np(0)[0])}


def judge(run):
    left, right = run.traffic["join"]
    ref = int(reference.per_row_counts(run.inputs.tables[left], run.inputs.tables[right]).sum())
    off = 0
    for q in run.queries:
        q["pairs"] = ref
        if "answer" in q:
            q["wrong"] = q["answer"]["value"] != ref
            off = max(off, abs(q["answer"]["value"] - ref))
    return {"total_off": (off, 0)}


def control_answer(a, b):
    return pa.table({"n": [int(reference.per_row_counts(a, b).sum())]})


def alter(table):
    return pa.table({"n": [table.column(0)[0].as_py() - 1]})
"""


def test_a_new_answer_kind_is_one_new_file(tmp_path, monkeypatch):
    """The kind's file lies outside the checkout, on the answers' import
    path; the checkout gains a traffic file and a workload entry only."""
    root = _checkout(tmp_path)
    before = _digests(root)
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    (kinds / "throwaway_total.py").write_text(KIND)
    monkeypatch.setattr(benchmark.answers, "__path__",
                        [*benchmark.answers.__path__, str(kinds)])
    monkeypatch.delitem(sys.modules, "benchmark.answers.throwaway_total", raising=False)
    importlib.invalidate_caches()

    traffic = {
        "query": "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
                 "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end",
        "join": ["s1", "s2"], "answer": "throwaway_total",
    }
    (root / "benchmark/traffic/throwaway-total.json").write_text(json.dumps(traffic))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "genome-throwaway", "config": "databio-genome",
                           "traffic": "throwaway-total", "chips": 1, "why": "a throwaway cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    r = str(root)

    sound = _run("genome-throwaway", root=r)
    assert sound["correct"] and sound["checks"]["total_off"]["value"] == 0
    out = control.control_run("genome-throwaway", seed=3, queries=2, scale=20, root=r)
    assert not out["correct"] and out["checks"]["total_off"]["value"] > 0
    sql = SessionContext.sql
    monkeypatch.setattr(SessionContext, "sql",
                        lambda self, q: _altered(sql(self, q), "throwaway_total"))
    altered = _run("genome-throwaway", root=r)
    assert not altered["correct"] and altered["checks"]["total_off"]["value"] == 1

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == {
        **before, "BENCHMARK.json": after["BENCHMARK.json"]}
    assert set(after) - set(before) == {"benchmark/traffic/throwaway-total.json"}
    m["workloads"].pop()
    assert m == harness.manifest()
