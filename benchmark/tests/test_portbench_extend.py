"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries: the harness lists and runs them,
and no file that was there changes."""

import hashlib
import json
import os
import shutil

from benchmark import harness


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_are_enough(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
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
