"""The grouped count's answer kind (``benchmark/answers/grouped_count.py``)
on the CPU, in a checkout that adds its cells as a traffic file and a
workload entry each: ``databio-genome`` at 1/500 of its rows, the query
``SELECT b.contig, count(1) ... GROUP BY b.contig``, warm and with a
fresh ``s2``.  A sound run is ``correct``; each way the answer can go
wrong is caught; the control fails; and the per-group reference is a
brute-force loop over the pairs."""

import json
import os
import shutil

import pyarrow as pa
import pytest

from benchmark import control, gen, harness, reference
from benchmark.answers import grouped_count
from benchmark.tests.test_portbench_faults import _altered, _late_run, _run
from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.session import SessionContext

QUERY = ("SELECT b.contig, count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
         "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end GROUP BY b.contig")
TRAFFIC = {
    "genome-grouped-warm": {"query": QUERY, "join": ["s1", "s2"], "answer": "grouped_count"},
    "genome-grouped-fresh": {"query": QUERY, "join": ["s1", "s2"], "answer": "grouped_count",
                             "fresh": {"table": "s2", "pool_factor": 2}},
}
WARM = "genome-grouped-warm"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("grouped") / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = harness.manifest()
    for name, traffic in TRAFFIC.items():
        (root / f"benchmark/traffic/{name}.json").write_text(json.dumps(traffic))
        m["workloads"].append({"name": name, "config": "databio-genome", "traffic": name,
                               "chips": 1, "why": "the grouped count's kind on the CPU"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return str(root)


@pytest.mark.parametrize("name", list(TRAFFIC))
def test_sound_run_is_correct(root, name):
    out = harness.run_cell(name, 11, 1.5, False, 0.0, device="cpu", scale=500, root=root)
    r = out["result"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["groups_off"]["value"] == 0 and r["checks"]["count_off"]["value"] == 0
    answered = [q for q in out["run"].queries if "answer" in q]
    assert answered and all(len(q["answer"]["groups"]) == 24 for q in answered)
    assert all(q["pairs"] == sum(c for _, c in q["answer"]["groups"]) for q in answered)


def _dropped(t: pa.Table) -> pa.Table:
    return t.slice(1)


def _renamed(t: pa.Table) -> pa.Table:
    names = t.column(0).to_pylist()
    names[0] = "chrX"
    return t.set_column(0, t.field(0), pa.array(names, t.field(0).type))


def _halved(t: pa.Table) -> pa.Table:
    return t.slice(0, t.num_rows // 2)


@pytest.mark.parametrize("fault, check", [
    (lambda t: _altered(Table(t), "grouped_count").arrow, "count_off"),
    (_dropped, "groups_off"),
    (_renamed, "groups_off"),
    (_halved, "groups_off"),
], ids=["count_plus_one", "group_dropped", "contig_renamed", "half_the_groups"])
def test_answer_fault_is_caught(root, monkeypatch, fault, check):
    sql = SessionContext.sql
    monkeypatch.setattr(SessionContext, "sql", lambda self, q: Table(fault(sql(self, q).arrow)))
    r = _run(WARM, root=root)
    assert not r["correct"] and r["checks"][check]["value"] > 0


def test_half_the_probe_rows_left_out_is_caught(root, monkeypatch):
    register = SessionContext.register_table

    def half(self, table_name, table):
        if table_name == "s2":
            table = table.slice(0, table.num_rows // 2)
        return register(self, table_name, table)

    monkeypatch.setattr(SessionContext, "register_table", half)
    r = _run(WARM, root=root)
    assert not r["correct"] and r["checks"]["count_off"]["value"] > 0


def test_answer_altered_late_in_the_window_is_caught(root, monkeypatch):
    r = _late_run(WARM, monkeypatch, root=root)
    assert r["attempted"] > 20 and not r["correct"]
    assert r["checks"]["count_off"]["value"] == 1


def test_control_fails(root):
    out = control.control_run(WARM, seed=3, queries=2, scale=20, root=root)
    assert not out["correct"] and out["checks"]["count_off"]["value"] > 0


def _brute_force(a, b) -> dict:
    """{contig of b: pairs}, pair by pair."""
    out = {}
    for j in range(b.rows):
        for i in range(a.rows):
            if (a.code[i] == b.code[j] and a.start[i] <= b.end[j]
                    and b.start[j] <= a.end[i]):
                name = b.names[b.code[j]]
                out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_reference_groups_are_the_pairs(seed):
    params = {"num_contigs": 5, "median_len": 3_000_000, "sigma": 1.5, "within_contig": True}
    a = gen.genome(300, seed, **params)
    b = gen.genome(200, seed + 1, **params)
    want = _brute_force(a, b)
    assert len(want) >= 3 and sum(want.values()) > 200
    assert grouped_count._groups(b, reference.per_row_counts(b, a)) == want
    t = grouped_count.control_answer(a, b)
    assert dict(zip(t.column(0).to_pylist(), t.column(1).to_pylist())) == want
