"""``correct`` has to come out false where it should.

Each cell runs here on the CPU (the port's ``device="cpu"``, the
kernels' plain versions) at a small size, past the harness's look for a
card: first sound, then with the timed path broken underneath in each
way the cell can break: an answer altered where it is produced, half of
the work left out, and, where a table is registered afresh, the old
table answering for the new one.  The control (the reference in float32
coordinates in the program's place) has to fail every cell too.  A kind
that defines ``alter(table)`` in its module alters its own answers here,
as ``control.py`` takes a kind's ``control_answer``.
"""

import numpy as np
import pyarrow as pa
import pytest

from benchmark import control, harness
from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.session import SessionContext

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SCALE = 500  # rows of every table over 500


def _run(name, seed=11, seconds=1.5, root=harness.ROOT):
    out = harness.run_cell(name, seed, seconds, False, 0.0, device="cpu", scale=SCALE,
                           root=root)
    return out["result"]


def _answer_kind(name, root=harness.ROOT):
    return harness.cell(name, root).traffic["answer"]


def _altered(result, kind):
    """The result with one value changed where it is produced: by the
    kind's own ``alter`` where its module defines one."""
    alter = getattr(harness.answer_kind(kind), "alter", None)
    if alter is not None:
        return Table(alter(result.arrow))
    if kind == "count":
        return Table(pa.table({"n": [int(result.column_np(0)[0]) + 1]}))
    if kind == "coverage":
        t = result.arrow
        i = t.column_names.index("count")
        counts = t.column(i).to_numpy().copy()
        counts[len(counts) // 2] += 1
        return Table(t.set_column(i, "count", pa.array(counts)))
    raise AssertionError(f"benchmark/answers/{kind}.py defines no alter(table)")


def _late_run(name, monkeypatch, root=harness.ROOT):
    """A run whose answers are altered from query 9 on (the warm-up is the
    first call), with more than 20 queries in its window.  Under load a
    1.5 s window can see fewer: the run is made again, with a window long
    enough for twice that many at the pace the last run saw, until it sees
    enough."""
    kind = _answer_kind(name, root)
    sql, calls = SessionContext.sql, []

    def late(self, q):
        calls.append(q)
        out = sql(self, q)
        return _altered(out, kind) if len(calls) > 10 else out

    monkeypatch.setattr(SessionContext, "sql", late)
    seconds = 1.5
    for _ in range(4):
        calls.clear()
        r = _run(name, seconds=seconds, root=root)
        if r["attempted"] > 20:
            break
        seconds *= 2 * 21 / max(r["attempted"], 1)
    return r


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_is_caught(name, monkeypatch):
    kind = _answer_kind(name)
    sql = SessionContext.sql
    monkeypatch.setattr(SessionContext, "sql", lambda self, q: _altered(sql(self, q), kind))
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_late_in_the_window_is_caught(name, monkeypatch):
    """A fault that shows only after some repeats (a cache or a reused
    buffer gone stale): the kept answers are drawn from the whole window.
    The fault starts at query 9; at seed 11 the sample first keeps a query
    from there at query 20."""
    r = _late_run(name, monkeypatch)
    assert r["attempted"] > 20 and not r["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_left_out_is_caught(name, monkeypatch):
    """Counts see half of the probe table; any other kind loses half the
    rows of its answer."""
    kind = _answer_kind(name)
    if kind == "count":
        register = SessionContext.register_table

        def half(self, table_name, table):
            if table_name == "s2":
                table = table.slice(0, table.num_rows // 2)
            return register(self, table_name, table)

        monkeypatch.setattr(SessionContext, "register_table", half)
    else:
        sql = SessionContext.sql

        def half_rows(self, q):
            t = sql(self, q)
            return Table(t.arrow.slice(0, t.num_rows // 2))

        monkeypatch.setattr(SessionContext, "sql", half_rows)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", [c for c in CELLS if harness.cell(c).traffic.get("fresh")])
def test_state_left_unchanged_is_caught(name, monkeypatch):
    """The fresh table's registration is dropped: the first one answers."""
    register = SessionContext.register_table

    def first_only(self, table_name, table):
        if table_name.lower() not in self.catalog:
            register(self, table_name, table)

    monkeypatch.setattr(SessionContext, "register_table", first_only)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    out = control.control_run(name, seed=3, queries=2, scale=20)
    assert not out["correct"]
    assert max(c["value"] for c in out["checks"].values()) > 0


def test_traced_run_reads_its_spans_and_counters():
    name = next(c for c in CELLS if _answer_kind(c) == "count")
    out = harness.run_cell(name, 5, 0.3, True, 0.0, device="cpu", scale=SCALE)
    metrics = out["result"]["metrics"]
    assert out["result"]["correct"]
    assert metrics["front_end_ms"]["value"] > 0 and metrics["execute_ms"]["value"] > 0
    assert 0 <= metrics["device_route_share"]["value"] <= 100
    kinds = {s[0] for s in out["run"].spans}
    assert kinds == {"client", "front_end", "execute"}
    assert np.all(np.diff([s[1] for s in out["run"].spans]) >= 0)


def test_traced_verb_run_reports_its_verb_span():
    """A table function's verb runs while its plan is bound: that span is
    ``verb``, read by ``verb_ms``, and the front end's split is not read."""
    name = next(c for c in CELLS if _answer_kind(c) == "coverage")
    out = harness.run_cell(name, 5, 0.3, True, 0.0, device="cpu", scale=SCALE)
    metrics = out["result"]["metrics"]
    assert out["result"]["correct"] and metrics["verb_ms"]["value"] > 0
    assert not {"front_end_ms", "execute_ms"} & set(metrics)
    assert {s[0] for s in out["run"].spans} == {"client", "verb", "execute"}


def _final_slots(seed, n):
    r, queries = harness.Reservoir(2, seed), [{} for _ in range(n)]
    for i in range(n):
        r.admit(i, queries)
    return r.slots


def test_reservoir_draws_from_the_whole_window():
    """Two answers stay kept, the dropped ones are cleared, and the kept
    ones are drawn evenly from the whole window."""
    queries, sample = [], harness.Reservoir(2, 2**31 + 5)
    for i in range(1_000):
        keep = sample.admit(i, queries)
        queries.append({"answer": {"kept": i if keep else None}})
    kept = [i for i, q in enumerate(queries) if q["answer"]["kept"] is not None]
    assert kept == sorted(sample.slots) and len(kept) == 2
    slots = [i for seed in range(200) for i in _final_slots(seed, 1_000)]
    assert 0.4 < sum(i >= 500 for i in slots) / len(slots) < 0.6
