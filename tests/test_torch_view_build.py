"""A table's sorted views built by a device sort, through the SQL session.

On every device, the CPU included, ``models/table.py`` builds a sorted
view, its per-key extrema and the min gap there (one stable ``torch.sort``
a view) and copies the host twins back only for a reader that asks.  The
CPU tests hold every route that reads the views, on a CPU session, to the
native host index's answers (the default threshold's host route, which
reads no view); the ``cuda`` test holds the card to the CPU session with
a fresh table, counting the builds.  No JAX here: the ``cuda`` test runs
on the card.
"""

import os
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu_torch.session import SessionContext
from sequila_tpu_torch.utils import metrics

ON = "ON a.contig = b.contig AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
COUNT = f"SELECT count(*) FROM s1 a JOIN s2 b {ON}"
SELECT = f"SELECT * FROM s1 a JOIN s2 b {ON}"
GROUPED = f"SELECT b.contig, count(*) FROM s1 a JOIN s2 b {ON} GROUP BY b.contig"
COVERAGE = "SELECT * FROM coverage('s2', 's1')"
OVERLAPS = "SELECT * FROM count_overlaps('s2', 's1')"

# (query, environment, the device route that answers, views its first
# query builds: both tables' two views, or none where the route reads no
# view)
CASES = {
    "count-merge": (COUNT, {}, "count_route_merge", 4),
    "count-stream": (COUNT, {"SEQUILA_COUNT_BACKEND": "stream"}, "count_route_stream", 4),
    "count-cosort": (COUNT, {"SEQUILA_COUNT_BACKEND": "cosort"}, "count_route_cosort", 0),
    "select-merge": (SELECT, {}, "emit_route_merge", 4),
    "grouped": (GROUPED, {}, "probe_count_route_merge", 4),
    "coverage": (COVERAGE, {}, "verb_route_merge", 4),
    "count_overlaps": (OVERLAPS, {}, "verb_route_merge", 4),
}


def _table(rng, n, contigs=("chr1", "chr2", "chr3")):
    s = rng.integers(-5_000, 200_000, n)
    s[: n // 5] = rng.integers(0, 40, n // 5)  # tied (contig, start) rows
    return pa.table({"contig": rng.choice(list(contigs), n), "pos_start": s,
                     "pos_end": s + rng.integers(0, 2_000, n)})


def _reference_count(t1: pa.Table, t2: pa.Table) -> int:
    """Overlapping pairs by brute force, contig by contig."""
    total = 0
    c1, c2 = t1.column("contig").to_numpy(False), t2.column("contig").to_numpy(False)
    for c in np.unique(c1):
        a, b = t1.filter(pa.array(c1 == c)), t2.filter(pa.array(c2 == c))
        s1, e1 = (a.column(k).to_numpy()[:, None] for k in ("pos_start", "pos_end"))
        s2, e2 = (b.column(k).to_numpy()[None, :] for k in ("pos_start", "pos_end"))
        total += int(((e1 >= s2) & (s1 <= e2)).sum())
    return total


def _rows(ctx, query):
    return sorted(map(tuple, (r.values() for r in ctx.sql(query).to_pylist())))


def _route(ctx) -> list[str]:
    return sorted(k for c in ctx.last_metrics.counters.values() for k in c if "_route_" in k)


def _answers(device, t1, t2, query):
    ctx = SessionContext(device=device)
    ctx.register_table("s1", t1)
    ctx.register_table("s2", t2)
    with metrics.recording() as rec:
        rows = _rows(ctx, query)
    return rows, _route(ctx), rec.counts()["view_device_builds"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_answers_as_the_host_route(rng, monkeypatch, case):
    """Every route that reads the views, on a CPU session on the device
    route, against the same query on the default threshold's host route
    (the native host index, which reads no view): the same answer, on the
    route asked for, with the views built on the CPU."""
    query, env, route, builds = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t1, t2 = _table(rng, 3_000), _table(rng, 4_000)
    want, host_route, none = _answers("cpu", t1, t2, query)
    assert none == 0 and len(host_route) == 1 and host_route[0].endswith("_route_host")
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    got, got_route, built = _answers("cpu", t1, t2, query)
    assert (got, got_route, built) == (want, [route], builds)
    if query == COUNT:
        assert got == [(_reference_count(t1, t2),)]


@pytest.mark.parametrize("query,dict_span", [(COUNT, "table.dict_device"),
                                             (SELECT, "table.dict_codes")],
                         ids=["count", "select"])
def test_cpu_session_builds_its_views_on_the_cpu(rng, query, dict_span):
    """A CPU session on the device route builds both tables' two views on
    the CPU by the card's build and copies none back (the device SELECT *
    reads the orders on the device); the count codes both key columns
    there too, while the SELECT *'s level index asks for host codes first
    (Arrow's encoder).  The count narrows every int64 bound column on the
    CPU as on a card, a fresh s2 its two, and none on the host; the SELECT
    *'s level index narrows them on the host first, and the views upload
    that narrowing.  The answers are the host route's."""
    t1, t2 = _table(rng, 3_000), _table(rng, 4_000)
    want, _, _ = _answers("cpu", t1, t2, query)
    with mock.patch.dict(os.environ, {"SEQUILA_HOST_THRESHOLD": "0"}):
        ctx = SessionContext(device="cpu")
        ctx.register_table("s1", t1)
        ctx.register_table("s2", t2)
        with metrics.recording() as rec:
            got = _rows(ctx, query)
        ctx.register_table("s2", t2)  # a fresh Table: no cached column
        with metrics.recording() as fresh:
            assert _rows(ctx, query) == want
        with metrics.recording() as again:
            assert _rows(ctx, query) == want
    assert got == want
    names = {s.name for s in rec.events().spans}
    assert rec.counts()["view_device_builds"] == 4
    assert dict_span in names and "table.view_host" not in names
    assert rec.counts()["dict_device_builds"] == (2 if dict_span == "table.dict_device" else 0)
    on_device = query == COUNT
    assert rec.counts()["i32_device_narrowings"] == 4 * on_device
    assert fresh.counts()["i32_device_narrowings"] == 2 * on_device
    assert again.counts()["i32_device_narrowings"] == 0
    fresh_names = {s.name for s in fresh.events().spans}
    assert ("table.column_device" in fresh_names) == on_device
    assert ("table.column_i32" in fresh_names) == (not on_device)  # the level index


@pytest.mark.cuda
def test_fresh_table_views_on_the_card(rng, monkeypatch):
    """On the card: a fresh s2 against a warm s1 builds s2's two views there
    and the count is the reference's; a repeated query builds none; the
    reader of the lazy host twins (the stream count), the device SELECT *
    (the orders) and the per-probe and verb plans (the inverse orders)
    answer as the CPU session, each on a fresh s2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda)")
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    s1 = _table(rng, 30_000)
    card, cpu = SessionContext(device="cuda"), SessionContext(device="cpu")
    for ctx in (card, cpu):
        ctx.register_table("s1", s1)
        ctx.register_table("s2", _table(rng, 1_000))
    _rows(card, COUNT)  # s1's views, once

    def fresh(n):
        t = _table(rng, n)
        for ctx in (card, cpu):
            ctx.register_table("s2", t)
        return t

    s2 = fresh(50_000)
    with metrics.recording() as first:
        got = _rows(card, COUNT)
    assert _route(card) == ["count_route_merge"]
    assert got == [(_reference_count(s1, s2),)] == _rows(cpu, COUNT)
    assert first.counts()["view_device_builds"] == 2
    # s2's int64 bounds uploaded as they are and narrowed on the card
    assert first.counts()["i32_device_narrowings"] == 2
    assert "table.column_i32" not in {s.name for s in first.events().spans}
    with metrics.recording() as again:
        assert _rows(card, COUNT) == got
    assert again.counts()["view_device_builds"] == 0
    assert again.counts()["i32_device_narrowings"] == 0
    for query, env in ((COUNT, {"SEQUILA_COUNT_BACKEND": "stream"}), (SELECT, {}),
                       (GROUPED, {}), (COVERAGE, {})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        fresh(20_000)
        with metrics.recording() as rec:
            got = _rows(card, query)
        assert rec.counts()["view_device_builds"] == 2, query
        assert got == _rows(cpu, query), query
        assert _route(card) == _route(cpu), query
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("bad", [2**31, -(2**31) - 1])
def test_bound_contract_on_the_device(rng, monkeypatch, device, bad):
    """The reference's evaluate_as_i32 contract where a fresh s2's int64
    bounds are narrowed on the session's device: a value outside i32
    raises the host narrowing's CastOverflowError, naming the first such
    value in row order, and a NULL bound raises ExecutionError."""
    from sequila_tpu_torch.errors import CastOverflowError, ExecutionError
    from sequila_tpu_torch.models.table import Table

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda)")
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    t2 = _table(rng, 4_000)
    ends = t2.column("pos_end").to_numpy().copy()
    ends[[1_000, 3_000]] = bad, -(2**40) * np.sign(bad)
    over = t2.set_column(2, "pos_end", pa.array(ends))
    msg = f"^Can't cast value {bad} to type Int32$"
    with pytest.raises(CastOverflowError, match=msg):
        Table(over).column_as_i32("pos_end")
    s1 = _table(rng, 3_000)
    ctx = SessionContext(device=device)
    ctx.register_table("s1", s1)
    ctx.register_table("s2", over)
    with pytest.raises(CastOverflowError, match=msg):
        ctx.sql(COUNT)
    with pytest.raises(CastOverflowError, match=msg):
        Table(over).device_i32("pos_end", device)
    starts = pa.array(t2.column("pos_start").to_pylist()[:-1] + [None], pa.int64())
    ctx.register_table("s2", t2.set_column(1, "pos_start", starts))
    with pytest.raises(ExecutionError, match="contains NULLs"):
        ctx.sql(COUNT)
    ctx.register_table("s2", t2)
    assert _rows(ctx, COUNT) == [(_reference_count(s1, t2),)]
