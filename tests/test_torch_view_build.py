"""A table's sorted views built by a device sort, through the SQL session.

On a card, ``models/table.py`` builds a sorted view, its per-key extrema
and the min gap there (one stable ``torch.sort`` a view) and copies the
host twins and order back only for a reader that asks.  On the CPU the
host build stays.  The CPU tests route the CPU session through the card's
build (``_on_card`` patched) and hold every route that reads the views to
the host build's answers; the ``cuda`` test does the same on the card
with a fresh table, counting the builds.  No JAX here: the ``cuda`` test
runs on the card.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu_torch.models import table
from sequila_tpu_torch.session import SessionContext
from sequila_tpu_torch.utils import metrics

ON = "ON a.contig = b.contig AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
COUNT = f"SELECT count(*) FROM s1 a JOIN s2 b {ON}"
SELECT = f"SELECT * FROM s1 a JOIN s2 b {ON}"
GROUPED = f"SELECT b.contig, count(*) FROM s1 a JOIN s2 b {ON} GROUP BY b.contig"
COVERAGE = "SELECT * FROM coverage('s2', 's1')"
OVERLAPS = "SELECT * FROM count_overlaps('s2', 's1')"

# (query, environment, views the first query builds on the card's path:
# both tables' two views, or none where the route reads no view)
CASES = {
    "count-merge": (COUNT, {}, 4),
    "count-stream": (COUNT, {"SEQUILA_COUNT_BACKEND": "stream"}, 4),
    "count-cosort": (COUNT, {"SEQUILA_COUNT_BACKEND": "cosort"}, 0),
    "select-merge": (SELECT, {}, 4),
    "grouped": (GROUPED, {}, 4),
    "coverage": (COVERAGE, {}, 4),
    "count_overlaps": (OVERLAPS, {}, 4),
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


def test_views_are_built_on_cards_only():
    assert table._on_card("cuda") and table._on_card(torch.device("cuda", 1))
    assert not table._on_card("cpu") and not table._on_card(None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_build_answers_as_the_host_build(rng, monkeypatch, case):
    """Every route that reads the views, on the CPU with the card's view
    build, against the host build: the same answer on the same route."""
    query, env, builds = CASES[case]
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t1, t2 = _table(rng, 3_000), _table(rng, 4_000)
    want, want_route, none = _answers("cpu", t1, t2, query)
    assert none == 0
    monkeypatch.setattr(table, "_on_card", lambda device: device is not None)
    got, route, built = _answers("cpu", t1, t2, query)
    assert (got, route, built) == (want, want_route, builds)
    if query == COUNT:
        assert got == [(_reference_count(t1, t2),)]


@pytest.mark.cuda
def test_fresh_table_views_on_the_card(rng, monkeypatch):
    """On the card: a fresh s2 against a warm s1 builds s2's two views there
    and the count is the reference's; a repeated query builds none; the
    readers of the lazy host twins and order (the stream count, the device
    SELECT *) and the per-probe and verb plans (the inverse orders) answer
    as the CPU session's host build, each on a fresh s2."""
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
    with metrics.recording() as again:
        assert _rows(card, COUNT) == got
    assert again.counts()["view_device_builds"] == 0
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
