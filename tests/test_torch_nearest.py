"""Port parity: the nearest join (CoitreesNearest).

``nearest_from_bounds`` / ``nearest_match`` of sequila_tpu_torch against
the JAX package's on the same seeded tables (ties of every kind, absent
keys, bucket-full levels, distances at the int32 extremes), and the
nearest ``SELECT *`` through ``SessionContext(device="cpu").sql`` against
the JAX session on the device route (SEQUILA_HOST_THRESHOLD=0) and the
host route (the default), row for row, NULL build sides included.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.ops import interval_index as jidx
from sequila_tpu.ops import interval_join as jij
from sequila_tpu_torch.ops import interval_index as tidx
from sequila_tpu_torch.ops import interval_join as tij

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _both(bk, bs, be, qk, qs, qe):
    """(port nearest_match, JAX nearest_match) of one build and probe set."""
    arrs = [np.asarray(a, np.int32) for a in (bk, bs, be, qk, qs, qe)]
    got = tij.nearest_match(tidx.build_interval_index(*arrs[:3], device="cpu"),
                            *(torch.from_numpy(a) for a in arrs[3:]))
    want = jij.nearest_match(jidx.build_interval_index(*(jnp.asarray(a) for a in arrs[:3])),
                             *(jnp.asarray(a) for a in arrs[3:]))
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


def _tied(rng, n, m, span=300):
    """Build and probe sets on a narrow span: overlap ties (equal start and
    end), upstream ties (equal ends), downstream ties (equal starts),
    equal distances both ways, probe keys absent from the build."""
    bk = rng.integers(0, 3, n)
    bs = rng.integers(0, span, n)
    be = bs + rng.integers(0, 12, n)
    dup = rng.integers(0, n, n // 4)
    bs[dup[: len(dup) // 2]] = bs[0]
    be[dup[len(dup) // 2:]] = be[1]
    qk = rng.integers(0, 4, m)  # key 3 is absent from the build
    qs = rng.integers(-20, span + 20, m)
    qe = qs + rng.integers(0, 6, m)
    return bk, bs, be, qk, qs, qe


class TestNearestFromBounds:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_ties_equal_jax(self, seed):
        rng = np.random.default_rng(seed)
        got, want = _both(*_tied(rng, 400, 1500))
        np.testing.assert_array_equal(got, want)
        assert (got == -1).any() and (got >= 0).any()

    def test_same_bounds_equal_jax(self, rng):
        """nearest_from_bounds alone, fed the JAX package's own bounds and
        level view: the reduction is the port's, the inputs identical."""
        bk, bs, be, qk, qs, qe = (np.asarray(a, np.int32) for a in _tied(rng, 300, 800))
        j = jidx.build_interval_index(jnp.asarray(bk), jnp.asarray(bs), jnp.asarray(be))
        jq = [jnp.asarray(a) for a in (qk, qs, qe)]
        lb, ub = jij.overlap_bounds(j, *jq)
        want = jij.nearest_from_bounds(
            lb, ub, j.levels, j.keys, j.starts, j.ends, j.pos, *jq,
            level_offsets=j.level_offsets, level_pad=j.level_pad)
        t = lambda a: torch.from_numpy(np.array(a))
        got = tij.nearest_from_bounds(
            t(lb), t(ub), *(t(a) for a in (j.levels, j.keys, j.starts, j.ends, j.pos)),
            *(torch.from_numpy(a) for a in (qk, qs, qe)),
            level_offsets=j.level_offsets, level_pad=j.level_pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("kind", ["overlap", "upstream", "downstream", "equidistant"])
    def test_canonical_tie_breaks(self, kind):
        # rows: 0 [10, 20], 1 [10, 15], 2 [12, 20], 3 [10, 15] on key 0
        bk, bs, be = [0, 0, 0, 0], [10, 10, 12, 10], [20, 15, 20, 15]
        q, pick = {
            "overlap": ((11, 11), 1),  # min (start, end, row): row 1 of 1 and 3
            "upstream": ((30, 31), 2),  # max (end, start, row): row 2 of 0 and 2
            "downstream": ((0, 5), 1),  # min (start, end, row): row 1 of 1 and 3
            "equidistant": ((-5, -5), 1),  # no upstream row: downstream
        }[kind]
        got, want = _both(bk, bs, be, [0], [q[0]], [q[1]])
        np.testing.assert_array_equal(got, want)
        assert got[0] == pick

    def test_upstream_wins_an_equal_distance(self):
        got, want = _both([0, 0], [0, 20], [5, 25], [0], [10], [15])
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0

    def test_full_bucket_level(self):
        """64 rows in one key fill level 0's bucket (no pad): a probe
        downstream of every row must not read the next level's entry."""
        n = 64
        bs = np.arange(0, 10 * n, 10)
        got, want = _both(np.zeros(n), bs, bs + 5, [0, 0], [10_000, 633], [10_005, 634])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [63, 63])

    def test_absent_keys(self, rng):
        bk, bs, be, _, qs, qe = _tied(rng, 200, 300)
        got, want = _both(bk, bs, be, rng.integers(5, 9, 300), qs, qe)
        np.testing.assert_array_equal(got, want)
        assert (got == -1).all()

    def test_int32_extreme_distances(self):
        """JAX subtracts in int32 and saturates a wrapped distance at
        INT32_MAX, so two candidates at least that far tie (upstream wins)
        and a lone downstream candidate that far loses to the absent
        upstream one (a negative row: NULL).  The port keeps both."""
        bk = [0, 0, 1, 2, 2]
        bs = [I32_MIN, I32_MAX, I32_MAX - 1, I32_MIN, I32_MIN + 10]
        be = [I32_MIN, I32_MAX, I32_MAX, I32_MIN + 1, I32_MIN + 20]
        qk = [0, 0, 1, 1, 2]
        qs = [0, -1, -1, I32_MAX - 100, I32_MAX]
        qe = [0, -1, -1, I32_MAX - 50, I32_MAX]
        got, want = _both(bk, bs, be, qk, qs, qe)
        np.testing.assert_array_equal(got, want)
        # true distances 2^31 up and 2^31 - 1 down: saturated, a tie, so
        # upstream (an int64 distance would pick downstream)
        assert got[0] == 0
        assert got[1] == 0  # 2^31 - 1 up and 2^31 down: the same tie
        assert got[2] < 0  # only downstream, 2^31 away: JAX's no-match
        assert got[3] == 2  # downstream, 49 away
        assert got[4] == 4  # upstream, near 2^32 away: saturated but alone

    def test_reference_fixture(self):
        """The reference's nearest test (integration_test.rs:352-399) as
        the JAX package's tests/test_interval_kernels.py states it."""
        got, want = _both([0], [5], [10], [0, 0, 1, 2], [12, 21, 1, 2], [12, 20, 0, 1])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [0, 0, -1, -1])


def _sessions(tables, threshold, monkeypatch):
    from sequila_tpu.session import SessionContext as JaxSession
    from sequila_tpu_torch.session import SessionContext as TorchSession

    if threshold is None:
        monkeypatch.delenv("SEQUILA_HOST_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
    out = []
    for ctx in (TorchSession(device="cpu"), JaxSession()):
        for name, t in tables.items():
            ctx.register_table(name, t)
        ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
        out.append(ctx)
    return out


def _nearest_route(ctx) -> str:
    routes = [k for c in ctx.last_metrics.counters.values() for k in c
              if k.startswith("nearest_route_")]
    assert len(routes) == 1, routes
    return routes[0][len("nearest_route_"):]


ROUTES = [("0", "device"), (None, "host")]

FIXTURE = (
    "CREATE TABLE {a} (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
    " AS VALUES ('a', 's', 5, 10)",
    "CREATE TABLE {b} (contig TEXT, strand TEXT, start INTEGER, end INTEGER)"
    " AS VALUES ('a', 's', 11, 13), ('a', 's', 20, 21), ('a', 'x', 0, 1), ('b', 's', 1, 2)",
    "SELECT * FROM {a} JOIN {b} ON {a}.contig = {b}.contig AND {a}.strand = {b}.strand"
    " AND {a}.start < {b}.end AND {a}.end > {b}.start",
)


class TestNearestSql:
    @pytest.mark.parametrize("threshold,route", ROUTES)
    @pytest.mark.parametrize("names", [("a", "b"), ("an", "bn")])
    def test_reference_sql_fixture(self, monkeypatch, threshold, route, names):
        """tests/test_integration_sql.py's two nearest fixtures: four rows,
        two with a NULL build side (absent keys)."""
        a, b = names
        sessions = _sessions({}, threshold, monkeypatch)
        outs = []
        for ctx in sessions:
            for stmt in FIXTURE[:2]:
                ctx.sql(stmt.format(a=a, b=b))
            outs.append(ctx.sql(FIXTURE[2].format(a=a, b=b)))
        got, want = outs
        assert _nearest_route(sessions[0]) == route
        assert got.column_names == want.column_names
        assert got.to_pylist() == want.to_pylist()
        assert got.num_rows == 4
        assert sum(v is None for v in got.column_np(0).tolist()) == 2

    @pytest.mark.parametrize("threshold,route", ROUTES)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_tables_equal_jax(self, monkeypatch, threshold, route, seed):
        rng = np.random.default_rng(seed)
        bk, bs, be, qk, qs, qe = _tied(rng, 500, 900)
        tables = {
            "s1": pa.table({"contig": [f"c{k}" for k in bk], "pos_start": bs, "pos_end": be}),
            "s2": pa.table({"contig": [f"c{k}" for k in qk], "pos_start": qs, "pos_end": qe,
                            "id": np.arange(len(qk))}),
        }
        tctx, jctx = _sessions(tables, threshold, monkeypatch)
        sql = ("SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
               "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
        got, want = tctx.sql(sql), jctx.sql(sql)
        assert _nearest_route(tctx) == route
        assert got.num_rows == 900
        assert got.to_pylist() == want.to_pylist()
        # streamed nearest is one batch, the same rows
        batches = list(tctx.sql_batches(sql))
        assert len(batches) == 1 and batches[0].to_pylist() == got.to_pylist()

    @pytest.mark.parametrize("threshold,route", ROUTES)
    def test_int32_extremes_equal_jax(self, monkeypatch, threshold, route):
        tables = {
            "s1": pa.table({"contig": ["x", "x", "y", "z", "z"],
                            "pos_start": [I32_MIN, I32_MAX - 1, I32_MAX - 1, I32_MIN, I32_MIN + 10],
                            "pos_end": [I32_MIN, I32_MAX, I32_MAX, I32_MIN + 1, I32_MIN + 20]}),
            "s2": pa.table({"contig": ["x", "x", "y", "y", "z", "w"],
                            "pos_start": [0, -1, -1, I32_MAX - 100, I32_MAX, 0],
                            "pos_end": [0, -1, -1, I32_MAX - 50, I32_MAX, 0]}),
        }
        tctx, jctx = _sessions(tables, threshold, monkeypatch)
        sql = ("SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
               "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
        got, want = tctx.sql(sql), jctx.sql(sql)
        assert _nearest_route(tctx) == route
        assert got.to_pylist() == want.to_pylist()
        assert got.column_np(0).tolist()[-1] is None  # absent key 'w'

    @pytest.mark.parametrize("threshold,route", ROUTES)
    @pytest.mark.parametrize("empty", ["build", "probe"])
    def test_empty_sides_equal_jax(self, monkeypatch, threshold, route, empty):
        """An empty build gives every probe a NULL build side; an empty
        probe side gives no rows."""
        s1 = pa.table({"contig": ["a", "b"], "pos_start": [1, 5], "pos_end": [3, 9]})
        s2 = pa.table({"contig": ["a", "c", "b"], "pos_start": [4, 1, 0], "pos_end": [6, 2, 1]})
        tables = {"s1": s1.slice(0, 0) if empty == "build" else s1,
                  "s2": s2.slice(0, 0) if empty == "probe" else s2}
        tctx, jctx = _sessions(tables, threshold, monkeypatch)
        sql = ("SELECT a.pos_start AS a_s, b.pos_start AS b_s FROM s1 a JOIN s2 b "
               "ON a.contig = b.contig AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
        got, want = tctx.sql(sql), jctx.sql(sql)
        assert _nearest_route(tctx) == route
        assert got.to_pylist() == want.to_pylist()
        assert got.num_rows == tables["s2"].num_rows
        if empty == "build":
            assert got.num_rows == 3 and all(r["a_s"] is None for r in got.to_pylist())

    def test_tie_break_host_device_parity(self, monkeypatch):
        """The JAX package's tests/test_review_regressions.py nearest
        parity case: the smallest-end overlap wins on both routes."""
        tables = {
            "b": pa.table({"contig": ["c", "c"], "pos_start": [5, 5], "pos_end": [20, 10],
                           "name": ["long", "short"]}),
            "q": pa.table({"contig": ["c"], "pos_start": [7], "pos_end": [8]}),
        }
        sql = ("SELECT b.name FROM b JOIN q ON b.contig = q.contig "
               "AND b.pos_end >= q.pos_start AND b.pos_start <= q.pos_end")
        outs = []
        for threshold, route in ROUTES:
            tctx, jctx = _sessions(tables, threshold, monkeypatch)
            got = tctx.sql(sql).to_pylist()
            assert _nearest_route(tctx) == route
            assert got == jctx.sql(sql).to_pylist()
            outs.append(got)
        assert outs[0] == outs[1] == [{"name": "short"}]
