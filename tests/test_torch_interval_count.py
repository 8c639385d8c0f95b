"""Port parity: the count(*) operator of sequila_tpu_torch vs the JAX one.

IntervalJoinExec._merge_sorted_count of both packages on the shapes of
tests/test_merge_count.py (planner ±1 deltas, negative coordinates,
missing keys, dense ties, probe larger and smaller than build), on the
same arrow tables; counts compare exactly.  Shapes the merge plan declines
take the co-sort and level routes in both packages and compare exactly;
materialization, streaming, per-probe counts and nearest match the JAX
package, and so do Partitioned mode's count, rows and streamed rows.
"""

import numpy as np
import pyarrow as pa
import pytest

from sequila_tpu.config import Algorithm, SequilaConfig
from sequila_tpu_torch.config import Algorithm as TorchAlgorithm
from sequila_tpu.exec.context import ExecContext as JaxCtx
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec as JaxJoin
from sequila_tpu.exec.plan import ScanExec as JaxScan
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.planner import expr as jexpr
from sequila_tpu.planner import intervals as jiv
from sequila_tpu_torch.config import SequilaConfig as TorchConfig
from sequila_tpu_torch.exec.context import ExecContext as TorchCtx
from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec as TorchJoin
from sequila_tpu_torch.exec.plan import ScanExec as TorchScan
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.planner import expr as texpr
from sequila_tpu_torch.planner import intervals as tiv


def _bound(ex, idx, d):
    col = ex.Column("x", idx)
    if d == 0:
        return col
    return ex.BinaryExpr(col, "+" if d > 0 else "-", ex.Literal(abs(d)))


def _join(pkg, lt, rt, deltas=(0, 0, 0, 0), alg="COITREES", **kw):
    """An IntervalJoinExec of the JAX package ('jax') or of the port, with
    the package's own ``Algorithm`` member named ``alg``."""
    ex, iv, Join, Scan, Table, Alg = (
        (jexpr, jiv, JaxJoin, JaxScan, JaxTable, Algorithm) if pkg == "jax"
        else (texpr, tiv, TorchJoin, TorchScan, TorchTable, TorchAlgorithm)
    )
    d_bs, d_be, d_qs, d_qe = deltas
    lt, rt = Table(lt), Table(rt)
    if pkg != "jax":
        kw.setdefault("device", "cpu")
    join = Join(
        Scan("l", lt), Scan("r", rt),
        on=[(ex.Column("contig", 0), ex.Column("contig", 0))],
        filter_=None,
        intervals=iv.ColIntervals(
            iv.ColInterval(_bound(ex, 1, d_bs), _bound(ex, 2, d_be)),
            iv.ColInterval(_bound(ex, 1, d_qs), _bound(ex, 2, d_qe)),
        ),
        algorithm=Alg[alg],
        **kw,
    )
    return join, lt, rt


def _merge_counts(lt, rt, deltas=(0, 0, 0, 0)):
    jjoin, jl, jr = _join("jax", lt, rt, deltas)
    tjoin, tl, tr = _join("torch", lt, rt, deltas)
    want = jjoin._merge_sorted_count(JaxCtx(SequilaConfig()), jl, jr)
    got = tjoin._merge_sorted_count(TorchCtx(TorchConfig()), tl, tr)
    return got, want


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, neg=False):
    lo = -span if neg else 0
    lts = rng.integers(lo, span, n).astype(np.int64)
    rts = rng.integers(lo, span, m).astype(np.int64)
    lt = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
        "s": lts,
        "e": lts + rng.integers(2, 3000, n),
    })
    rt = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
        "s": rts,
        "e": rts + rng.integers(2, 3000, m),
    })
    return lt, rt


def _dup(nn, seed):
    r = np.random.default_rng(seed)
    s = r.integers(0, 40, nn).astype(np.int64)  # massive ties
    return pa.table({"contig": ["k"] * nn, "s": s, "e": s + r.integers(1, 5, nn)})


class TestMergeCountParity:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_deltas(self, rng, deltas):
        got, want = _merge_counts(*_tables(rng, 400, 600), deltas)
        assert want is not None and got == want

    def test_negative_coords_and_missing_keys(self, rng):
        got, want = _merge_counts(*_tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True))
        assert want is not None and got == want

    @pytest.mark.parametrize("n,m", [(2500, 300), (300, 2500)])
    def test_probe_larger_and_smaller_than_build(self, rng, n, m):
        got, want = _merge_counts(*_tables(rng, n, m))
        assert want is not None and got == want

    def test_single_key_dense_ties(self):
        got, want = _merge_counts(_dup(3000, 3), _dup(4000, 4))
        assert want is not None and got == want

    def test_count_rows_device_route(self, rng, monkeypatch):
        """count_rows above the threshold takes the merge route in both."""
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        lt, rt = _tables(rng, 900, 1300)
        jjoin, _, _ = _join("jax", lt, rt)
        tjoin, _, _ = _join("torch", lt, rt)
        ctx = TorchCtx(TorchConfig())
        assert tjoin.count_rows(ctx) == jjoin.count_rows(JaxCtx(SequilaConfig()))
        assert ctx.metrics.format_op(tjoin.op_id())


def _wide(nn, seed):
    r = np.random.default_rng(seed)
    s = r.integers(-(2**31), 2**31 - 200, nn).astype(np.int64)
    return pa.table({"contig": [f"c{i % 2}" for i in range(nn)], "s": s, "e": s + 100})


def _degenerate_probe(rng):
    lt, _ = _tables(rng, 200, 10)
    rt = pa.table({
        "contig": ["c1"] * 50,
        "s": np.arange(50, dtype=np.int64) + 100,
        "e": np.arange(50, dtype=np.int64),  # qe < qs
    })
    return lt, rt


def _inverted_build(rng):
    _, rt = _tables(rng, 10, 200)
    lt = pa.table({
        "contig": ["c1"] * 50,
        "s": np.arange(50, dtype=np.int64) + 100,
        "e": np.arange(50, dtype=np.int64),  # end < start
    })
    return lt, rt


def _device_count(lt, rt, **kw):
    """(port count, JAX count, the port's route) of count_rows on one table
    pair; the caller sets SEQUILA_HOST_THRESHOLD and the backend."""
    jjoin, _, _ = _join("jax", lt, rt, **kw)
    tjoin, _, _ = _join("torch", lt, rt, **kw)
    ctx = TorchCtx(TorchConfig())
    got = tjoin.count_rows(ctx)
    routes = [k for k in ctx.metrics.counters[tjoin.op_id()] if k.startswith("count_route_")]
    assert len(routes) == 1
    return got, jjoin.count_rows(JaxCtx(SequilaConfig())), routes[0][len("count_route_"):]


class TestDeclinedShapesRaise:
    """Shapes the merge plan declines, and the other count backends: the
    port passes them on to the co-sort BITS count and the level loop, as
    the JAX package does, and counts exactly what it counts (the class
    keeps its name from when the port raised here)."""

    @pytest.mark.parametrize("shape", ["span", "degenerate", "inverted"])
    def test_declined_merge_plan(self, rng, monkeypatch, shape):
        route = "cosort" if shape == "span" else "level"
        lt, rt = {
            "span": lambda: (_wide(500, 1), _wide(700, 2)),
            "degenerate": lambda: _degenerate_probe(rng),
            "inverted": lambda: _inverted_build(rng),
        }[shape]()
        got, want = _merge_counts(lt, rt)
        assert got is None and want is None
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        got, want, took = _device_count(lt, rt)
        assert took == route
        assert got == want
        # at the default threshold the same query takes the host route,
        # as in the JAX package, and agrees with it
        monkeypatch.delenv("SEQUILA_HOST_THRESHOLD")
        got, host, took = _device_count(lt, rt)
        assert took == "host"
        assert got == host == want

    @pytest.mark.parametrize("backend", ["cosort", "stream"])
    def test_other_count_backends(self, rng, monkeypatch, backend):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        monkeypatch.setenv("SEQUILA_COUNT_BACKEND", backend)
        got, want, took = _device_count(*_tables(rng, 100, 100))
        assert took == backend
        assert got == want > 0

    def test_empty_side_counts_zero(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        lt, rt = _tables(rng, 100, 100)
        tjoin, _, _ = _join("torch", lt.slice(0, 0), rt)
        assert tjoin.count_rows(TorchCtx(TorchConfig())) == 0


def _rows(t):
    cols = [t.arrow.column(i).to_pylist() for i in range(t.arrow.num_columns)]
    return list(zip(*cols))


def _distributions(ctx):
    return sorted(k for c in ctx.metrics.counters.values() for k in c
                  if k.startswith("distribution_"))


class TestOffSliceRoutesRaise:
    """Routes that once raised NotImplementedError naming their ROADMAP.md
    item: materialization (A3), streaming (A4), per-probe counts and
    nearest (A6) and Partitioned mode (A9) are ported and now match the
    JAX package (the class keeps its name)."""

    def test_materialize_above_threshold(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        lt, rt = _tables(rng, 100, 100)
        jjoin, _, _ = _join("jax", lt, rt)
        tjoin, _, _ = _join("torch", lt, rt)
        got = tjoin.execute(TorchCtx(TorchConfig()))
        want = jjoin.execute(JaxCtx(SequilaConfig()))
        assert got.num_rows > 0 and _rows(got) == _rows(want)

    def test_streamed_batches(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_MAX_OUTPUT_BATCH_SIZE", "50")
        lt, rt = _tables(rng, 100, 100)
        jjoin, _, _ = _join("jax", lt, rt)
        tjoin, _, _ = _join("torch", lt, rt)
        got = list(tjoin.execute_batches(TorchCtx(TorchConfig())))
        want = list(jjoin.execute_batches(JaxCtx(SequilaConfig())))
        assert len(got) > 1 and all(b.num_rows <= 200 for b in got)
        assert sorted(r for b in got for r in _rows(b)) == sorted(
            r for b in want for r in _rows(b)
        )

    def test_per_probe_counts(self, rng, monkeypatch):
        """Per-probe counts (A6) are ported: equal to the JAX package's on
        the merge route (threshold 0) and the host route."""
        lt, rt = _tables(rng, 100, 100)
        for threshold in ("0", "65536"):
            monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
            jjoin, _, _ = _join("jax", lt, rt)
            tjoin, _, _ = _join("torch", lt, rt)
            got = tjoin.per_probe_counts(TorchCtx(TorchConfig()))
            want = np.asarray(jjoin.per_probe_counts(JaxCtx(SequilaConfig())))
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            assert want.sum() > 0

    def test_partitioned_mode_equals_jax(self, rng):
        """Partitioned mode at target_partitions=2: count_rows, execute and
        execute_batches over the port's CPU mesh equal the JAX package's
        over the virtual mesh, with the same distribution metric."""
        lt, rt = _tables(rng, 100, 100)
        jjoin, _, _ = _join("jax", lt, rt, mode="Partitioned")
        tjoin, _, _ = _join("torch", lt, rt, mode="Partitioned")
        runs = {
            "count_rows": lambda join, ctx: join.count_rows(ctx),
            "execute": lambda join, ctx: sorted(_rows(join.execute(ctx))),
            "execute_batches": lambda join, ctx: sorted(
                r for b in join.execute_batches(ctx) for r in _rows(b)),
        }
        for name, run in runs.items():
            jctx = JaxCtx(SequilaConfig(target_partitions=2))
            tctx = TorchCtx(TorchConfig(target_partitions=2))
            want = run(jjoin, jctx)
            assert run(tjoin, tctx) == want and want, name
            assert _distributions(tctx) == _distributions(jctx) == ["distribution_hash"], name

    def test_nearest(self, rng, monkeypatch):
        """The nearest join (A6) is ported: one row a probe row, equal to
        the JAX package's on the device (threshold 0) and host routes;
        streamed nearest is one batch of the same rows."""
        lt, rt = _tables(rng, 100, 100, lkeys=4, rkeys=6)
        for threshold in ("0", "65536"):
            monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
            jjoin, _, _ = _join("jax", lt, rt, alg="COITREES_NEAREST")
            tjoin, _, _ = _join("torch", lt, rt, alg="COITREES_NEAREST")
            got = tjoin.execute(TorchCtx(TorchConfig()))
            want = jjoin.execute(JaxCtx(SequilaConfig()))
            assert got.num_rows == rt.num_rows and _rows(got) == _rows(want)
            assert any(r[0] is None for r in _rows(got))  # keys absent from the build
            batches = list(tjoin.execute_batches(TorchCtx(TorchConfig())))
            assert len(batches) == 1 and _rows(batches[0]) == _rows(want)

    def test_host_materialize_matches_jax(self, rng):
        """Below the threshold a materializing inner join runs on the host
        index in both packages: same rows (as sorted pair sets)."""
        lt, rt = _tables(rng, 300, 400)
        jjoin, _, _ = _join("jax", lt, rt)
        tjoin, _, _ = _join("torch", lt, rt)
        def rows(t):
            cols = [t.arrow.column(i).to_pylist() for i in range(t.arrow.num_columns)]
            return sorted(zip(*cols))

        want = jjoin.execute(JaxCtx(SequilaConfig()))
        got = tjoin.execute(TorchCtx(TorchConfig()))
        assert got.column_names == want.column_names
        assert got.num_rows == want.num_rows > 0
        assert rows(got) == rows(want)
