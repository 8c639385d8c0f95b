"""Port parity: the count(*) operator of sequila_tpu_torch vs the JAX one.

IntervalJoinExec._merge_sorted_count of both packages on the shapes of
tests/test_merge_count.py (planner ±1 deltas, negative coordinates,
missing keys, dense ties, probe larger and smaller than build), on the
same arrow tables; counts compare exactly.  Shapes the merge plan declines
and every route off this slice raise NotImplementedError naming their
ROADMAP.md item instead of rerouting.
"""

import numpy as np
import pyarrow as pa
import pytest

from sequila_tpu.config import Algorithm, SequilaConfig
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


def _join(pkg, lt, rt, deltas=(0, 0, 0, 0), **kw):
    """An IntervalJoinExec of the JAX package ('jax') or of the port."""
    ex, iv, Join, Scan, Table = (
        (jexpr, jiv, JaxJoin, JaxScan, JaxTable) if pkg == "jax"
        else (texpr, tiv, TorchJoin, TorchScan, TorchTable)
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
        algorithm=Algorithm.COITREES,
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


class TestDeclinedShapesRaise:
    """Where the JAX merge plan declines, the JAX package falls back to its
    co-sort / level programs; the port raises instead (ROADMAP.md A5)."""

    @pytest.mark.parametrize("shape", ["span", "degenerate", "inverted"])
    def test_declined_merge_plan(self, rng, monkeypatch, shape):
        lt, rt = {
            "span": lambda: (_wide(500, 1), _wide(700, 2)),
            "degenerate": lambda: _degenerate_probe(rng),
            "inverted": lambda: _inverted_build(rng),
        }[shape]()
        got, want = _merge_counts(lt, rt)
        assert got is None and want is None
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        tjoin, _, _ = _join("torch", lt, rt)
        with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
            tjoin.count_rows(TorchCtx(TorchConfig()))
        # at the default threshold the same query takes the host route,
        # as in the JAX package, and agrees with it
        monkeypatch.delenv("SEQUILA_HOST_THRESHOLD")
        jjoin, _, _ = _join("jax", lt, rt)
        assert tjoin.count_rows(TorchCtx(TorchConfig())) == jjoin.count_rows(
            JaxCtx(SequilaConfig())
        )

    @pytest.mark.parametrize("backend", ["cosort", "stream"])
    def test_other_count_backends(self, rng, monkeypatch, backend):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        monkeypatch.setenv("SEQUILA_COUNT_BACKEND", backend)
        tjoin, _, _ = _join("torch", *_tables(rng, 100, 100))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
            tjoin.count_rows(TorchCtx(TorchConfig()))

    def test_empty_side_counts_zero(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        lt, rt = _tables(rng, 100, 100)
        tjoin, _, _ = _join("torch", lt.slice(0, 0), rt)
        assert tjoin.count_rows(TorchCtx(TorchConfig())) == 0


class TestOffSliceRoutesRaise:
    def test_materialize_above_threshold(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        tjoin, _, _ = _join("torch", *_tables(rng, 100, 100))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
            tjoin.execute(TorchCtx(TorchConfig()))

    def test_streamed_batches(self, rng):
        tjoin, _, _ = _join("torch", *_tables(rng, 100, 100))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
            next(tjoin.execute_batches(TorchCtx(TorchConfig())))

    def test_per_probe_counts(self, rng):
        tjoin, _, _ = _join("torch", *_tables(rng, 100, 100))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
            tjoin.per_probe_counts(TorchCtx(TorchConfig()))

    def test_partitioned_mode(self, rng):
        tjoin, _, _ = _join("torch", *_tables(rng, 100, 100), mode="Partitioned")
        for run in (tjoin.count_rows, tjoin.execute):
            with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
                run(TorchCtx(TorchConfig()))

    def test_nearest(self, rng):
        lt, rt = _tables(rng, 100, 100)
        tjoin, _, _ = _join("torch", lt, rt)
        tjoin.algorithm = Algorithm.COITREES_NEAREST
        with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
            tjoin.execute(TorchCtx(TorchConfig()))

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
