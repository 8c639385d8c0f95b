"""Port parity: per-probe counts (CountOverlaps, the grouped count(*)).

IntervalJoinExec.per_probe_counts of sequila_tpu_torch (``device="cpu"``,
the kernels' plain versions) against the JAX package's on the same arrow
tables, route by route, exactly: the host index at the default threshold,
the merge backend's per-probe passes (B1's ranks in view order, then
unpermute_counts through the cached inverse orders) with
SEQUILA_HOST_THRESHOLD=0, and the level loop for every shape the merge
plan declines.  merge_probe_count_passes and merge_probe_count_passes_plain
against the JAX one on the same sorted views, also on probes already in
view order, reversed, of one key, one row past a 2048 multiple and of
one row; unpermute_counts against a numpy reference; the grouped count(*)
through SQL against the JAX session.  The ``cuda`` test holds a warm
device per-probe count to one B1, two pack_view and one un-permute
launch, and the un-permute kernel to its plain version.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.config import SequilaConfig
from sequila_tpu.exec.context import ExecContext as JaxCtx
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu.planner import expr as jexpr
from sequila_tpu.planner import intervals as jiv
from sequila_tpu_torch.config import SequilaConfig as TorchConfig
from sequila_tpu_torch.exec.context import ExecContext as TorchCtx
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from sequila_tpu_torch.planner import expr as texpr
from sequila_tpu_torch.planner import intervals as tiv
from sequila_tpu_torch.utils import metrics
from test_torch_interval_count import (
    _degenerate_probe,
    _dup,
    _inverted_build,
    _join,
    _tables,
    _wide,
)
from test_torch_verb_ranks import _one_probe_row, _probe_in_view_order


def _route(ctx, op) -> str:
    routes = [k for k in ctx.metrics.counters[op] if k.startswith("probe_count_route_")]
    assert len(routes) == 1, routes
    return routes[0][len("probe_count_route_"):]


def _with(pkg, join, lt, rt, keys=None, q_start=None):
    """``join`` re-keyed on the columns ``keys`` and/or with the probe
    start bound replaced by ``q_start(expr module, start column)``."""
    ex, iv = (jexpr, jiv) if pkg == "jax" else (texpr, tiv)
    if keys is not None:
        join.on = [
            (ex.Column(k, lt.schema.get_field_index(k)), ex.Column(k, rt.schema.get_field_index(k)))
            for k in keys
        ]
    if q_start is not None:
        r = join.intervals.right_interval
        join.intervals = iv.ColIntervals(
            join.intervals.left_interval, iv.ColInterval(q_start(ex, r.start), r.end)
        )
    return join


def _probe_counts(lt, rt, deltas=(0, 0, 0, 0), **kw):
    """(port counts, JAX counts, the port's route) of per_probe_counts on
    one table pair; the caller sets SEQUILA_HOST_THRESHOLD and the
    backend."""
    jjoin, _, _ = _join("jax", lt, rt, deltas)
    tjoin, _, _ = _join("torch", lt, rt, deltas)
    jjoin, tjoin = (_with(p, j, lt, rt, **kw) for p, j in (("jax", jjoin), ("torch", tjoin)))
    ctx = TorchCtx(TorchConfig())
    got, table = tjoin.per_probe_counts(ctx, with_table=True)
    assert table.num_rows == rt.num_rows
    assert got.dtype == np.int32 and got.shape == (rt.num_rows,)
    want = np.asarray(jjoin.per_probe_counts(JaxCtx(SequilaConfig())))
    return got, want, _route(ctx, tjoin.op_id())


def _null_keys(rng):
    lt, rt = _tables(rng, 300, 400)
    keys = rt.column("contig").to_pylist()
    keys[::7] = [None] * len(keys[::7])
    return lt, rt.set_column(0, "contig", pa.array(keys))


def _mixed_key_types(rng):
    lt, rt = _tables(rng, 300, 400)
    lk = rng.integers(0, 5, lt.num_rows).astype(np.int32)
    rk = rng.integers(0, 6, rt.num_rows).astype(np.int64)
    return lt.set_column(0, "contig", pa.array(lk)), rt.set_column(0, "contig", pa.array(rk))


EDGE_SHAPES = {  # (build, probe) of the per-probe parity's edge cases
    "identity_orders": lambda rng: _probe_in_view_order(rng, 900),
    "reverse_orders": lambda rng: _probe_in_view_order(rng, 900, reverse=True),
    "one_key": lambda rng: _tables(rng, 700, 900, lkeys=1, rkeys=1),
    "pad_tail": lambda rng: _tables(rng, 500, 2 * 2048 + 1),
    "one_probe_row": _one_probe_row,
}


DECLINED = {  # shapes the merge plan declines: (tables, join edits)
    "span": lambda rng: ((_wide(500, 1), _wide(700, 2)), {}),
    "degenerate": lambda rng: (_degenerate_probe(rng), {}),
    "inverted": lambda rng: (_inverted_build(rng), {}),
    "null_keys": lambda rng: (_null_keys(rng), {}),
    "mixed_key_types": lambda rng: (_mixed_key_types(rng), {}),
    "computed_bound": lambda rng: (
        _tables(rng, 300, 400),
        {"q_start": lambda ex, s: ex.BinaryExpr(s, "*", ex.Literal(1))},
    ),
}


class TestRoutes:
    def test_host_route(self, rng):
        got, want, route = _probe_counts(*_tables(rng, 300, 400))
        assert route == "host"
        np.testing.assert_array_equal(got, want)
        assert want.sum() > 0

    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_merge_route_deltas(self, rng, monkeypatch, deltas):
        lt, rt = _tables(rng, 400, 600)
        host, _, _ = _probe_counts(lt, rt, deltas)
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        got, want, route = _probe_counts(lt, rt, deltas)
        assert route == "merge"
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, host)

    @pytest.mark.parametrize("shape", ["neg_missing_keys", "probe_larger", "build_larger", "dense_ties"])
    def test_merge_route_shapes(self, rng, monkeypatch, shape):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        lt, rt = {
            "neg_missing_keys": lambda: _tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True),
            "probe_larger": lambda: _tables(rng, 300, 2000),
            "build_larger": lambda: _tables(rng, 2000, 300),
            "dense_ties": lambda: (_dup(1500, 3), _dup(2000, 4)),
        }[shape]()
        got, want, route = _probe_counts(lt, rt)
        assert route == "merge"
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("shape", sorted(DECLINED))
    def test_declined_shapes_take_the_level_loop(self, rng, monkeypatch, shape):
        (lt, rt), edits = DECLINED[shape](rng)
        tjoin, tl, tr = _join("torch", lt, rt)
        tjoin = _with("torch", tjoin, lt, rt, **edits)
        assert tjoin._merge_probe_counts(TorchCtx(TorchConfig()), tl, tr) is None
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        got, want, route = _probe_counts(lt, rt, **edits)
        assert route == "level"
        np.testing.assert_array_equal(got, want)

    def test_other_backends_take_the_level_loop(self, rng, monkeypatch):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        monkeypatch.setenv("SEQUILA_COUNT_BACKEND", "cosort")
        got, want, route = _probe_counts(*_tables(rng, 300, 400))
        assert route == "level"
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("threshold", ["0", "65536"])
    def test_two_key_join(self, rng, monkeypatch, threshold):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
        lt, rt = _tables(rng, 400, 500)
        lt = lt.append_column("strand", pa.array(rng.choice(["+", "-"], lt.num_rows)))
        rt = rt.append_column("strand", pa.array(rng.choice(["+", "-"], rt.num_rows)))
        got, want, route = _probe_counts(lt, rt, keys=("contig", "strand"))
        assert route == ("level" if threshold == "0" else "host")
        np.testing.assert_array_equal(got, want)
        assert want.sum() > 0

    @pytest.mark.parametrize("threshold", ["0", "65536"])
    @pytest.mark.parametrize("empty", ["build", "probe", "both"])
    def test_empty_sides(self, rng, monkeypatch, threshold, empty):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
        lt, rt = _tables(rng, 100, 120)
        if empty in ("build", "both"):
            lt = lt.slice(0, 0)
        if empty in ("probe", "both"):
            rt = rt.slice(0, 0)
        got, want, route = _probe_counts(lt, rt)
        # _use_host is n + m <= threshold: two empty sides stay on the host
        assert route == ("level" if threshold == "0" and empty != "both" else "host")
        np.testing.assert_array_equal(got, want)
        assert not got.any()


def _plans(lt, rt, deltas):
    """The merge probe-count plans of both packages on one table pair."""
    jjoin, jl, jr = _join("jax", lt, rt, deltas)
    tjoin, tl, tr = _join("torch", lt, rt, deltas)
    jplan = jjoin._merge_probe_plan(jl, jr, *jjoin._sorted_count_inputs(jl, jr))
    tplan = tjoin._merge_probe_plan(tl, tr, *tjoin._sorted_count_inputs(tl, tr))
    return jplan, tplan, rt.num_rows


class TestMergeProbeCountPasses:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_equals_jax(self, rng, deltas):
        jplan, tplan, n = _plans(*_tables(rng, 500, 700, lkeys=4, rkeys=6, neg=True), deltas)
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        got = tmc.merge_probe_count_passes(tplan)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_dense_ties_equal_jax(self):
        jplan, tplan, n = _plans(_dup(1200, 5), _dup(1800, 6), (0, 0, 0, 0))
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        np.testing.assert_array_equal(tmc.merge_probe_count_passes(tplan).numpy(), want)

    @pytest.mark.parametrize("shape", sorted(EDGE_SHAPES))
    def test_edge_shapes_equal_jax(self, rng, shape):
        jplan, tplan, n = _plans(*EDGE_SHAPES[shape](rng), (0, 0, 0, 0))
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        got = tmc.merge_probe_count_passes(tplan)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmc.merge_probe_count_passes_plain(tplan).numpy(), want)
        assert want.sum() > 0

    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    @pytest.mark.parametrize("shape", ["several_keys", "dense_ties"])
    def test_plain_equals_merge_probe_count_passes(self, rng, shape, deltas):
        lt, rt = (_tables(rng, 500, 700, lkeys=4, rkeys=6, neg=True) if shape == "several_keys"
                  else (_dup(1200, 5), _dup(1800, 6)))
        _, tplan, n = _plans(lt, rt, deltas)
        got = tmc.merge_probe_count_passes_plain(tplan)
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert torch.equal(got, tmc.merge_probe_count_passes(tplan))

    def test_plan_is_two_segments_of_one_launch(self, rng):
        lt, rt = _tables(rng, 300, 500)
        tjoin, tl, tr = _join("torch", lt, rt)
        tplan = tjoin._merge_probe_plan(tl, tr, *tjoin._sorted_count_inputs(tl, tr))
        n = rt.num_rows
        a, b = tplan.segplan.segs
        assert (a.strict, b.strict) == (False, True)
        assert a.n_real == b.n_real == tplan.n == n
        # ranks stored direct, in view order, into the rows of [2, n]
        assert a.ord is None and b.ord is None
        assert (a.out, b.out) == ((2, 0), (2, n))
        assert tplan.segplan.need[2] == (torch.int32, 2 * n)
        # the build views are the tables, packed with PROBE_PAD; the probe
        # views the queries, packed with BUILD_PAD by the caller
        assert a.raw[3] == b.raw[3] == tmc.PROBE_PAD
        # the un-permute reads the probe table's cached int32 inverse orders
        assert tplan.inv_qe is tr.sorted_interval_inverse(0, 2, "cpu")
        assert tplan.inv_qs is tr.sorted_interval_inverse(0, 1, "cpu")
        for inv, col in ((tplan.inv_qe, 2), (tplan.inv_qs, 1)):
            assert inv.dtype == torch.int32 and inv.shape == (n,)
            np.testing.assert_array_equal(inv.numpy()[tr.sorted_interval_order(0, col, "cpu").numpy()],
                                          np.arange(n))

    def test_build_pad_rows_count_in_neither_pass(self, rng):
        """The build views keep their PAD tails, which pack to PROBE_PAD,
        above every real query: the counts equal those over the real rows
        alone."""
        jplan, tplan, n = _plans(*_tables(rng, 333, 257), (0, 0, 0, 0))
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        segs = tplan.segplan.segs
        n_build = int((segs[0].raw[0] != 2**31 - 1).sum())
        assert segs[0].n > n_build == 333
        real = [s._replace(n=n_build, raw=(s.raw[0][:n_build], s.raw[1][:n_build], *s.raw[2:]))
                for s in segs]
        real = tplan._replace(segplan=tmc.plan_segments(real, "cpu"))
        np.testing.assert_array_equal(tmc.merge_probe_count_passes(tplan).numpy(), want)
        np.testing.assert_array_equal(tmc.merge_probe_count_passes(real).numpy(), want)


def _ranks_and_inverses(rng, n):
    ranks = torch.from_numpy(rng.integers(0, 2**31 - 1, (2, n)).astype(np.int32))
    inv_e, inv_s = (torch.from_numpy(rng.permutation(n).astype(np.int32)) for _ in range(2))
    return ranks, inv_e, inv_s


class TestUnpermuteCounts:
    @pytest.mark.parametrize("n", [1, 2, 257, 5000])
    def test_equals_numpy(self, rng, n):
        ranks, inv_e, inv_s = _ranks_and_inverses(rng, n)
        got = tmc.unpermute_counts(ranks, inv_e, inv_s)
        r = ranks.numpy()
        want = r[0, inv_e.numpy()] - r[1, inv_s.numpy()]  # int32, wrapping as the kernel
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmc.unpermute_counts_plain(ranks, inv_e, inv_s).numpy(), want)

    def test_empty(self):
        ranks, inv = torch.empty((2, 0), dtype=torch.int32), torch.empty(0, dtype=torch.int32)
        assert tmc.unpermute_counts(ranks, inv, inv).shape == (0,)

    @pytest.mark.parametrize("bad", ["ranks_shape", "ranks_rows", "ranks_dtype", "ranks_strided",
                                     "inv_length", "inv_dtype", "inv_2d", "device",
                                     "meta_device"])
    def test_rejects(self, rng, bad):
        ranks, inv_e, inv_s = _ranks_and_inverses(rng, 64)
        if bad == "ranks_shape":
            ranks = ranks.reshape(-1)
        elif bad == "ranks_rows":
            ranks = ranks.reshape(4, 32)
        elif bad == "ranks_dtype":
            ranks = ranks.to(torch.int64)
        elif bad == "ranks_strided":
            ranks = ranks.t().contiguous().t()
        elif bad == "inv_length":
            inv_s = inv_s[:-1]
        elif bad == "inv_dtype":
            inv_e = inv_e.to(torch.int64)
        elif bad == "inv_2d":
            inv_e = inv_e.reshape(8, 8)
        elif bad == "device":  # ranks elsewhere than the inverse orders
            ranks = ranks.to("meta")
        else:  # every tensor on a device with no kernel and no plain path
            ranks, inv_e, inv_s = (t.to("meta") for t in (ranks, inv_e, inv_s))
        with pytest.raises((TypeError, ValueError)):
            tmc.unpermute_counts(ranks, inv_e, inv_s)


def _sessions(lt, rt):
    from sequila_tpu.session import SessionContext as JaxSession
    from sequila_tpu_torch.session import SessionContext as TorchSession

    out = []
    for ctx in (TorchSession(device="cpu"), JaxSession()):
        ctx.register_table("a", lt)
        ctx.register_table("b", rt)
        out.append(ctx)
    return out


GROUPED = {
    "probe_key": "SELECT b.contig, count(*) FROM a JOIN b ON a.contig = b.contig "
                 "AND a.s <= b.e AND a.e >= b.s GROUP BY b.contig ORDER BY b.contig",
    "build_key_twin": "SELECT a.contig, count(*) AS n FROM a JOIN b ON a.contig = b.contig "
                      "AND a.s <= b.e AND a.e >= b.s GROUP BY a.contig ORDER BY a.contig",
    "null_group": "SELECT b.name, count(*) FROM a JOIN b ON a.contig = b.contig "
                  "AND a.s < b.e AND a.e > b.s GROUP BY b.name ORDER BY b.name",
    "two_keys": "SELECT b.contig, count(1) FROM a JOIN b ON a.contig = b.contig "
                "AND a.strand = b.strand AND a.s <= b.e AND a.e >= b.s GROUP BY b.contig",
}


class TestGroupedCountSql:
    @pytest.mark.parametrize("threshold", ["0", "65536"])
    @pytest.mark.parametrize("query", sorted(GROUPED))
    def test_grouped_count_equals_jax(self, rng, monkeypatch, threshold, query):
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
        lt, rt = _tables(rng, 500, 700, lkeys=4, rkeys=6)
        lt = lt.append_column("strand", pa.array(rng.choice(["+", "-"], lt.num_rows)))
        rt = rt.append_column("strand", pa.array(rng.choice(["+", "-"], rt.num_rows)))
        names = [None if i % 3 == 0 else f"g{i % 4}" for i in range(rt.num_rows)]
        rt = rt.append_column("name", pa.array(names, pa.string()))
        tctx, jctx = _sessions(lt, rt)
        sql = GROUPED[query]
        assert "GroupedIntervalCountExec" in tctx.sql(f"EXPLAIN {sql}").column_np("plan")[0]
        got, want = tctx.sql(sql), jctx.sql(sql)
        assert got.column_names == want.column_names
        assert got.to_pylist() == want.to_pylist()
        assert len(got.to_pylist()) > 1
        if query == "null_group":
            assert got.to_pylist()[-1][got.column_names[0]] is None
        route = [k for c in tctx.last_metrics.counters.values() for k in c
                 if k.startswith("probe_count_route_")]
        expect = "host" if threshold != "0" else ("level" if query == "two_keys" else "merge")
        assert route == [f"probe_count_route_{expect}"]

    def test_all_null_probe_group_column(self, rng):
        """A group column that is NULL on every probe row: one NULL group
        holding every match."""
        lt, rt = _tables(rng, 200, 300)
        rt = rt.append_column("name", pa.nulls(rt.num_rows, pa.string()))
        tctx, jctx = _sessions(lt, rt)
        sql = GROUPED["null_group"]
        got = tctx.sql(sql).to_pylist()
        assert got == jctx.sql(sql).to_pylist()
        assert len(got) == 1 and got[0]["name"] is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_warm_device_probe_count_launches_b1_once(rng, monkeypatch, cuda_device):
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    lt, rt = _tables(rng, 3000, 5000)
    want = _join("torch", lt, rt)[0].per_probe_counts(TorchCtx(TorchConfig()))
    join, _, _ = _join("torch", lt, rt, device=cuda_device)
    join.per_probe_counts(TorchCtx(TorchConfig()))  # plans and uploads
    ctx = TorchCtx(TorchConfig())
    with metrics.recording() as rec:
        got = join.per_probe_counts(ctx)
    assert _route(ctx, join.op_id()) == "merge"
    launches = rec.counts()
    assert [launches[f"launch.{k}"] for k in ("merge_path", "pack_view", "unpermute_counts")] \
        == [1, 2, 1]
    np.testing.assert_array_equal(got, want)
    # the un-permute kernel alone against its plain version
    ranks, inv_e, inv_s = (t.to(cuda_device) for t in _ranks_and_inverses(rng, 70_001))
    got = tmc.unpermute_counts(ranks, inv_e, inv_s)
    torch.cuda.synchronize()
    assert torch.equal(got, tmc.unpermute_counts_plain(ranks, inv_e, inv_s))
