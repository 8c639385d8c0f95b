"""Port parity: the materializing interval join of sequila_tpu_torch vs the
JAX one (the mirror of tests/test_merge_emission.py).

With SEQUILA_HOST_THRESHOLD=0 both packages take their device route: the
port on the CPU (the kernels' plain versions), the JAX package on its CPU
backend (the Pallas kernels in interpret mode).  Both build identical level
indexes from the same arrow tables and emit probe-major, level-minor,
ascending within a run, so their outputs are compared ROW FOR ROW: the
merge-rank emission bounds, ``execute`` on the merge and co-sort backends
over the five data shapes, every algorithm's strategy, low-memory capped
chunks, ``execute_batches``, the span-overflow fallback, outer joins and a
projection; the merge route's pairs also equal the brute-force oracle.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.config import Algorithm as JaxAlgorithm
from sequila_tpu.config import SequilaConfig as JaxConfig
from sequila_tpu.exec.context import ExecContext as JaxCtx
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec as JaxJoin
from sequila_tpu.exec.plan import ScanExec as JaxScan
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.ops.oracle import oracle_pairs
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu.planner import expr as jexpr
from sequila_tpu.planner import intervals as jiv
from sequila_tpu_torch.config import Algorithm as TorchAlgorithm
from sequila_tpu_torch.config import SequilaConfig as TorchConfig
from sequila_tpu_torch.exec.context import ExecContext as TorchCtx
from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec as TorchJoin
from sequila_tpu_torch.exec.plan import ScanExec as TorchScan
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from sequila_tpu_torch.ops.interval_join import materialize_pairs_from_bounds
from sequila_tpu_torch.planner import expr as texpr
from sequila_tpu_torch.planner import intervals as tiv
from sequila_tpu_torch.utils import metrics

PKGS = {
    "jax": (jexpr, jiv, JaxJoin, JaxScan, JaxTable, JaxAlgorithm,
            lambda: JaxCtx(JaxConfig())),
    "torch": (texpr, tiv, TorchJoin, TorchScan, TorchTable, TorchAlgorithm,
              lambda: TorchCtx(TorchConfig())),
}
SHAPES = {
    "plain": dict(),
    "negative": dict(neg=True, lkeys=3, rkeys=9),
    "degenerate": dict(degenerate=0.15),
    "inverted": dict(inverted=0.15),
    "both": dict(degenerate=0.1, inverted=0.1),
}


def _bound(ex, idx, d):
    col = ex.Column("x", idx)
    if d == 0:
        return col
    return ex.BinaryExpr(col, "+" if d > 0 else "-", ex.Literal(abs(d)))


def _join(pkg, lt, rt, deltas=(0, 0, 0, 0), alg="COITREES", **kw):
    """(IntervalJoinExec, left Table, right Table) of one package over the
    arrow tables ``lt`` and ``rt``."""
    ex, iv, Join, Scan, Table, Alg, _ = PKGS[pkg]
    d_bs, d_be, d_qs, d_qe = deltas
    lt, rt = Table(lt), Table(rt)
    if pkg == "torch":
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


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, neg=False,
            degenerate=0.0, inverted=0.0):
    lo = -span if neg else 0
    lts = rng.integers(lo, span, n).astype(np.int64)
    rts = rng.integers(lo, span, m).astype(np.int64)
    le = lts + rng.integers(2, 3000, n)
    re = rts + rng.integers(2, 3000, m)
    if inverted:
        flip = rng.random(n) < inverted
        le = np.where(flip, lts - rng.integers(1, 500, n), le)
    if degenerate:
        flip = rng.random(m) < degenerate
        re = np.where(flip, rts - rng.integers(1, 500, m), re)
    lt = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
        "s": lts, "e": le,
    })
    rt = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
        "s": rts, "e": re,
    })
    return lt, rt


def _rows(t):
    """Rows as tuples of every column (the two sides share column names)."""
    cols = [t.arrow.column(i).to_pylist() for i in range(t.arrow.num_columns)]
    return list(zip(*cols))


def _execute(pkg, lt, rt, backend, monkeypatch, **kw):
    """Rows of execute() on the device route, and the port's route."""
    monkeypatch.setenv("SEQUILA_EMIT_BACKEND", backend)
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    join, _, _ = _join(pkg, lt, rt, **kw)
    ctx = PKGS[pkg][-1]()
    out = join.execute(ctx)
    route = None
    if pkg == "torch":
        routes = [k for k in ctx.metrics.counters[join.op_id()] if k.startswith("emit_route_")]
        assert len(routes) == 1
        route = routes[0][len("emit_route_"):]
    return _rows(out), out.column_names, route


def _merge_bounds(pkg, lt, rt, deltas=(0, 0, 0, 0)):
    """(index, lb, ub, m) of the package's merge-rank emission bounds."""
    join, l, r = _join(pkg, lt, rt, deltas)
    index, *_ = join._prepare(PKGS[pkg][-1](), l, r)
    plan = join._merge_bounds_plan(l, r, index)
    assert plan is not None, "the merge bounds plan must engage for this shape"
    mc = jmc if pkg == "jax" else tmc
    lb, ub = mc.merge_level_bounds(plan)
    return index, lb, ub, r.num_rows


class TestMergeBoundsParity:
    @pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
    def test_bounds_match_jax(self, rng, deltas):
        """The port's [lb, ub) equal the JAX package's, element-wise."""
        lt, rt = _tables(rng, 400, 700)
        _, jlb, jub, m = _merge_bounds("jax", lt, rt, deltas)
        _, tlb, tub, _ = _merge_bounds("torch", lt, rt, deltas)
        assert tuple(tlb.shape) == (np.asarray(jlb).shape[0], m)
        np.testing.assert_array_equal(tlb.numpy(), np.asarray(jlb)[:, :m])
        np.testing.assert_array_equal(tub.numpy(), np.asarray(jub)[:, :m])

    @pytest.mark.parametrize("backend", ["merge", "cosort"])
    @pytest.mark.parametrize("shape", list(SHAPES))
    def test_execute_row_parity(self, rng, shape, backend, monkeypatch):
        """execute() equals the JAX package's row for row on both emission
        backends — degenerate probes and inverted builds included."""
        lt, rt = _tables(rng, 500, 800, **SHAPES[shape])
        want, want_names, _ = _execute("jax", lt, rt, backend, monkeypatch)
        got, names, route = _execute("torch", lt, rt, backend, monkeypatch)
        assert route == ("merge" if backend == "merge" else "sort")
        assert names == want_names
        assert len(got) > 0 and got == want

    @pytest.mark.parametrize("alg,route", [
        ("SUPER_INTERVALS", "merge"), ("INTERVAL_TREE", "bsearch"),
        ("ARRAY_INTERVAL_TREE", "bsearch"), ("LAPPER", "window"),
    ])
    def test_algorithms(self, rng, monkeypatch, alg, route):
        """Each algorithm's strategy (merge for sort, bsearch, Lapper's
        window) equals the JAX package's row for row."""
        lt, rt = _tables(rng, 400, 600, degenerate=0.1, inverted=0.1)
        want, _, _ = _execute("jax", lt, rt, "merge", monkeypatch, alg=alg)
        got, _, took = _execute("torch", lt, rt, "merge", monkeypatch, alg=alg)
        assert took == route
        assert len(got) > 0 and got == want

    @pytest.mark.parametrize("backend", ["merge", "cosort"])
    def test_low_memory_capped_chunks(self, rng, monkeypatch, backend):
        """The capped continuation (low_memory, a small batch size) slices
        the emission into cap-sized chunks: same rows, same order as the
        JAX package and as the uncapped run."""
        lt, rt = _tables(rng, 400, 900)
        whole, _, _ = _execute("torch", lt, rt, backend, monkeypatch)
        kw = dict(low_memory=True)
        monkeypatch.setenv("SEQUILA_MAX_OUTPUT_BATCH_SIZE", "300")
        want, _, _ = _execute("jax", lt, rt, backend, monkeypatch, **kw)
        got, _, _ = _execute("torch", lt, rt, backend, monkeypatch, **kw)
        assert len(got) > 0 and got == want == whole

    @pytest.mark.parametrize("backend", ["merge", "cosort"])
    def test_execute_batches_parity(self, rng, monkeypatch, backend):
        """Streamed batches concatenate to the JAX package's batches and to
        the whole result, each bounded by 4x max_output_batch_size."""
        lt, rt = _tables(rng, 300, 800)
        monkeypatch.setenv("SEQUILA_EMIT_BACKEND", backend)
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        monkeypatch.setenv("SEQUILA_MAX_OUTPUT_BATCH_SIZE", "500")
        batches = {}
        for pkg in ("jax", "torch"):
            join, _, _ = _join(pkg, lt, rt)
            batches[pkg] = list(join.execute_batches(PKGS[pkg][-1]()))
        assert len(batches["torch"]) > 1
        assert all(b.num_rows <= 2000 for b in batches["torch"])
        got = [r for b in batches["torch"] for r in _rows(b)]
        assert got == [r for b in batches["jax"] for r in _rows(b)]
        whole, _, _ = _execute("jax", lt, rt, backend, monkeypatch)
        assert got == whole

    def test_span_overflow_falls_back(self, monkeypatch):
        """Coordinates spanning the full int32 range exceed the packed
        32-bit budget: the plan declines in both packages and execute()
        answers on the co-sort, row for row."""
        def wide(nn, seed):
            r = np.random.default_rng(seed)
            s = r.integers(-(2**31) + 10, 2**31 - 2000, nn).astype(np.int64)
            return pa.table({
                "contig": [f"c{int(k)}" for k in r.integers(0, 2, nn)],
                "s": s, "e": s + 1000,
            })

        lt, rt = wide(300, 1), wide(300, 2)
        join, l, r = _join("torch", lt, rt)
        index, *_ = join._prepare(TorchCtx(TorchConfig()), l, r)
        assert join._merge_bounds_plan(l, r, index) is None
        want, _, _ = _execute("jax", lt, rt, "merge", monkeypatch)
        got, _, route = _execute("torch", lt, rt, "merge", monkeypatch)
        assert route == "sort"
        assert got == want

    def test_pairs_match_oracle(self, rng):
        """The merge route's pairs equal the brute-force pair set."""
        lt, rt = _tables(rng, 250, 400, degenerate=0.1, inverted=0.1)
        index, lb, ub, _ = _merge_bounds("torch", lt, rt)
        b, p, total = materialize_pairs_from_bounds(index, lb, ub)
        lk = np.asarray(lt.column("contig").to_pylist(), dtype=object)
        rk = np.asarray(rt.column("contig").to_pylist(), dtype=object)
        codes = np.unique(np.concatenate([lk, rk]), return_inverse=True)[1].astype(np.int32)
        ob, op = oracle_pairs(
            codes[: len(lk)], lt.column("s").to_numpy().astype(np.int32),
            lt.column("e").to_numpy().astype(np.int32),
            codes[len(lk):], rt.column("s").to_numpy().astype(np.int32),
            rt.column("e").to_numpy().astype(np.int32),
        )
        assert total == len(ob) > 0
        assert sorted(zip(p.tolist(), b.tolist())) == sorted(zip(op.tolist(), ob.tolist()))

    @pytest.mark.parametrize("join_type,lkeys,rkeys", [
        ("left", 8, 5), ("right", 5, 8), ("full", 8, 5),
    ])
    def test_outer_joins(self, rng, monkeypatch, join_type, lkeys, rkeys):
        """Outer joins gather every pair, then NULL-pad the side whose keys
        the other lacks: row for row."""
        lt, rt = _tables(rng, 300, 500, lkeys=lkeys, rkeys=rkeys)
        kw = dict(join_type=join_type)
        want, want_names, _ = _execute("jax", lt, rt, "merge", monkeypatch, **kw)
        got, names, route = _execute("torch", lt, rt, "merge", monkeypatch, **kw)
        assert route == "merge"
        assert names == want_names
        assert any(None in r for r in got) and got == want

    def test_projection(self, rng, monkeypatch):
        """A projection gathers only the named columns, in their order."""
        lt, rt = _tables(rng, 300, 500)
        kw = dict(projection=[4, 1], projection_names=["q_start", "b_start"])
        want, want_names, _ = _execute("jax", lt, rt, "merge", monkeypatch, **kw)
        got, names, _ = _execute("torch", lt, rt, "merge", monkeypatch, **kw)
        assert names == want_names == ["q_start", "b_start"]
        assert len(got) > 0 and got == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["merge", "cosort"])
def test_execute_on_card_matches_cpu(rng, monkeypatch, cuda_device, backend):
    """execute() on the card equals the port's CPU run row for row; the
    merge route launches B1 and pack_view."""
    lt, rt = _tables(rng, 500, 800, degenerate=0.1, inverted=0.1)
    want, _, _ = _execute("torch", lt, rt, backend, monkeypatch)
    with metrics.recording() as rec:
        got, _, route = _execute("torch", lt, rt, backend, monkeypatch, device=cuda_device)
    assert got == want and len(got) > 0
    launches = rec.counts()
    launched = launches["launch.merge_path"] > 0 and launches["launch.pack_view"] > 0
    assert launched == (route == "merge")
