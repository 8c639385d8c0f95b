"""Port parity: every count(*) route of IntervalJoinExec.count_rows.

With SEQUILA_HOST_THRESHOLD=0 both packages count on their device route:
the port on the CPU (the kernels' plain versions), the JAX package on its
CPU backend (the Pallas kernels in interpret mode).  The same arrow
tables go through both, for every SEQUILA_COUNT_BACKEND, for the level
loop under each algorithm's rank strategy, and for the shapes the merge
and co-sort routes decline: degenerate probes, inverted builds, spans
beyond 32 bits, multi-column keys, computed keys, computed bounds and no
equi-key at all.  Counts are integers: exact equality.  The port's route
metric shows which route answered.
"""

import numpy as np
import pyarrow as pa
import pytest

from sequila_tpu.config import Algorithm as JaxAlgorithm
from sequila_tpu.config import SequilaConfig as JaxConfig
from sequila_tpu.exec import context as jctx
from sequila_tpu.exec.joins import interval_join as jij
from sequila_tpu.exec.plan import ScanExec as JaxScan
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.planner import expr as jexpr
from sequila_tpu.planner import intervals as jiv
from sequila_tpu_torch.config import Algorithm as TorchAlgorithm
from sequila_tpu_torch.config import SequilaConfig as TorchConfig
from sequila_tpu_torch.exec import context as tctx
from sequila_tpu_torch.exec.joins import interval_join as tij
from sequila_tpu_torch.exec.plan import ScanExec as TorchScan
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.planner import expr as texpr
from sequila_tpu_torch.planner import intervals as tiv

PKGS = {
    "jax": (jexpr, jiv, jij, JaxScan, JaxTable, JaxAlgorithm,
            lambda: jctx.ExecContext(JaxConfig())),
    "torch": (texpr, tiv, tij, TorchScan, TorchTable, TorchAlgorithm,
              lambda: tctx.ExecContext(TorchConfig())),
}


def _arrow(rng, n, nkeys, span=30_000, zero_len=0.0, inverted=0.0):
    s = rng.integers(-span, span, n).astype(np.int64)
    e = s + rng.integers(1, 2500, n)
    e[: n // 8] = s[: n // 8] + 12_000  # long intervals: several levels
    z = rng.random(n) < zero_len
    e[z] = s[z]  # zero-length rows (insertions)
    inv = rng.random(n) < inverted
    e[inv] = s[inv] - 7
    return pa.table({
        "contig": [f"chr{int(k)}" for k in rng.integers(0, nkeys, n)],
        "strand": rng.choice(["+", "-"], n),
        "k": rng.integers(0, nkeys, n).astype(np.int64),
        "s": s,
        "e": e,
    })


def _bound(ex, idx, d=0, scale=None):
    col = ex.Column("x", idx)
    if scale is not None:
        return ex.BinaryExpr(col, "*", ex.Literal(scale))
    if d == 0:
        return col
    return ex.BinaryExpr(col, "+" if d > 0 else "-", ex.Literal(abs(d)))


def _join(pkg, lt, rt, keys="contig", deltas=(0, 0, 0, 0), alg="COITREES", scale=None):
    ex, iv, mod, Scan, Table, Alg, _ = PKGS[pkg]
    if keys == "contig":
        on = [(ex.Column("contig", 0), ex.Column("contig", 0))]
    elif keys == "multi":
        on = [(ex.Column("contig", 0), ex.Column("contig", 0)),
              (ex.Column("strand", 1), ex.Column("strand", 1))]
    elif keys == "computed":
        on = [(ex.BinaryExpr(ex.Column("k", 2), "+", ex.Literal(1)),
               ex.BinaryExpr(ex.Column("k", 2), "+", ex.Literal(1)))]
    else:  # no equi-key: one global key segment
        on = [(ex.Literal(0), ex.Literal(0))]
    d_bs, d_be, d_qs, d_qe = deltas
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return mod.IntervalJoinExec(
        Scan("l", Table(lt)), Scan("r", Table(rt)), on=on, filter_=None,
        intervals=iv.ColIntervals(
            iv.ColInterval(_bound(ex, 3, d_bs, scale), _bound(ex, 4, d_be, scale)),
            iv.ColInterval(_bound(ex, 3, d_qs, scale), _bound(ex, 4, d_qe, scale)),
        ),
        algorithm=Alg[alg], **kw,
    )


def _counts(lt, rt, **kw):
    """(port count, JAX count, the port's route)."""
    want = _join("jax", lt, rt, **kw).count_rows(PKGS["jax"][6]())
    join = _join("torch", lt, rt, **kw)
    ctx = PKGS["torch"][6]()
    got = join.count_rows(ctx)
    routes = [k for k in ctx.metrics.counters[join.op_id()] if k.startswith("count_route_")]
    assert len(routes) == 1, routes
    return got, want, routes[0][len("count_route_"):]


@pytest.fixture(autouse=True)
def device_route(monkeypatch):
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")


@pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
@pytest.mark.parametrize("backend", ["merge", "stream", "cosort"])
def test_every_backend_matches_jax(rng, monkeypatch, backend, deltas):
    monkeypatch.setenv("SEQUILA_COUNT_BACKEND", backend)
    got, want, route = _counts(_arrow(rng, 1200, 5), _arrow(rng, 1700, 6), deltas=deltas)
    assert route == backend
    assert got == want > 0


@pytest.mark.parametrize("alg,shape", [
    ("COITREES", "degenerate"), ("INTERVAL_TREE", "degenerate"),
    ("LAPPER", "degenerate"), ("SUPER_INTERVALS", "inverted"),
    ("ARRAY_INTERVAL_TREE", "inverted"), ("COITREES", "inverted"),
])
def test_level_loop_matches_jax(rng, alg, shape):
    """Half-open joins against zero-length probes (degenerate after the
    planner's end - 1) and inverted builds go through the level loop under
    the algorithm's rank strategy (sort, bsearch, window)."""
    if shape == "degenerate":
        lt, rt = _arrow(rng, 1500, 4), _arrow(rng, 1300, 4, zero_len=0.1)
        deltas = (0, -1, 0, -1)
    else:
        lt, rt = _arrow(rng, 1500, 4, inverted=0.05), _arrow(rng, 1300, 4)
        deltas = (0, 0, 0, 0)
    got, want, route = _counts(lt, rt, deltas=deltas, alg=alg)
    assert route == "level"
    assert got == want > 0


def test_level_loop_mixed_chunks(rng, monkeypatch):
    """Several probe chunks: the clean ones take BITS, the ones with
    degenerate rows the level strategy, summed in int64."""
    monkeypatch.setattr(jij, "_FULL_MODE_CHUNK", 256)
    monkeypatch.setattr(tij, "_FULL_MODE_CHUNK", 256)
    rt = _arrow(rng, 1100, 3)
    e = rt["e"].to_numpy().copy()
    e[700:705] = rt["s"].to_numpy()[700:705] - 1  # degenerate rows in chunk 2 only
    rt = rt.set_column(4, "e", pa.array(e))
    got, want, route = _counts(_arrow(rng, 900, 3), rt)
    assert route == "level"
    assert got == want > 0


@pytest.mark.parametrize("keys,route", [
    ("multi", "level"), ("computed", "level"), ("none", "cosort"),
])
def test_key_shapes_match_jax(rng, keys, route):
    got, want, took = _counts(_arrow(rng, 800, 3), _arrow(rng, 900, 3), keys=keys)
    assert took == route
    assert got == want > 0


def test_computed_bounds_match_jax(rng):
    got, want, route = _counts(_arrow(rng, 800, 3), _arrow(rng, 900, 3), scale=2)
    assert route == "level"
    assert got == want > 0


def test_span_beyond_32_bits_matches_jax(rng):
    def wide(n, seed):
        r = np.random.default_rng(seed)
        t = _arrow(r, n, 2)
        s = r.integers(-(2**31), 2**31 - 200, n).astype(np.int64)
        return t.set_column(3, "s", pa.array(s)).set_column(4, "e", pa.array(s + 100))

    got, want, route = _counts(wide(600, 1), wide(800, 2))
    assert route == "cosort"
    assert got == want


def test_level_index_is_cached_per_device(rng):
    join = _join("torch", _arrow(rng, 500, 3), _arrow(rng, 400, 3, zero_len=0.2),
                 deltas=(0, -1, 0, -1))
    ctx = PKGS["torch"][6]()
    first = join.count_rows(ctx)
    left, right = join.children[0].execute(ctx), join.children[1].execute(ctx)
    index = join._prepare(ctx, left, right)[0]
    assert join._prepare(ctx, left, right)[0] is index
    assert index.device.type == "cpu" and index.keys.device.type == "cpu"
    assert join.count_rows(ctx) == first
