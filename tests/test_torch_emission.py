"""Port parity: the pair-emission ops of sequila_tpu_torch/ops/interval_join.py
and the index fields they read, against the JAX package on the same inputs.

Both packages build their interval index from the same numpy arrays; every
field emission reads (level layout, per-level maximum lengths, the host
twins of the level view, the window view) must be identical.  Each emission
op then runs in both packages on the same per-level bounds and must agree
exactly: offsets, emitted slots, compacted runs (pack16 on and off), the
host expansions, the window emission and the three strategies of
``materialize_pairs_from_bounds``, each picked by the shape of its data
and each forced on every shape.
The 2^31 emission guard raises the same ExecutionError with the limit
lowered.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.errors import ExecutionError as JaxExecutionError
from sequila_tpu.ops import interval_index as jii
from sequila_tpu.ops import interval_join as jij
from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.ops import interval_index as tii
from sequila_tpu_torch.ops import interval_join as tij


def _data(rng, n, m, nkeys=3, span=5000, max_len=900, inverted=0.0, degenerate=0.0,
          qkeys=None):
    lk = rng.integers(0, nkeys, n).astype(np.int32)
    ls = rng.integers(-span, span, n).astype(np.int32)
    le = (ls + rng.integers(0, max_len, n)).astype(np.int32)
    flip = rng.random(n) < inverted
    le[flip] = ls[flip] - rng.integers(1, 50, int(flip.sum())).astype(np.int32)
    qk = rng.integers(0, nkeys + 1 if qkeys is None else qkeys, m).astype(np.int32)
    qs = rng.integers(-span, span, m).astype(np.int32)
    qe = (qs + rng.integers(0, max_len, m)).astype(np.int32)
    flip = rng.random(m) < degenerate
    qe[flip] = qs[flip] - rng.integers(1, 50, int(flip.sum())).astype(np.int32)
    return lk, ls, le, qk, qs, qe


def _indexes(lk, ls, le):
    return jii.build_interval_index(lk, ls, le), tii.build_interval_index(lk, ls, le, device="cpu")


def _q(qk, qs, qe):
    """The probe columns as JAX arrays and as torch tensors."""
    return (
        tuple(jnp.asarray(a) for a in (qk, qs, qe)),
        tuple(torch.from_numpy(a) for a in (qk, qs, qe)),
    )


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bounds(rng, **kw):
    """(JAX index, port index, lb, ub as numpy) from the JAX co-sort bounds."""
    lk, ls, le, qk, qs, qe = _data(rng, **kw)
    jidx, tidx = _indexes(lk, ls, le)
    (jq, _) = _q(qk, qs, qe)
    lb, ub = jij.overlap_bounds(jidx, *jq, "sort")
    return jidx, tidx, np.array(lb), np.array(ub)


class TestIndexFields:
    @pytest.mark.parametrize("shape", [
        dict(n=600), dict(n=600, inverted=0.2), dict(n=1), dict(n=0),
        dict(n=900, nkeys=1, max_len=4000),
    ])
    def test_host_twins_and_window_view(self, rng, shape):
        n = shape.pop("n")
        lk, ls, le, *_ = _data(rng, n, 1, **shape)
        jidx, tidx = _indexes(lk, ls, le)
        for f in ("level_sizes", "level_pad", "level_offsets", "max_lens", "num_levels"):
            assert getattr(tidx, f) == getattr(jidx, f), f
        for f in ("pos_host", "keys_host", "starts_host", "ends_host"):
            np.testing.assert_array_equal(getattr(tidx, f), getattr(jidx, f), err_msg=f)
        for f in ("levels", "keys", "starts", "ends", "pos"):
            np.testing.assert_array_equal(_np(getattr(tidx, f)), _np(getattr(jidx, f)), err_msg=f)
        *twin, t_max = tidx.window_view
        *jwin, j_max = jidx.window_view
        assert t_max == j_max
        for t, j in zip(twin, jwin):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class TestEmissionOps:
    def test_pair_offsets(self, rng):
        _, _, lb, ub = _bounds(rng, n=500, m=300)
        j_off, j_lb = jij.pair_offsets(jnp.asarray(lb), jnp.asarray(ub))
        t_off, t_lb = tij.pair_offsets(torch.from_numpy(lb), torch.from_numpy(ub))
        np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
        np.testing.assert_array_equal(t_lb.numpy(), np.asarray(j_lb))

    @pytest.mark.parametrize("base", [0, 37])
    def test_emit_pairs(self, rng, base):
        jidx, tidx, lb, ub = _bounds(rng, n=500, m=300)
        j_off, j_lb = jij.pair_offsets(jnp.asarray(lb), jnp.asarray(ub))
        t_off, t_lb = tij.pair_offsets(torch.from_numpy(lb), torch.from_numpy(ub))
        cap = jii._bucket(int(j_off[-1]), minimum=1024)
        kw = dict(capacity=cap, num_levels=jidx.num_levels, level_offsets=jidx.level_offsets)
        want = jij.emit_pairs(j_off, j_lb, jidx.pos, base, **kw)
        got = tij.emit_pairs(t_off, t_lb, tidx.pos, base, **kw)
        assert int(j_off[-1]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_counts_and_nnz(self, rng):
        _, _, lb, ub = _bounds(rng, n=500, m=300, degenerate=0.1)
        want = jij._counts_and_nnz(jnp.asarray(lb), jnp.asarray(ub))
        got = tij._counts_and_nnz(torch.from_numpy(lb), torch.from_numpy(ub))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("pack16", [True, False])
    def test_compact_runs(self, rng, pack16):
        jidx, _, lb, ub = _bounds(rng, n=500, m=300)
        nnz = int(np.asarray(jij._counts_and_nnz(jnp.asarray(lb), jnp.asarray(ub)))[-2])
        cap = jii._bucket(max(nnz, 1), minimum=1024)
        kw = dict(capacity=cap, level_offsets=jidx.level_offsets, pack16=pack16)
        want = np.asarray(jij._compact_runs(jnp.asarray(lb), jnp.asarray(ub), **kw))
        got = tij._compact_runs(torch.from_numpy(lb), torch.from_numpy(ub), **kw).numpy()
        np.testing.assert_array_equal(got, want)
        # the unpacked run lengths match too
        cnt = want[cap:]
        np.testing.assert_array_equal(
            tij._unpack16(got[cap:], nnz) if pack16 else got[cap : cap + nnz],
            jij._unpack16(cnt, nnz) if pack16 else cnt[:nnz],
        )

    def test_compact_runs_capacity_short(self, rng):
        """Cells past the capacity are dropped, as XLA's mode='drop' does."""
        jidx, _, lb, ub = _bounds(rng, n=500, m=300)
        kw = dict(capacity=64, level_offsets=jidx.level_offsets, pack16=False)
        want = np.asarray(jij._compact_runs(jnp.asarray(lb), jnp.asarray(ub), **kw))
        got = tij._compact_runs(torch.from_numpy(lb), torch.from_numpy(ub), **kw).numpy()
        np.testing.assert_array_equal(got, want)

    def test_host_expansions_and_probe_ids(self, rng):
        jidx, tidx, lb, ub = _bounds(rng, n=500, m=300)
        counts = np.asarray(jij._counts_and_nnz(jnp.asarray(lb), jnp.asarray(ub)))[:-2]
        total = int(counts.sum())
        np.testing.assert_array_equal(
            tij._expand_bounds_host(tidx, lb, ub, total),
            jij._expand_bounds_host(jidx, lb, ub, total),
        )
        np.testing.assert_array_equal(
            tij._probe_ids(counts, total), jij._probe_ids(counts, total)
        )
        g0 = np.array([3, 10, 40], np.int32)
        cnt = np.array([2, 5, 1], np.int32)
        np.testing.assert_array_equal(
            tij._expand_runs_host(tidx.pos_host, g0, cnt, 8),
            jij._expand_runs_host(jidx.pos_host, g0, cnt, 8),
        )

    def test_sat_sub_i32(self):
        qs = np.array([-(2**31) + 10, 100, 0, 2**31 - 1], np.int32)
        for ml in (100, 0, -5, 2**31 - 1):
            want = np.asarray(jij.sat_sub_i32(jnp.asarray(qs), jnp.asarray(ml, jnp.int32)))
            got = tij.sat_sub_i32(torch.from_numpy(qs), ml).numpy()
            np.testing.assert_array_equal(got, want)
        assert tij.sat_sub_i32(torch.from_numpy(qs), 100).tolist()[:3] == [-(2**31), 0, -100]

    def test_emit_window(self, rng):
        lk, ls, le, qk, qs, qe = _data(rng, 400, 250, inverted=0.1, degenerate=0.1)
        jidx, tidx = _indexes(lk, ls, le)
        jq, tq = _q(qk, qs, qe)
        jwin, twin = jidx.window_view, tidx.window_view
        lo_q = np.maximum(qs.astype(np.int64) - jwin[4], -(2**31)).astype(np.int32)
        cap = 8192
        want = jij._emit_window(*jwin[:4], jnp.asarray(lo_q), *jq, capacity=cap)
        got = tij._emit_window(*twin[:4], torch.from_numpy(lo_q), *tq, capacity=cap)
        assert int(np.asarray(want[2]).sum()) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("method", ["sort", "bsearch", "window"])
    def test_materialize_pairs(self, rng, method):
        """Whole-chunk emission by each rank strategy: same pairs, same
        order, as the JAX package."""
        lk, ls, le, qk, qs, qe = _data(rng, 500, 300, inverted=0.1, degenerate=0.1)
        jidx, tidx = _indexes(lk, ls, le)
        jq, tq = _q(qk, qs, qe)
        jb, jp, jt = jij.materialize_pairs(jidx, *jq, method)
        tb, tp, tt = tij.materialize_pairs(tidx, *tq, method)
        assert tt == jt > 0
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)


# shapes whose bounds make emission_strategy pick each representation
STRATEGY_SHAPES = {
    # short intervals: about one match per run, few matches per cell
    "emit": dict(n=500, m=300, max_len=40, span=20_000),
    # a few long build rows: few nonzero cells, long runs
    "runs": dict(n=900, m=200, nkeys=1, max_len=60, span=3000),
    # dense: every (probe, level) cell holds a run
    "bounds": dict(n=200, m=100, nkeys=1, qkeys=1, max_len=3000, span=10),
}


class TestStrategies:
    @pytest.mark.parametrize("strategy", list(STRATEGY_SHAPES))
    def test_rule_picks_by_shape(self, rng, strategy):
        """The rule picks ``strategy`` on its shape, and the pairs equal the
        JAX package's (which picks by the same rule on the same bounds)."""
        jidx, tidx, lb, ub = _bounds(rng, **STRATEGY_SHAPES[strategy])
        packed = tij._counts_and_nnz(torch.from_numpy(lb), torch.from_numpy(ub)).numpy()
        total, nnz = int(packed[:-2].sum()), int(packed[-2])
        assert tij.emission_strategy(total, nnz, *lb.shape) == strategy
        jb, jp, jt = jij.materialize_pairs_from_bounds(jidx, jnp.asarray(lb), jnp.asarray(ub))
        tb, tp, tt = tij.materialize_pairs_from_bounds(
            tidx, torch.from_numpy(lb), torch.from_numpy(ub)
        )
        assert tt == jt == total > 0
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)

    @pytest.mark.parametrize("strategy", ["runs", "bounds", "emit"])
    @pytest.mark.parametrize("shape", list(STRATEGY_SHAPES))
    def test_forced_strategy(self, rng, monkeypatch, shape, strategy):
        """Every strategy, forced, gives the JAX package's pairs on every
        shape: the representations are interchangeable bit for bit."""
        jidx, tidx, lb, ub = _bounds(rng, **STRATEGY_SHAPES[shape])
        jb, jp, jt = jij.materialize_pairs_from_bounds(jidx, jnp.asarray(lb), jnp.asarray(ub))
        monkeypatch.setattr(tij, "emission_strategy", lambda *a: strategy)
        tb, tp, tt = tij.materialize_pairs_from_bounds(
            tidx, torch.from_numpy(lb), torch.from_numpy(ub)
        )
        assert tt == jt
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tp, jp)

    def test_no_pairs(self, rng):
        """Bounds with no pair give empty int32 rows in both packages."""
        jidx, tidx, lb, _ = _bounds(rng, n=50, m=50)
        want = jij.materialize_pairs_from_bounds(jidx, jnp.asarray(lb), jnp.asarray(lb))
        got = tij.materialize_pairs_from_bounds(tidx, torch.from_numpy(lb), torch.from_numpy(lb))
        assert got[2] == want[2] == 0
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == np.int32 and g.shape == np.asarray(w).shape == (0,)


class TestEmitLimit:
    """Both packages refuse a chunk of _EMIT_LIMIT or more pairs (or window
    candidates) with the same ExecutionError; lowered here to 8."""

    @pytest.mark.parametrize("method,match", [
        ("sort", "pairs"), ("bsearch", "pairs"), ("window", "candidates"),
    ])
    def test_guard(self, rng, monkeypatch, method, match):
        lk, ls, le, qk, qs, qe = _data(rng, 200, 100)
        jidx, tidx = _indexes(lk, ls, le)
        jq, tq = _q(qk, qs, qe)
        monkeypatch.setattr(jij, "_EMIT_LIMIT", 8)
        monkeypatch.setattr(tij, "_EMIT_LIMIT", 8)
        with pytest.raises(JaxExecutionError, match=match) as jerr:
            jij.materialize_pairs(jidx, *jq, method)
        with pytest.raises(ExecutionError, match=match) as terr:
            tij.materialize_pairs(tidx, *tq, method)
        assert str(terr.value) == str(jerr.value)
