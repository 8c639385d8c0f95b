"""The JAX package's `tests/test_review_regressions.py`, run against the port on
the CPU (tests/torch_suites.py).

The cases that call the index and kernel layer directly are rewritten
here under their own names, to the port's signatures: the index built
with ``device="cpu"``, torch tensors where the JAX suite passes ``jnp``
arrays, ``rank_lex_resident`` (B3's entry point) for ``rank_lex_pallas``,
and the port's ``make_mesh(devices, part=...)`` over eight CPU devices
with its ``shard_totals(mesh, bounds)``.  Their values and assertions are
the JAX suite's."""

import numpy as np
import pytest
import torch

from torch_suites import load, port_on_cpu  # noqa: F401

suite = load("test_review_regressions")
globals().update(suite.exported)

import sequila_tpu_torch.ops.interval_join as ij  # noqa: E402
from sequila_tpu_torch.errors import ExecutionError  # noqa: E402
from sequila_tpu_torch.ops.interval_index import build_interval_index  # noqa: E402
from sequila_tpu_torch.ops.interval_join import count_matches  # noqa: E402
from sequila_tpu_torch.ops.oracle import oracle_counts, oracle_pairs  # noqa: E402
from sequila_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


def index_of(lk, ls, le):
    return build_interval_index(np.asarray(lk), np.asarray(ls), np.asarray(le), device="cpu")


def t32(x):
    return torch.as_tensor(np.asarray(x, np.int32))


class TestBucketFullPaths(suite.TestBucketFullPaths):
    def test_bsearch_full_bucket_exact(self):
        lk, ls, le = self._full_bucket_data()
        index = index_of(lk, ls, le)
        qk = t32(np.zeros(8))
        qs = t32([10**6, 0, 635, 1, 300, 636, 2**31 - 10, 50])
        qe = qs + 3
        want = oracle_counts(lk, ls, le, np.zeros(8, np.int32), qs.numpy(), qe.numpy())
        for method in ("bsearch", "sort", "bits"):
            got = count_matches(index, qk, qs, qe, method).numpy()
            np.testing.assert_array_equal(got, want, err_msg=method)

    def test_nearest_full_bucket(self):
        lk, ls, le = self._full_bucket_data()
        index = index_of(lk, ls, le)
        qk = t32(np.zeros(2))
        qs = t32([10_000, 633])
        qe = t32([10_005, 634])
        got = ij.nearest_match(index, qk, qs, qe).numpy()
        assert got[0] == 63
        assert got[1] == 63


class TestInvertedBuildIntervals(suite.TestInvertedBuildIntervals):
    def test_kernel_bits_guarded_by_operator(self):
        lk, ls, le, rk, rs, re = self._data()
        want = oracle_counts(lk, ls, le, rk, rs, re)
        index = index_of(lk, ls, le)
        got = count_matches(index, t32(rk), t32(rs), t32(re), "sort").numpy()
        np.testing.assert_array_equal(got, want)


class TestMaterializeOverflowGuard(suite.TestMaterializeOverflowGuard):
    def test_total64_is_int64(self):
        lb = torch.zeros((1, 4), dtype=torch.int32)
        ub = torch.full((1, 4), 2**30, dtype=torch.int32)
        total = int(ij.counts_from_bounds(lb, ub).numpy().astype(np.int64).sum())
        assert total == 4 * 2**30


class TestChunkRankNoPadTail(suite.TestChunkRankNoPadTail):
    def test_chunk_aligned_build(self):
        from sequila_tpu_torch.ops.cuda.rank_kernel import CHUNK, rank_lex_resident
        from sequila_tpu_torch.ops.ranks import np_rank_lex

        rng = np.random.default_rng(11)
        n = 2 * CHUNK
        bk = np.sort(rng.integers(0, 5, n)).astype(np.int32)
        bv = rng.integers(0, 10**6, n).astype(np.int32)
        m = 512
        qk = rng.integers(0, 6, m).astype(np.int32)
        qv = rng.integers(10**6 - 5, 2**20 - 2, m).astype(np.int32)
        got = rank_lex_resident((t32(bk), t32(bv)), (t32(qk), t32(qv)), side="left").numpy()
        want = np_rank_lex((bk, bv), (qk, qv), side="left")
        np.testing.assert_array_equal(got, want)


class TestEmitGuards(suite.TestEmitGuards):
    def test_window_guard_raises_execution_error(self, monkeypatch):
        lk, ls, le, qk, qs, qe = self._data()
        index = index_of(lk, ls, le)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="candidates"):
            ij.materialize_pairs_window(index, t32(qk), t32(qs), t32(qe))

    def test_sort_emit_guard_raises_execution_error(self, monkeypatch):
        lk, ls, le, qk, qs, qe = self._data()
        index = index_of(lk, ls, le)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="pairs"):
            ij.materialize_pairs(index, t32(qk), t32(qs), t32(qe), "sort")


class TestClosestKTieBreak(suite.TestClosestKTieBreak):
    def _index(self):
        lk = np.zeros(3, np.int32)
        ls = np.array([1, 2, 3], np.int32)
        le = np.full(3, 10, np.int32)  # three rows tie on (key, end)
        return index_of(lk, ls, le)


class TestShardTotalsGuard(suite.TestShardTotalsGuard):
    def test_partitioned_pairs_raises_over_limit(self, monkeypatch):
        from sequila_tpu_torch.parallel.partitioned_join import partitioned_pairs

        mesh = make_mesh(CPU8, part=2)
        lk = np.zeros(64, np.int32)
        ls = np.arange(64, dtype=np.int32)
        le = ls + 1000
        rk = np.zeros(32, np.int32)
        rs = np.full(32, 5, np.int32)
        re = np.full(32, 50, np.int32)
        monkeypatch.setattr(ij, "_EMIT_LIMIT", 8)
        with pytest.raises(ExecutionError, match="shard"):
            partitioned_pairs(mesh, lk, ls, le, rk, rs, re)

    def test_shard_totals_dtype_int64(self, rng):
        from sequila_tpu_torch.parallel.partitioned_join import (
            _partitioned_inputs,
            shard_bounds,
            shard_totals,
        )

        mesh = make_mesh(CPU8, part=2)
        lk = rng.integers(0, 4, 100).astype(np.int32)
        ls = rng.integers(0, 1000, 100).astype(np.int32)
        le = ls + rng.integers(0, 50, 100).astype(np.int32)
        _, meta, didx, dq, _ = _partitioned_inputs(mesh, lk, ls, le, lk, ls, le)
        totals = shard_totals(mesh, shard_bounds(mesh, meta, didx, dq))
        assert totals.dtype == np.int64
        want = oracle_counts(lk, ls, le, lk, ls, le).sum()
        assert totals.sum() == want


class TestSatSubI32(suite.TestSatSubI32):
    def test_saturates_at_int32_min(self):
        qs = t32([-(2**31) + 10, 100, 0])
        ml = torch.tensor(100, dtype=torch.int32)
        out = ij.sat_sub_i32(qs, ml).numpy()
        assert out.tolist() == [-(2**31), 0, -100]

    def test_window_pairs_extreme_negative_probe(self):
        lk = np.zeros(4, np.int32)
        ls = np.array([-(2**31) + 5, -1000, 0, 500], np.int32)
        le = np.array([-(2**31) + 600, -500, 100, 600], np.int32)
        qk = np.zeros(2, np.int32)
        qs = np.array([-(2**31) + 50, -800], np.int32)
        qe = np.array([-(2**31) + 60, -600], np.int32)
        index = index_of(lk, ls, le)
        b, p, n = ij.materialize_pairs_window(index, t32(qk), t32(qs), t32(qe))
        got = sorted(zip(p.tolist(), b.tolist()))
        want = sorted(zip(*reversed(oracle_pairs(lk, ls, le, qk, qs, qe))))
        assert got == want
