"""The JAX package's `tests/test_genomic_ops.py`, run against the port on the CPU
(tests/torch_suites.py).

The cases that build an interval index directly are rewritten here under
their own names: the port's ``build_interval_index`` requires ``device``
(and has no ``to_device``), so they name ``device="cpu"``.  Their values
and assertions are the JAX suite's."""

import numpy as np
import pytest

from torch_suites import load, port_on_cpu  # noqa: F401

suite = load("test_genomic_ops")
globals().update(suite.exported)

from sequila_tpu_torch.ops import genomic  # noqa: E402
from sequila_tpu_torch.ops.genomic import _closest_k_scan, closest_k  # noqa: E402
from sequila_tpu_torch.ops.interval_index import build_interval_index  # noqa: E402


class TestCoverage(suite.TestCoverage):
    def test_against_oracle(self, rng):
        n, m = 300, 150
        bk = rng.integers(0, 3, n).astype(np.int32)
        bs = rng.integers(0, 3000, n).astype(np.int32)
        be = bs + rng.integers(0, 200, n).astype(np.int32)
        qk = rng.integers(0, 4, m).astype(np.int32)
        qs = rng.integers(0, 3000, m).astype(np.int32)
        qe = qs + rng.integers(0, 200, m).astype(np.int32)
        idx = build_interval_index(bk, bs, be, device="cpu")
        counts, bases = genomic.coverage(idx, qk, qs, qe)
        for i in range(m):
            mask = (bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i])
            assert counts[i] == mask.sum()
            want = np.sum(
                np.minimum(be[mask], qe[i]).astype(np.int64)
                - np.maximum(bs[mask], qs[i])
            )
            assert bases[i] == want, f"row {i}"


class TestVectorizedClosestK(suite.TestVectorizedClosestK):
    @pytest.mark.parametrize("k", [1, 2, 3, 5])
    def test_matches_scan(self, rng, k):
        bk, bs, be, qk, qs, qe = self._tables(rng, 200, 150)
        idx = build_interval_index(bk, bs, be, device="cpu")
        rows, dists = closest_k(idx, qk, qs, qe, k=k)
        srows, sdists = _closest_k_scan(idx, qk, qs, qe, k)
        np.testing.assert_array_equal(dists, sdists)
        for i in range(len(qk)):
            for j in range(k):
                if rows[i, j] < 0:
                    assert srows[i, j] < 0
                    continue
                g = int(rows[i, j])
                assert bk[g] == qk[i]
                d = (
                    qs[i] - be[g]
                    if be[g] < qs[i]
                    else (bs[g] - qe[i] if bs[g] > qe[i] else 0)
                )
                assert d == dists[i, j]

    def test_sparse_rings(self, rng):
        bk = np.array([0, 0, 1], np.int32)
        bs = np.array([10, 100, 5], np.int32)
        be = np.array([20, 110, 8], np.int32)
        idx = build_interval_index(bk, bs, be, device="cpu")
        rows, dists = closest_k(
            idx,
            np.array([0, 1, 2], np.int32),
            np.array([50, 200, 50], np.int32),
            np.array([60, 210, 60], np.int32),
            k=4,
        )
        assert rows[0, :2].tolist() in ([0, 1], [1, 0])
        assert rows[0, 2:].tolist() == [-1, -1]
        assert rows[1].tolist() == [2, -1, -1, -1]
        assert dists[1, 0] == 200 - 8
        assert rows[2].tolist() == [-1] * 4

    def test_degenerate_probe_falls_back(self, rng):
        bk, bs, be, qk, qs, qe = self._tables(rng, 100, 60)
        qs[::5], qe[::5] = qe[::5] + 10, qs[::5]
        idx = build_interval_index(bk, bs, be, device="cpu")
        rows, dists = closest_k(idx, qk, qs, qe, k=2)
        srows, sdists = _closest_k_scan(idx, qk, qs, qe, 2)
        np.testing.assert_array_equal(dists, sdists)

    @pytest.mark.slow
    def test_closest_k3_500k_fast(self):
        import time

        rng = np.random.default_rng(5)
        n = m = 500_000
        bk = rng.integers(0, 24, n).astype(np.int32)
        bs = rng.integers(0, 200_000_000, n).astype(np.int32)
        be = bs + rng.integers(0, 20_000, n).astype(np.int32)
        qk = rng.integers(0, 24, m).astype(np.int32)
        qs = rng.integers(0, 200_000_000, m).astype(np.int32)
        qe = qs + rng.integers(0, 20_000, m).astype(np.int32)
        idx = build_interval_index(bk, bs, be, device="cpu")
        t0 = time.perf_counter()
        rows, dists = closest_k(idx, qk, qs, qe, k=3)
        dt = time.perf_counter() - t0
        assert dt < 30.0, f"closest k=3 500k x 500k took {dt:.1f}s"
        assert (rows[:, 0] >= 0).all()
