"""Port parity: sequila_tpu_torch/ops/cuda/rank_kernel.py (B3) vs
sequila_tpu/ops/pallas/rank_kernel.py.

``rank_lex_resident`` (the port of ``rank_lex_pallas``) and
``rank_sorted_resident`` (the port of ``_pallas_rank_sorted``) against the
JAX functions (the Pallas kernel in interpret mode on the CPU) on the
cases of the JAX tests: random tuples, one equal run across chunk
boundaries, empty sides, the co-sort fallback above the build cap, and a
chunk-aligned build with no PAD tail.  Every comparison is exact.  The
``cuda`` tests hold the kernel against its plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.ops.pallas import rank_kernel as jrk
from sequila_tpu.ops.ranks import np_rank_lex
from sequila_tpu_torch.ops.cuda import rank_kernel as trk
from sequila_tpu_torch.utils import metrics


def _t(a, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _both(bk, bv, qk, qv, side):
    want = np.asarray(jrk.rank_lex_pallas(
        (jnp.asarray(bk), jnp.asarray(bv)), (jnp.asarray(qk), jnp.asarray(qv)), side
    ))
    got = trk.rank_lex_resident((_t(bk), _t(bv)), (_t(qk), _t(qv)), side)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("side", ["left", "right"])
def test_random_tuples_match_jax(rng, side):
    bk = rng.integers(0, 4, 1500).astype(np.int32)
    bv = rng.integers(-5000, 5000, 1500).astype(np.int32)
    qk = rng.integers(0, 5, 900).astype(np.int32)
    qv = rng.integers(-5200, 5200, 900).astype(np.int32)
    got, want = _both(bk, bv, qk, qv, side)
    np.testing.assert_array_equal(got, want)


def test_duplicates_at_chunk_boundaries():
    n = 6000
    bk = np.zeros(n, np.int32)
    bv = np.full(n, 7, np.int32)  # one giant equal run
    qk = np.zeros(5, np.int32)
    qv = np.array([6, 7, 7, 8, 7], np.int32)
    left, want_l = _both(bk, bv, qk, qv, "left")
    right, want_r = _both(bk, bv, qk, qv, "right")
    np.testing.assert_array_equal(left, want_l)
    np.testing.assert_array_equal(right, want_r)
    np.testing.assert_array_equal(left, [0, 0, 0, n, 0])
    np.testing.assert_array_equal(right, [0, n, n, n, n])


def test_empty_sides_and_cap_fallback(rng, monkeypatch):
    e = torch.empty(0, dtype=torch.int32)
    assert trk.rank_lex_resident((e, e), (e, e)).shape == (0,)
    bk = rng.integers(0, 3, 100).astype(np.int32)
    assert trk.rank_lex_resident((_t(bk), _t(bk)), (e, e)).shape == (0,)
    assert trk.rank_lex_resident((e, e), (_t(bk), _t(bk))).tolist() == [0] * 100
    qk = rng.integers(0, 4, 50).astype(np.int32)
    # above the cap both rank by their co-sort counterpart
    monkeypatch.setattr(trk, "MAX_RESIDENT_BUILD", 10)
    monkeypatch.setattr(jrk, "MAX_VMEM_BUILD", 10)
    got, want = _both(bk, bk, qk, qk, "right")
    np.testing.assert_array_equal(got, want)


def test_chunk_aligned_build_no_pad_tail():
    rng = np.random.default_rng(11)
    n = 2 * trk.CHUNK  # exactly chunk-aligned: padding adds no rows
    bk = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    bv = rng.integers(0, 10**6, n).astype(np.int32)
    qk = rng.integers(0, 6, 512).astype(np.int32)
    qv = rng.integers(10**6 - 5, 2**20 - 2, 512).astype(np.int32)
    got, want = _both(bk, bv, qk, qv, "left")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_rank_lex((bk, bv), (qk, qv), side="left"))


@pytest.mark.parametrize("strict", [True, False])
def test_rank_sorted_resident_matches_jax_kernel(rng, strict):
    """The sorted-input kernels themselves, m not a multiple of the block
    on the port's side (the JAX kernel gets the block-padded queries)."""
    n_pad, m = 3 * trk.CHUNK, 700
    k = np.sort(rng.integers(-2, 3, n_pad)).astype(np.int32)
    v = rng.integers(-100, 100, n_pad).astype(np.int32)
    order = np.lexsort((v, k))
    ak, av = k[order], v[order]
    qk = rng.integers(-3, 4, m).astype(np.int32)
    qv = rng.integers(-120, 120, m).astype(np.int32)
    qo = np.lexsort((qv, qk))
    qk, qv = qk[qo], qv[qo]
    m_pad = -(-m // trk.BLOCK) * trk.BLOCK
    pk = np.concatenate([qk, np.full(m_pad - m, 2**31 - 2, np.int32)])
    pv = np.concatenate([qv, np.zeros(m_pad - m, np.int32)])
    want = np.asarray(jrk._pallas_rank_sorted(
        jnp.asarray(ak), jnp.asarray(av), jnp.asarray(pk), jnp.asarray(pv),
        n_build=n_pad, strict=strict,
    ))[:m]
    args = (_t(ak), _t(av), _t(qk), _t(qv))
    got = trk.rank_sorted_resident(*args, strict=strict)
    np.testing.assert_array_equal(got.numpy(), want)
    total = trk.rank_sorted_resident(*args, strict=strict, reduce=True)
    assert total.dtype == torch.int64 and int(total) == int(want.astype(np.int64).sum())


class TestWrapperContract:
    def test_rejects_bad_builds(self):
        q = torch.zeros(10, dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple of 2048"):
            trk.rank_sorted_resident(q, q, q, q, strict=True)
        big = torch.zeros(trk.MAX_RESIDENT_BUILD + trk.CHUNK, dtype=torch.int32)
        with pytest.raises(ValueError, match="at most"):
            trk.rank_sorted_resident(big, big, q, q, strict=True)
        with pytest.raises(TypeError):
            trk.rank_sorted_resident(q.long(), q, q, q, strict=True)

    def test_cpu_tensors_launch_no_kernel(self, rng):
        b = _t(rng.integers(0, 9, 3000).astype(np.int32))
        with metrics.recording() as rec:
            trk.rank_lex_resident((b, b), (b, b))
        assert rec.counts()["launch.pair_merge"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("strict", [True, False])
    def test_resident_kernel_equals_plain_at_the_cap(self, rng, cuda_device, strict):
        n_pad, m = trk.MAX_RESIDENT_BUILD, 300_007
        k = np.sort(rng.integers(0, 24, n_pad)).astype(np.int32)
        v = rng.integers(-(2**31), 2**31 - 1, n_pad, dtype=np.int64).astype(np.int32)
        order = np.lexsort((v, k))
        qk = rng.integers(0, 25, m).astype(np.int32)
        qv = rng.integers(-(2**31), 2**31 - 1, m, dtype=np.int64).astype(np.int32)
        qo = np.lexsort((qv, qk))
        args = [_t(x, cuda_device) for x in (k[order], v[order], qk[qo], qv[qo])]
        with metrics.recording() as rec:
            got = trk.rank_sorted_resident(*args, strict=strict)
            total = trk.rank_sorted_resident(*args, strict=strict, reduce=True)
        torch.cuda.synchronize()
        assert rec.counts()["launch.pair_merge"] == 2
        want = trk.rank_resident_plain(*args, strict=strict)
        assert torch.equal(got, want)
        assert int(total) == int(want.to(torch.int64).sum())
