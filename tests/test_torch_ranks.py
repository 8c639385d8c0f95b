"""Port parity: sequila_tpu_torch/ops/ranks.py vs sequila_tpu/ops/ranks.py.

The same numpy inputs, made from a seed, go through the JAX rank functions
(the co-sort) and through the port's (int64 composites and
torch.searchsorted on the CPU).  Ranks are integers: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.ops import ranks as jr
from sequila_tpu_torch.ops import ranks as tr

PAD = 2**31 - 1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(rng, n, nkeys=5, lo=-(2**31), hi=2**31 - 1, pad_rows=0):
    """(keys, values) int32 with signed keys, dense ties, extreme values
    and ``pad_rows`` (PAD, PAD) rows."""
    k = rng.integers(-2, nkeys, n).astype(np.int32)
    v = rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)
    v[: n // 3] = rng.integers(-3, 3, n // 3)
    if n >= 4:
        v[:2] = (-(2**31), 2**31 - 1)
    if pad_rows:
        k[-pad_rows:] = PAD
        v[-pad_rows:] = PAD
    return k, v


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,m", [(1500, 900), (1, 40), (0, 30), (40, 0)])
def test_rank_lex_sort_pairs(rng, side, n, m):
    bk, bv = _pairs(rng, n, pad_rows=min(n, 3))
    qk, qv = _pairs(rng, m)
    qk[qk == PAD] = 0  # queries stay below the PAD key (the PAD convention)
    want = np.asarray(jr.rank_lex_sort(
        (jnp.asarray(bk), jnp.asarray(bv)), (jnp.asarray(qk), jnp.asarray(qv)), side=side
    ))
    got = tr.rank_lex_sort((_t(bk), _t(bv)), (_t(qk), _t(qv)), side=side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_lex_sort_single_column(rng, side):
    b = rng.integers(-50, 50, 700).astype(np.int32)
    q = rng.integers(-60, 60, 300).astype(np.int32)
    want = np.asarray(jr.rank_lex_sort((jnp.asarray(b),), (jnp.asarray(q),), side=side))
    np.testing.assert_array_equal(tr.rank_lex_sort((_t(b),), (_t(q),), side=side).numpy(), want)


def test_rank_lex_sort_refuses_triples():
    x = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="level_ranks"):
        tr.rank_lex_sort((x, x, x), (x, x, x))


@pytest.mark.parametrize("bits", [(5, 10, 15), (10, 20, 30)])
def test_pack_composite_and_bsearch(rng, bits):
    """JAX runs with x64 off, so its composites are int32: it is the
    oracle up to 31 bits, a numpy int64 packing beyond."""
    cols = [rng.integers(0, 2**b, 500).astype(np.int32) for b in bits]
    want = np.zeros(500, np.int64)
    for c, b in zip(cols, bits):
        want = (want << b) | c
    if sum(bits) <= 31:
        np.testing.assert_array_equal(
            np.asarray(jr.pack_composite(tuple(jnp.asarray(c) for c in cols), bits)), want
        )
    got = tr.pack_composite(tuple(_t(c) for c in cols), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if sum(bits) > 31:
        return
    b = np.sort(want).astype(np.int32)
    want = want.astype(np.int32)
    q = rng.choice(want, 200)
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            tr.rank_composite_bsearch(_t(b), _t(q), side=side).numpy(),
            np.asarray(jr.rank_composite_bsearch(jnp.asarray(b), jnp.asarray(q), side=side)),
        )
    with pytest.raises(ValueError):
        tr.pack_composite((_t(cols[0]),) * 3, (30, 30, 30))


def test_np_rank_lex_is_the_same_oracle(rng):
    bk, bv = rng.integers(0, 6, 400), rng.integers(-(2**19), 2**19, 400)
    qk, qv = rng.integers(0, 7, 100), rng.integers(-(2**19), 2**19, 100)
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            tr.np_rank_lex((bk, bv), (qk, qv), side), jr.np_rank_lex((bk, bv), (qk, qv), side)
        )


def test_composite_orders_like_the_tuple(rng):
    k, v = _pairs(rng, 3000, pad_rows=5)
    comp = tr.composite(_t(k), _t(v)).numpy()
    order = np.lexsort((v, k))
    assert (np.diff(comp[order]) >= 0).all()
