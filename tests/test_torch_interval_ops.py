"""Port parity: the interval index and the count ops of sequila_tpu_torch vs
sequila_tpu (ops/interval_index.py, the count half of ops/interval_join.py).

One numpy seed makes the build and probe columns; both packages build their
IntervalIndex from them and count the same probes.  Every field and count
is an integer: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.ops import interval_index as jidx
from sequila_tpu.ops import interval_join as jij
from sequila_tpu_torch.ops import interval_index as tidx
from sequila_tpu_torch.ops import interval_join as tij

PAD = 2**31 - 1


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _build(rng, n, nkeys=4, inverted=0.0, span=20_000):
    """Nested genomic-like intervals (containment depth > 1), negative
    coordinates, optional inverted rows (end < start)."""
    k = rng.integers(0, nkeys, n).astype(np.int32)
    s = rng.integers(-span, span, n).astype(np.int32)
    e = (s + rng.integers(0, 3000, n)).astype(np.int32)
    e[: n // 10] = s[: n // 10] + 9000  # long covering intervals -> levels
    flip = rng.random(n) < inverted
    e[flip] = s[flip] - rng.integers(1, 50, int(flip.sum()))
    return k, s, e


def _probes(rng, m, nkeys=5, degenerate=0.0, span=20_000, pad=0):
    """Probe keys (some missing from the build), bounds, optional
    degenerate rows (qs > qe) and ``pad`` rows padded as the JAX operator
    pads a chunk (PAD_KEY, PAD_VAL, PAD_VAL - 2)."""
    k = rng.integers(0, nkeys, m).astype(np.int32)
    s = rng.integers(-span, span, m).astype(np.int32)
    e = (s + rng.integers(0, 2000, m)).astype(np.int32)
    deg = rng.random(m) < degenerate
    e[deg] = s[deg] - rng.integers(1, 3, int(deg.sum()))
    if pad:
        k[-pad:], s[-pad:], e[-pad:] = PAD, PAD, PAD - 2
    return k, s, e


def _indexes(k, s, e):
    return jidx.build_interval_index(k, s, e), tidx.build_interval_index(k, s, e, device="cpu")


BUILDS = {
    "nested": lambda rng: _build(rng, 3000),
    "one": lambda rng: _build(rng, 1),
    "empty": lambda rng: _build(rng, 0),
    "inverted": lambda rng: _build(rng, 800, inverted=0.2),
    "single_key_deep": lambda rng: _build(rng, 1500, nkeys=1, span=2000),
}


@pytest.mark.parametrize("shape", sorted(BUILDS))
def test_index_fields_match_jax(rng, shape):
    j, t = _indexes(*BUILDS[shape](rng))
    for name in ("level_sizes", "level_pad", "level_offsets", "n_rows", "num_levels",
                 "padded_size"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("levels", "keys", "starts", "ends", "pos",
                 "bs_keys", "bs_starts", "be_keys", "be_ends"):
        got = getattr(t, name)
        assert got.dtype == torch.int32 and got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, name)), err_msg=name)


def test_assign_levels_and_bucket_are_the_jax_ones(rng):
    k, s, e = _build(rng, 2000)
    for got, want in zip(tidx.assign_levels(k, s, e), jidx.assign_levels(k, s, e)):
        np.testing.assert_array_equal(got, want)
    for n in (0, 1, 8, 9, 1000, 65536, 65537, 10**6):
        assert tidx._bucket(n) == jidx._bucket(n)
        assert tidx._bucket(n, minimum=1024) == jidx._bucket(n, minimum=1024)


@pytest.mark.parametrize("fn", ["IntervalIndex", "build_interval_index", "jaccard"])
def test_device_is_required(rng, fn):
    """The port's public functions run where the caller says: none of these
    has a device default (the JAX package's land on the accelerator)."""
    from sequila_tpu_torch.ops import genomic

    k, s, e = _build(rng, 50)
    call = {
        "IntervalIndex": lambda: tidx.IntervalIndex(k, s, e),
        "build_interval_index": lambda: tidx.build_interval_index(k, s, e),
        "jaccard": lambda: genomic.jaccard(k, s, e, k, s, e),
    }[fn]
    with pytest.raises(TypeError, match="device"):
        call()


def _level_args(idx):
    return dict(num_levels=idx.num_levels, level_offsets=idx.level_offsets)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("col", ["starts", "ends"])
def test_level_ranks_and_bsearch_match_jax(rng, side, col):
    j, t = _indexes(*_build(rng, 2500))
    qk, qs, _ = _probes(rng, 700, pad=5)
    want = np.asarray(jij.level_ranks(
        j.levels, j.keys, getattr(j, col), jnp.asarray(qk), jnp.asarray(qs),
        side=side, **_level_args(j),
    ))
    got = tij.level_ranks(t.levels, t.keys, getattr(t, col), _t(qk), _t(qs),
                          side=side, **_level_args(t))
    assert got.dtype == torch.int32 and got.shape == (t.num_levels, 700)
    np.testing.assert_array_equal(got.numpy(), want)
    # the binary-search strategy gives the same level-local ranks
    want_b = np.asarray(jij.level_ranks_bsearch(
        j.levels, j.keys, getattr(j, col), jnp.asarray(qk), jnp.asarray(qs),
        side=side, level_pad=j.level_pad, **_level_args(j),
    ))
    got_b = tij.level_ranks_bsearch(t.levels, t.keys, getattr(t, col), _t(qk), _t(qs),
                                    side=side, level_pad=t.level_pad, **_level_args(t))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_b.numpy(), got.numpy())


@pytest.mark.parametrize("method", ["sort", "bsearch", "window"])
@pytest.mark.parametrize("shape", ["nested", "inverted", "single_key_deep"])
def test_overlap_bounds_and_count_matches_match_jax(rng, method, shape):
    j, t = _indexes(*BUILDS[shape](rng))
    qk, qs, qe = _probes(rng, 900, degenerate=0.1, pad=7)
    jq = [jnp.asarray(a) for a in (qk, qs, qe)]
    tq = [_t(a) for a in (qk, qs, qe)]
    for got, want in zip(tij.overlap_bounds(t, *tq, method), jij.overlap_bounds(j, *jq, method)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tij.count_matches(t, *tq, method)
    want = np.asarray(jij.count_matches(j, *jq, method))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tij.total_count_i64(got) == jij.total_count_i64(
        jij.count_matches(j, *jq, method), j.n_rows
    )


def test_count_matches_bits_matches_jax(rng):
    """BITS over the unsorted BITS view, clean probes and degenerate rows
    (which BITS zeroes) alike."""
    j, t = _indexes(*_build(rng, 3000))
    for degenerate in (0.0, 0.2):
        qk, qs, qe = _probes(rng, 1024, degenerate=degenerate, pad=9)
        got = tij.count_matches(t, _t(qk), _t(qs), _t(qe), "bits")
        want = jij.count_matches(j, jnp.asarray(qk), jnp.asarray(qs), jnp.asarray(qe), "bits")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if degenerate == 0.0:  # BITS == the level count on clean probes
            np.testing.assert_array_equal(
                got.numpy(), tij.count_matches(t, _t(qk), _t(qs), _t(qe), "sort").numpy()
            )


@pytest.mark.parametrize("degenerate", [0.0, 0.05])
def test_counts_bits_fused_matches_jax(rng, degenerate):
    """Total and degenerate-row count of the one-pass BITS count: the JAX
    program over its padded buckets, the port over the unpadded columns."""
    n, m = 2000, 1500
    lk, ls, le = _build(rng, n, nkeys=4)
    rk, rs, re = _probes(rng, m, nkeys=6, degenerate=degenerate)
    remap_l = np.array([0, 2, 3, 5], np.int32)
    remap_r = np.arange(6, dtype=np.int32)
    packed = np.asarray(jij.counts_bits_fused(
        *(jnp.asarray(a) for a in (lk, ls, le, rk, rs, re, remap_l, remap_r)),
        n_pad=jidx._bucket(n, minimum=1024), m_pad=jidx._bucket(m, minimum=1024),
    )).astype(np.int64)
    got = tij.counts_bits_fused(*(_t(a) for a in (lk, ls, le, rk, rs, re, remap_l, remap_r)))
    assert got.dtype == torch.int64
    total, n_deg = got.tolist()
    assert (total, n_deg) == (int(packed[:-1].sum()), int(packed[-1]))
    assert (n_deg > 0) == (degenerate > 0)
    if n_deg == 0:  # exact: the level index counts the same pairs
        idx = tidx.build_interval_index(remap_l[lk], ls, le, device="cpu")
        want = tij.count_matches(idx, _t(remap_r[rk]), _t(rs), _t(re), "sort")
        assert total == int(want.sum())
