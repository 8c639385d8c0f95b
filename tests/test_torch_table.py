"""Port parity: sequila_tpu_torch.models.table.Table vs the JAX Table.

Both Tables wrap the same arrow table; the port's device views are torch
tensors on the named device, the JAX package's are JAX arrays.  Codes,
sorted views, permutations and statistics are integers: exact equality.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.models.table import device_remaps


def _arrow(rng, n, nkeys=6, numeric_keys=False):
    keys = rng.integers(0, nkeys, n)
    s = rng.integers(-(2**31), 2**31 - 5000, n).astype(np.int64)
    s[: n // 4] = rng.integers(0, 50, n // 4)  # dense ties
    return pa.table({
        "contig": keys.astype(np.int64) * 7 if numeric_keys
        else [f"chr{int(k)}" for k in keys],
        "s": s,
        "e": s + rng.integers(0, 4000, n),
    })


@pytest.fixture(params=[(1, False), (3000, False), (4500, True)], ids=["one", "str", "int"])
def tables(request, rng):
    n, numeric = request.param
    t = _arrow(rng, n, numeric_keys=numeric)
    return JaxTable(t), TorchTable(t)


def test_dict_codes(tables):
    jt, tt = tables
    jcodes, jvals, jdev = jt.dict_codes(0)
    tcodes, tvals, tdev = tt.dict_codes(0)
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(tvals, jvals)
    assert tdev is None  # no device named, no device copy
    _, _, on_cpu = tt.dict_codes(0, "cpu")
    assert on_cpu.dtype == torch.int32 and on_cpu.device.type == "cpu"
    np.testing.assert_array_equal(on_cpu.numpy(), np.asarray(jdev))


@pytest.mark.parametrize("val_col", [1, 2])
def test_sorted_interval_view(tables, val_col):
    jt, tt = tables
    jk, jv, jkh, jvh, jn = jt.sorted_interval_view(0, val_col)
    tk, tv, tn = tt.sorted_interval_view(0, val_col, "cpu")
    tkh, tvh, hn = tt.sorted_interval_host(0, val_col, "cpu")
    assert tn == hn == jn
    assert len(tkh) % 2048 == 0 and (tkh[tn:] == 2**31 - 1).all()
    np.testing.assert_array_equal(tkh, jkh)
    np.testing.assert_array_equal(tvh, jvh)
    assert tk.dtype == tv.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # cached per device: the same tensors come back
    assert tt.sorted_interval_view(0, val_col, "cpu")[0] is tk


@pytest.mark.parametrize("val_col", [1, 2])
def test_sorted_interval_order(tables, val_col):
    jt, tt = tables
    order = tt.sorted_interval_order(0, val_col, "cpu")
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), jt.sorted_interval_order(0, val_col))


def test_device_i32_and_statistics(tables):
    jt, tt = tables
    for col in (1, 2):
        got = tt.device_i32(col, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jt.device_i32(col)))
        mins_t, maxs_t = tt.per_key_minmax(0, col, "cpu")
        mins_j, maxs_j = jt.per_key_minmax(0, col)
        np.testing.assert_array_equal(mins_t, mins_j)
        np.testing.assert_array_equal(maxs_t, maxs_j)
    assert tt.min_i32_diff(2, 1, "cpu") == jt.min_i32_diff(2, 1)


def test_device_remaps_is_off_the_slice(tables, rng):
    """device_remaps (once off the slice, now on it): the JAX package's
    remaps, as int32 tensors cached per device and per right table."""
    from sequila_tpu.models.table import device_remaps as jax_device_remaps

    jt, tt = tables
    other = _arrow(rng, 500, nkeys=9, numeric_keys=tt.column(0).type == pa.int64())
    jo, to = JaxTable(other), TorchTable(other)
    got = device_remaps(tt, 0, to, 0, "cpu")
    for g, w in zip(got, jax_device_remaps(jt, 0, jo, 0)):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    again = device_remaps(tt, 0, to, 0, "cpu")
    assert again[0] is got[0] and again[1] is got[1]
    # another right table never shares the cache entry
    assert device_remaps(tt, 0, tt, 0, "cpu")[1] is not got[1]


# -- the sorted views built by a device sort (build_sorted_view) -------------

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _view_arrow(rng, n, contigs, ties):
    """(contig, s, e) rows: random or tied values, the ends of the int32
    range among them, ends clipped below I32_MAX (the PAD sentinel)."""
    s = rng.integers(-3, 3, n) if ties else rng.integers(I32_MIN, I32_MAX - 1, n)
    s[: min(n, 3)] = [I32_MIN, I32_MAX - 1, -1][: min(n, 3)]
    e = np.minimum(s + rng.integers(0, 3 if ties else 1000, n), I32_MAX - 1)
    keys = rng.integers(0, contigs, n)
    return pa.table({"contig": [f"chr{k}" for k in keys], "s": s, "e": e})


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
@pytest.mark.parametrize("contigs", [1, 300])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049])
def test_device_view_build_is_the_host_build(rng, n, contigs, ties):
    """build_sorted_view on CPU tensors and the extrema read from it against
    the JAX package, bit for bit: keys, values, n, the order and the
    per-key extrema."""
    from sequila_tpu_torch.models.table import build_sorted_view, view_key_extrema

    t = _view_arrow(rng, n, contigs, ties)
    jt, tt = JaxTable(t), TorchTable(t)
    codes = torch.tensor(tt.dict_codes(0)[0])
    k = len(tt.dict_codes(0)[1])
    keys = None
    for col in (1, 2):
        vals = torch.tensor(tt.column_as_i32(col))
        K, V, vn, order = build_sorted_view(codes, vals, keys)
        keys = K
        _, _, jkh, jvh, jn = jt.sorted_interval_view(0, col)
        assert vn == jn == n
        assert K.dtype == V.dtype == order.dtype == torch.int32
        for got, want in ((K, jkh), (V, jvh), (order, jt.sorted_interval_order(0, col))):
            np.testing.assert_array_equal(got.numpy(), want)
        mins, maxs = view_key_extrema(K, V, vn, k).numpy()
        for got, want in zip((mins, maxs), jt.per_key_minmax(0, col)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049])
def test_table_views_on_card_path(rng, n):
    """A Table's views on a device (here the CPU, whose build is the
    card's): the views, extrema, min gap, lazy host twins and order equal
    the JAX package's; one keys tensor for both views; the inverse order is
    a scatter of the device order and inverts it."""
    from sequila_tpu_torch.utils import metrics

    t = _view_arrow(rng, n, 300, ties=True)
    jt, tt = JaxTable(t), TorchTable(t)
    with metrics.recording() as rec:
        assert tt.min_i32_diff(2, 1, "cpu") == jt.min_i32_diff(2, 1)
        for col in (1, 2):
            for got, want in zip(tt.per_key_minmax(0, col, "cpu"), jt.per_key_minmax(0, col)):
                np.testing.assert_array_equal(got, want)
                assert not got.flags.writeable
        # the host twins wait for a reader
        assert not [k for k in tt._i32 if isinstance(k, tuple) and k[0] == "sivh"]
        views = [tt.sorted_interval_view(0, col, "cpu") for col in (1, 2)]
    assert rec.counts()["view_device_builds"] == 2
    assert views[0][0] is views[1][0]  # G2: one keys tensor a key column
    for col, (K, V, vn) in zip((1, 2), views):
        jk, jv, jkh, jvh, jn = jt.sorted_interval_view(0, col)
        assert vn == jn
        np.testing.assert_array_equal(K.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(V.numpy(), np.asarray(jv))
        kh, vh, hn = tt.sorted_interval_host(0, col, "cpu")
        assert hn == jn and not kh.flags.writeable and not vh.flags.writeable
        np.testing.assert_array_equal(kh, jkh)
        np.testing.assert_array_equal(vh, jvh)
        order = tt.sorted_interval_order(0, col, "cpu").numpy()
        np.testing.assert_array_equal(order, jt.sorted_interval_order(0, col))
        inv = tt.sorted_interval_inverse(0, col, "cpu")
        assert inv.dtype == torch.int32 and inv.shape == (n,)
        np.testing.assert_array_equal(inv.numpy()[order], np.arange(n))
        assert tt.sorted_interval_inverse(0, col, "cpu") is inv
    with metrics.recording() as again:
        for col in (1, 2):
            tt.sorted_interval_view(0, col, "cpu")
            tt.per_key_minmax(0, col, "cpu")
    assert again.counts()["view_device_builds"] == 0
