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


# -- a bound column narrowed to int32 on the device (device_i32) -------------


def _bound_values(rng, dtype, n=5_000):
    """``n`` values of ``dtype`` in the i32 range, its ends among them."""
    if dtype == "float64":
        return rng.uniform(-1e9, 1e9, n)
    if dtype == "uint32":
        return rng.integers(0, I32_MAX, n, dtype=np.uint32)
    info = np.iinfo(dtype)
    lo, hi = max(info.min, I32_MIN), min(info.max, I32_MAX)
    vals = rng.integers(lo, hi, n, dtype=dtype, endpoint=True)
    vals[:2] = lo, hi
    return vals


def _bound_table(vals, shape):
    """A one-column arrow table of ``vals``: whole, a window at a non-zero
    offset whose parent holds values outside i32 (int64) beyond the window,
    or three chunks, one empty."""
    col = pa.array(vals)
    if shape == "sliced":
        pad = pa.array(np.full(7, 2**40 if vals.dtype == np.int64 else 0, vals.dtype))
        return pa.table({"x": pa.concat_arrays([pad, col, pad])}).slice(7, len(vals))
    if shape == "chunks":
        col = pa.chunked_array([col.slice(0, 3_500), col.slice(3_500, 0), col.slice(3_500)])
    return pa.table({"x": col})


@pytest.mark.parametrize("shape", ["whole", "sliced", "chunks"])
@pytest.mark.parametrize("dtype", ["int64", "int32", "int16", "uint32", "float64"])
def test_device_i32_is_the_host_narrowing(rng, dtype, shape):
    """device_i32 equals the JAX package's column_as_i32, and the port's
    own, for every type: the signed types narrowed on the device (one
    ``table.column_device`` span each, ``i32_device_narrowings`` where a
    cast narrows, no host narrowing), the others narrowed on the host and
    uploaded."""
    from sequila_tpu_torch.utils import metrics

    at, c = _bound_table(_bound_values(rng, dtype), shape), 0
    t = TorchTable(at)
    signed = dtype in ("int64", "int32", "int16")
    with metrics.recording() as rec:
        got = t.device_i32(c, "cpu")
        assert t.device_i32(c, "cpu") is got
    names = [s.name for s in rec.events().spans]
    assert rec.counts()["i32_device_narrowings"] == int(signed and dtype != "int32")
    assert names.count("table.column_device") == int(signed)
    assert ("table.column_i32" in names) == (not signed)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = JaxTable(at).column_as_i32(c)
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.column_as_i32(c), want)


@pytest.mark.parametrize("shape", ["whole", "sliced", "chunks"])
@pytest.mark.parametrize("bad", [2**31, -(2**31) - 1])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_device_i32_overflow_is_the_host_error(rng, dtype, bad, shape):
    """A bound outside i32 raises the JAX package's CastOverflowError, with
    its message, from the port's device and host narrowings alike, naming
    the first such value in row order (a larger one of the other sign
    follows it); int64 is narrowed on the device, float64 on the host."""
    from sequila_tpu.errors import CastOverflowError as JaxCastOverflowError
    from sequila_tpu_torch.errors import CastOverflowError

    vals = _bound_values(rng, dtype)
    vals[[3_000, 4_000]] = bad, -(2**40) * np.sign(bad)
    at, c = _bound_table(vals, shape), 0
    with pytest.raises(JaxCastOverflowError) as ref:
        JaxTable(at).column_as_i32(c)
    assert str(ref.value) == f"Can't cast value {bad} to type Int32"
    for narrow in (lambda t: t.device_i32(c, "cpu"), lambda t: t.column_as_i32(c)):
        with pytest.raises(CastOverflowError) as got:
            narrow(TorchTable(at))
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_device_i32_null_bound_raises_before_any_upload(monkeypatch, dtype):
    """A NULL bound raises the JAX package's ExecutionError message before
    the port uploads anything."""
    from sequila_tpu.errors import ExecutionError as JaxExecutionError
    from sequila_tpu_torch.errors import ExecutionError
    from sequila_tpu_torch.models import table as table_mod

    def upload(*_):
        raise AssertionError("uploaded a column with NULLs")

    monkeypatch.setattr(table_mod, "to_device", upload)
    at = pa.table({"x": pa.array([1, None, 3], getattr(pa, dtype)())})
    with pytest.raises(JaxExecutionError) as ref:
        JaxTable(at).column_as_i32(0)
    with pytest.raises(ExecutionError, match="contains NULLs") as got:
        TorchTable(at).device_i32(0, "cpu")
    assert str(got.value) == str(ref.value)


def test_i32_device_narrowings_count_int64_columns_once(rng):
    """One count per int64 column narrowed, none for an int32 column or a
    cached one; a host reader narrows on the host, in its own cache."""
    from sequila_tpu_torch.utils import metrics

    s = rng.integers(0, 1_000, 50)
    t = TorchTable(pa.table({"s": s, "e": s + 5, "s32": s.astype(np.int32)}))
    with metrics.recording() as rec:
        for col in ("s", "e", "s32", "s", "e"):
            t.device_i32(col, "cpu")
    assert rec.counts()["i32_device_narrowings"] == 2
    with metrics.recording() as host:
        np.testing.assert_array_equal(t.column_as_i32("s"), s)
    assert host.counts()["i32_device_narrowings"] == 0
    assert [sp.name for sp in host.events().spans] == ["table.column_i32"]


def test_device_i32_uploads_a_host_narrowed_column(rng):
    """A column a host reader has narrowed already is uploaded as its int32
    array: no second narrowing, on the device or the host."""
    from sequila_tpu_torch.utils import metrics

    s = rng.integers(-(2**31), 2**31, 1_000)
    t = TorchTable(pa.table({"s": s}))
    host = t.column_as_i32("s")
    with metrics.recording() as rec:
        got = t.device_i32("s", "cpu")
    assert rec.counts()["i32_device_narrowings"] == 0
    assert not {"table.column_device", "table.column_i32"} & {sp.name for sp in rec.events().spans}
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(host, JaxTable(pa.table({"s": s})).column_as_i32("s"))
