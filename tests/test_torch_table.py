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
    tk, tv, tkh, tvh, tn = tt.sorted_interval_view(0, val_col, "cpu")
    assert tn == jn
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
    np.testing.assert_array_equal(
        tt.sorted_interval_order(0, val_col), jt.sorted_interval_order(0, val_col)
    )


def test_device_i32_and_statistics(tables):
    jt, tt = tables
    for col in (1, 2):
        got = tt.device_i32(col, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jt.device_i32(col)))
        mins_t, maxs_t = tt.per_key_minmax(0, col)
        mins_j, maxs_j = jt.per_key_minmax(0, col)
        np.testing.assert_array_equal(mins_t, mins_j)
        np.testing.assert_array_equal(maxs_t, maxs_j)
    assert tt.min_i32_diff(2, 1) == jt.min_i32_diff(2, 1)


def test_device_remaps_is_off_the_slice(tables):
    _, tt = tables
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
        device_remaps(tt, 0, tt, 0)
