"""A string key column's dictionary coded on the card (ops/cuda/string_keys.py).

On the CPU, ``code_strings`` runs the kernels' plain versions: the whole
device coding, held to ``Table.dict_codes``' host path (Arrow's encoder)
bit for bit in the codes and equal in the values and their type.  Through
``Table``, asked for the device "cpu" (the card's build on CPU tensors), a
collision falls back to the host encoder, nulls and other key types keep
it, and the host codes of a device build come from its device codes.  The ``cuda`` tests hold the kernels to their plain versions and a
fresh table's count to the host path on the card.  No JAX here: the
``cuda`` tests run on the card.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.ops.cuda import string_keys as sk
from sequila_tpu_torch.session import SessionContext
from sequila_tpu_torch.utils import metrics

WORDS = ["chr1", "chr2", "chr10", "chrX", "", "a", "a\0", "b", "x" * 8, "x" * 9, "y" * 17,
         "chrUn_KI270742v1_decoy", "é", "e", "ée", "日本", "日", "😀", "z" * 300]


def _pick(rng, words, n):
    return [words[i] for i in rng.integers(0, len(words), n)]


def _cases(rng):
    return {
        "words": pa.array(_pick(rng, WORDS, 3_000)),
        "window": pa.array(_pick(rng, WORDS, 5_000)).slice(1_234, 2_000),
        "empty_strings": pa.array(["", "", ""]),
        "empty_and_one": pa.array(_pick(rng, ["", "q"], 500)).slice(3),
        "long": pa.array(_pick(rng, ["p" * 9, "p" * 16, "p" * 17, "p" * 8 + "q", "q" * 40], 800)),
        "utf8": pa.array(_pick(rng, ["é", "e", "z", "É", "ü", "日本", "日", "😀", "a😀"], 900)),
        "one_value": pa.array(["chr7"] * 777).slice(5, 700),
        "no_rows": pa.array([], pa.string()),
        "no_rows_window": pa.array(["a", "b"]).slice(1, 0),
    }


CASES = sorted(_cases(np.random.default_rng(0)))


def _host(arr: pa.Array):
    """The host path's (codes, values) of a one-column table."""
    codes, values, _ = Table(pa.table({"k": arr})).dict_codes(0)
    return codes, values


def _python_key(s: str) -> int:
    """A row's key by Python integers (string_keys' definition)."""
    b = s.encode()
    key = len(b) + sum((c + 1) * pow(sk._MUL, j + 1, 2**64) for j, c in enumerate(b))
    return sk._as_i64(key)


@pytest.mark.parametrize("large", [False, True], ids=["string", "large_string"])
@pytest.mark.parametrize("case", CASES)
def test_device_coding_equals_host_encoder(rng, case, large):
    arr = _cases(rng)[case]
    if large:
        arr = arr.cast(pa.large_string())
    want_codes, want_values = _host(arr)
    values, codes = sk.code_strings(arr, "cpu")
    assert codes.dtype == torch.int32 and codes.device.type == "cpu"
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    assert values.dtype == want_values.dtype == object
    assert list(values) == list(want_values)
    assert all(type(v) is str for v in values)


@pytest.mark.parametrize("large", [False, True], ids=["string", "large_string"])
def test_buffers_are_the_arrays_own(rng, large):
    """A window's offsets start at its offset and its bytes at its first
    offset, both views of the array's buffers, not copies."""
    whole = pa.array(_pick(rng, WORDS, 1_000), pa.large_string() if large else pa.string())
    arr = whole.slice(300, 400)
    offsets, data, base = sk.arrow_string_buffers(arr)
    assert offsets.dtype == (np.int64 if large else np.int32) and len(offsets) == 401
    assert base == offsets[0] > 0 and len(data) == offsets[-1] - base
    assert offsets.ctypes.data == whole.buffers()[1].address + 300 * offsets.itemsize
    assert data.ctypes.data == whole.buffers()[2].address + base
    assert bytes(data) == "".join(arr.to_pylist()).encode()


def test_keys_are_the_defined_sum(rng):
    arr = pa.array(_pick(rng, WORDS, 400)).slice(17)
    offsets, data, base = sk.arrow_string_buffers(arr)
    keys = sk.string_keys(torch.tensor(offsets), torch.tensor(data), base)
    assert keys.dtype == torch.int64
    assert keys.tolist() == [_python_key(s) for s in arr.to_pylist()]


def test_groups_are_sorted_keys_with_first_rows():
    keys = torch.tensor([5, -3, 5, 7, -3, 5], dtype=torch.int64)
    group, rep, k = sk.group_keys(keys)
    assert int(k) == 3 and group.dtype == torch.int32
    assert group.tolist() == [1, 0, 1, 2, 0, 1]
    assert rep[:3].tolist() == [1, 0, 3]


def test_verify_flags_a_collision(rng):
    """Rows grouped with a row of other bytes raise the flag, whether the
    lengths or only the bytes differ; an exact grouping does not."""
    arr = pa.array(["ab", "ab", "ba", "abc", "ab"])
    offsets, data, base = (torch.tensor(a) if i < 2 else a
                           for i, a in enumerate(sk.arrow_string_buffers(arr)))
    rep = torch.tensor([0, 2, 3, 5], dtype=torch.int64)

    def flag(groups):
        return int(sk.verify_groups(offsets, data, base, torch.tensor(groups, dtype=torch.int32),
                                    rep)[0])

    assert flag([0, 0, 1, 2, 0]) == 0
    assert flag([0, 0, 0, 2, 0]) == 1  # "ba" with "ab": same length
    assert flag([0, 0, 1, 0, 0]) == 1  # "abc" with "ab"


def test_wrappers_refuse_what_the_kernels_do_not_take():
    off, data = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([97], dtype=torch.uint8)
    with pytest.raises(TypeError):
        sk.string_keys(off.to(torch.int16), data, 0)
    with pytest.raises(TypeError):
        sk.string_keys(off, data.to(torch.int32), 0)
    with pytest.raises(ValueError):
        sk.string_keys(torch.empty(0, dtype=torch.int32), data, 0)
    with pytest.raises(ValueError):
        sk.verify_groups(off, data, 0, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64))


def _coded(t: Table, col=0):
    with metrics.recording() as rec:
        values = t.dict_values(col, "cpu")
    return values, rec


def test_table_codes_on_the_card_path(rng):
    """A card build records its span and counter, keeps no host codes, and
    gives the host path's codes on the device and, copied back once, on
    the host."""
    arr = _cases(rng)["window"]
    want_codes, want_values = _host(arr)
    t = Table(pa.table({"k": arr}))
    values, rec = _coded(t)
    assert list(values) == list(want_values)
    assert [s.name for s in rec.events().spans] == ["table.dict_device"]
    assert rec.counts()["dict_device_builds"] == 1 and rec.counts()["dict_host_fallbacks"] == 0
    assert t._codes[0][0] is None
    np.testing.assert_array_equal(t.device_codes(0, "cpu").numpy(), want_codes)
    with metrics.recording() as back:
        codes, values2, dev = t.dict_codes(0, "cpu")
        again, _, _ = t.dict_codes(0)
    assert [s.name for s in back.events().spans] == ["table.dict_host"]
    np.testing.assert_array_equal(codes, want_codes)
    assert again is codes and values2 is values
    np.testing.assert_array_equal(dev.numpy(), want_codes)


def test_device_codes_first_build_on_the_card_path(rng):
    """Device codes asked for before anything else: one card build, kept
    as it is, no host codes made."""
    arr = _cases(rng)["words"]
    want_codes, _ = _host(arr)
    t = Table(pa.table({"k": arr}))
    with metrics.recording() as rec:
        codes = t.device_codes(0, "cpu")
    assert [s.name for s in rec.events().spans] == ["table.dict_device"]
    assert t._codes[0][0] is None and t.device_codes(0, "cpu") is codes
    np.testing.assert_array_equal(codes.numpy(), want_codes)


def test_collision_falls_back_to_the_host_encoder(rng, monkeypatch):
    """Keys that put every row in one group: the check finds the
    collision, the column is coded on the host, counted once."""
    monkeypatch.setattr(sk, "string_keys", lambda off, data, base: torch.zeros(
        off.numel() - 1, dtype=torch.int64))
    arr = _cases(rng)["words"]
    want_codes, want_values = _host(arr)
    t = Table(pa.table({"k": arr}))
    values, rec = _coded(t)
    names = [s.name for s in rec.events().spans]
    assert names == ["table.dict_device", "table.dict_codes"]
    assert rec.counts()["dict_host_fallbacks"] == 1 and rec.counts()["dict_device_builds"] == 0
    assert list(values) == list(want_values)
    np.testing.assert_array_equal(t.dict_codes(0)[0], want_codes)
    np.testing.assert_array_equal(t.device_codes(0, "cpu").numpy(), want_codes)


@pytest.mark.parametrize("column", [
    pa.array(["a", None, "b", "a"]),
    pa.array([3, 1, 3, 2], pa.int64()),
    pa.array(["a", "b", "a"]).dictionary_encode(),
], ids=["nulls", "int64", "dictionary"])
def test_other_columns_keep_the_host_encoder(column):
    """Null-bearing and non-string keys are not coded on the card (the
    operators route null keys away before they ask for codes)."""
    t = Table(pa.table({"k": column}))
    with metrics.recording() as rec:
        assert t._dictionary_on_device(0, "cpu") is None
    assert rec.events().spans == [] and rec.counts() == {}
    if column.null_count:
        return
    want_codes, want_values = _host(column)
    values, rec = _coded(t)
    assert [s.name for s in rec.events().spans] == ["table.dict_codes"]
    assert rec.counts()["dict_device_builds"] == rec.counts()["dict_host_fallbacks"] == 0
    assert list(values) == list(want_values)
    np.testing.assert_array_equal(t.dict_codes(0)[0], want_codes)


def test_the_host_path_stays_off_the_card(rng):
    """No device: Arrow's encoder; a named device, the CPU too: the device
    coding, no host codes made."""
    arr = _cases(rng)["words"]
    for device, span, host_codes in ((None, "table.dict_codes", True),
                                     ("cpu", "table.dict_device", False)):
        t = Table(pa.table({"k": arr}))
        with metrics.recording() as rec:
            t.dict_values(0, device)
        assert [s.name for s in rec.events().spans] == [span]
        assert (t._codes[0][0] is not None) == host_codes


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("large", [False, True], ids=["string", "large_string"])
def test_kernels_equal_their_plain_versions_on_the_card(rng, large):
    dev = _card()
    for case, arr in _cases(rng).items():
        if large:
            arr = arr.cast(pa.large_string())
        if len(arr) == 0:
            continue
        offsets, data, base = sk.arrow_string_buffers(arr)
        h_off, h_data = torch.tensor(offsets), torch.tensor(data)
        d_off, d_data = h_off.to(dev), h_data.to(dev)
        with metrics.recording() as rec:
            keys = sk.string_keys(d_off, d_data, base)
            group, rep, k = sk.group_keys(keys)
            flag = sk.verify_groups(d_off, d_data, base, group, rep)
            torch.cuda.synchronize()
        assert rec.counts()["launch.string_keys"] == rec.counts()["launch.verify_groups"] == 1
        want = sk.string_keys_plain(h_off, h_data, base)
        assert torch.equal(keys.cpu(), want), case
        assert int(flag[0]) == 0, case
        if int(k) > 1:  # every row in one group: a collision
            one = torch.zeros(len(arr), dtype=torch.int32)
            got = sk.verify_groups(d_off, d_data, base, one.to(dev), rep)
            plain = sk.verify_groups_plain(h_off, h_data, base, one, rep.cpu())
            assert int(got[0]) == int(plain[0]) == 1, case
        values, codes = sk.code_strings(arr, dev)
        want_codes, want_values = _host(arr)
        assert list(values) == list(want_values) and codes.dtype == torch.int32
        np.testing.assert_array_equal(codes.cpu().numpy(), want_codes)


@pytest.mark.cuda
def test_fresh_table_codes_on_the_card(rng, monkeypatch):
    """A fresh s2 (a window of a pool) counted on the card: its key column
    coded there once, no host encoding and no host copy of its codes, the
    count the CPU session's, its device codes the host path's."""
    dev = _card()
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")

    def tab(n):
        s = rng.integers(0, 200_000, n)
        return pa.table({"contig": _pick(rng, ["chr1", "chr2", "chr10", "chrX", "chrM"], n),
                         "pos_start": s, "pos_end": s + rng.integers(0, 2_000, n)})

    query = ("SELECT count(*) FROM s1 a JOIN s2 b ON a.contig = b.contig "
             "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
    s1, pool = tab(30_000), tab(120_000)
    card, cpu = SessionContext(device="cuda"), SessionContext(device="cpu")
    for ctx in (card, cpu):
        ctx.register_table("s1", s1)
        ctx.register_table("s2", pool.slice(0, 1_000))
        ctx.sql(query)
    window = pool.slice(12_345, 60_000)
    for ctx in (card, cpu):
        ctx.register_table("s2", window)
    with metrics.recording() as rec:
        got = card.sql(query).to_pylist()
    assert got == cpu.sql(query).to_pylist()
    names = {s.name for s in rec.events().spans}
    assert "table.dict_codes" not in names and "table.dict_host" not in names
    assert "table.dict_device" in names
    assert rec.counts()["dict_device_builds"] == 1 and rec.counts()["dict_host_fallbacks"] == 0
    s2 = card.table("s2")
    (col,) = [k for k, v in s2._codes.items() if isinstance(v, list)]
    assert s2._codes[col][0] is None
    want_codes, want_values = _host(window.column("contig").chunk(0))
    assert list(s2.dict_values(col, dev)) == list(want_values)
    np.testing.assert_array_equal(s2.device_codes(col, dev).cpu().numpy(), want_codes)
