"""A string key column's dictionary codes, built on the card.

``code_strings`` takes a null-free Arrow ``string`` or ``large_string``
array, uploads its own buffers as they are (the offsets from the array's
offset on, and the UTF-8 bytes from its first offset to its last: zero-copy
NumPy views, no pass over the rows on the host) and codes it on their
device:

1. ``string_keys`` gives each row a 64-bit key of its bytes (hand-written
   CUDA, csrc/string_keys.cu);
2. ``group_keys`` groups the rows by key with one device sort, each group
   represented by its first row;
3. ``verify_groups`` holds every row's bytes to its representative's (the
   same source) and raises one flag on any difference: then the column has
   two strings with one key, and the caller codes it on the host;
4. the host reads the K representatives back in one copy, takes their
   strings from the Arrow array and sorts them as the host encoder sorts
   its dictionary (``models/table.py::Table.dict_codes``), and the card
   forms ``codes = rank[group]``.

The codes are the host encoder's, bit for bit: the rank of each row's
string among the column's distinct strings, in NumPy's order of Python
strings.  Each kernel wrapper launches its CUDA kernel for CUDA tensors (or
raises) and runs its plain PyTorch version only for CPU tensors, so
``code_strings`` on the CPU is the plain version of the whole coding; each
launch adds one to ``launch.string_keys`` / ``launch.verify_groups``
(utils/metrics.count).  The JAX package codes keys on the host, so no TPU
kernel is replaced here.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import torch

from sequila_tpu_torch.utils.metrics import count, to_device, to_host

# odd multiplier of the keys (csrc/string_keys.cu's kMul)
_MUL = 0x9E3779B97F4A7C15
_U64 = 2**64


def _as_i64(x: int) -> int:
    """The two's complement int64 of a value mod 2^64."""
    x %= _U64
    return x - _U64 if x >= 2**63 else x


def _powers(length: int, device) -> torch.Tensor:
    """int64 [length]: M^(j + 1) mod 2^64 for j < length, doubling."""
    pw = torch.empty(max(length, 1), dtype=torch.int64, device=device)
    pw[0] = _as_i64(_MUL)
    k, step = 1, _MUL  # step = M^k mod 2^64
    while k < length:
        m = min(k, length - k)
        pw[k:k + m] = pw[:m] * _as_i64(step)
        k, step = k + m, step * step % _U64
    return pw[:length]


def _check(offsets: torch.Tensor, data: torch.Tensor) -> torch.device:
    if offsets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"offsets: expected int32 or int64, got {offsets.dtype}")
    if data.dtype != torch.uint8:
        raise TypeError(f"data: expected uint8, got {data.dtype}")
    for t, name in ((offsets, "offsets"), (data, "data")):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D tensor")
    if offsets.numel() < 1:
        raise ValueError("offsets: expected n + 1 >= 1 entries")
    if offsets.device != data.device:
        raise ValueError(f"tensors on different devices: {offsets.device} and {data.device}")
    if offsets.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {offsets.device}")
    return offsets.device


def _rows_of_bytes(off: torch.Tensor):
    """(lens, row, pos): each row's length, and for each of the rows'
    bytes its row and its place in the row."""
    n = off.numel() - 1
    lens = off[1:] - off[:-1]
    total = int(off[-1]) if n else 0
    row = torch.repeat_interleave(torch.arange(n, device=off.device), lens)
    pos = torch.arange(total, device=off.device) - off[:-1][row]
    return lens, row, pos


def string_keys_plain(offsets, data, base: int) -> torch.Tensor:
    """Plain PyTorch string_keys: the same sum, one term a byte, added to
    its row in int64 (wrapping, as the kernel's uint64)."""
    off = offsets.to(torch.int64) - base
    lens, row, pos = _rows_of_bytes(off)
    keys = lens.clone()
    if pos.numel():
        terms = (data[: pos.numel()].to(torch.int64) + 1) * _powers(int(lens.max()), off.device)[pos]
        keys.index_add_(0, row, terms)
    return keys


def string_keys(offsets, data, base: int) -> torch.Tensor:
    """int64 [n]: row i's key, its length plus sum_j (byte_j + 1) *
    M^(j + 1) mod 2^64 over its bytes (the bits of a uint64).

    ``offsets`` = the n + 1 Arrow offsets (int32 or int64) of the rows,
    ``offsets[0] == base``; ``data`` = uint8, the bytes from ``base`` on.
    One launch of csrc/string_keys.cu::string_keys_kernel for CUDA tensors,
    counted in ``launch.string_keys``; the plain version for CPU tensors."""
    dev = _check(offsets, data)
    if dev.type == "cpu":
        return string_keys_plain(offsets, data, base)
    from sequila_tpu_torch.ops.cuda import _lib

    n = offsets.numel() - 1
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return keys
    with torch.cuda.device(dev):
        err = _lib.lib().seq_string_keys(
            offsets.data_ptr(), offsets.element_size(), data.data_ptr(), base, n,
            keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "string_keys")
    count("launch.string_keys")
    return keys


def group_keys(keys: torch.Tensor):
    """(group, rep, k) of int64 keys, on their device, with no wait: the
    int32 group of each row (groups numbered in key order), int64 [n + 1]
    whose first k entries are each group's first row, and k (0-d int64).
    One stable sort of the keys; a scatter of the group starts."""
    n = keys.numel()
    skeys, order = torch.sort(keys, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = skeys[1:] != skeys[:-1]
    del skeys
    gid = torch.cumsum(first, 0) - 1
    group = torch.empty(n, dtype=torch.int32, device=keys.device)
    group[order] = gid.to(torch.int32)
    rep = torch.empty(n + 1, dtype=torch.int64, device=keys.device)
    rep.scatter_(0, torch.where(first, gid, n), order)  # slot n: every other row
    return group, rep, gid[-1] + 1


def verify_groups_plain(offsets, data, base: int, group, rep) -> torch.Tensor:
    """Plain PyTorch verify_groups: lengths, then bytes, compared at once."""
    off = offsets.to(torch.int64) - base
    lens, row, pos = _rows_of_bytes(off)
    r = rep[group.to(torch.int64)]
    same_len = lens == lens[r]
    bad = ~same_len.all()
    if pos.numel():
        ok = same_len[row]
        other = torch.where(ok, off[:-1][r][row] + pos, 0)
        bad |= (ok & (data[: pos.numel()] != data[other])).any()
    return bad.to(torch.int32).reshape(1)


def verify_groups(offsets, data, base: int, group, rep) -> torch.Tensor:
    """int32 [1]: 1 when a row's bytes differ from those of its group's
    representative row ``rep[group[i]]``, else 0.

    ``offsets``, ``data``, ``base`` as for ``string_keys``; ``group`` =
    int32 [n], ``rep`` = int64 rows of the groups (``group_keys``).  One
    launch of csrc/string_keys.cu::verify_groups_kernel for CUDA tensors,
    counted in ``launch.verify_groups``; the plain version for CPU
    tensors."""
    dev = _check(offsets, data)
    n = offsets.numel() - 1
    if group.dtype != torch.int32 or group.numel() != n or not group.is_contiguous():
        raise ValueError(f"group: expected {n} contiguous int32, got {group.dtype} {tuple(group.shape)}")
    if rep.dtype != torch.int64 or not rep.is_contiguous():
        raise ValueError(f"rep: expected contiguous int64, got {rep.dtype}")
    if group.device != dev or rep.device != dev:
        raise ValueError(f"group and rep must be on {dev}")
    if dev.type == "cpu":
        return verify_groups_plain(offsets, data, base, group, rep)
    from sequila_tpu_torch.ops.cuda import _lib

    mismatch = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().seq_verify_groups(
            offsets.data_ptr(), offsets.element_size(), data.data_ptr(), base,
            group.data_ptr(), rep.data_ptr(), n, mismatch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "verify_groups")
    count("launch.verify_groups")
    return mismatch


def arrow_string_buffers(arr: pa.Array):
    """(offsets, data, base): zero-copy NumPy views of a ``string`` or
    ``large_string`` array's own buffers, its n + 1 offsets from
    ``arr.offset`` on and its bytes from the first of them (``base``, not 0
    in a slice) to the last."""
    n = len(arr)
    width = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    _, off_buf, data_buf = arr.buffers()
    offsets = np.frombuffer(off_buf, width, count=arr.offset + n + 1)[arr.offset:]
    base, end = int(offsets[0]), int(offsets[-1])
    if end > base:
        data = np.frombuffer(data_buf, np.uint8, count=end)[base:]
    else:
        data = np.zeros(0, np.uint8)
    return offsets, data, base


def code_strings(arr: pa.Array, device):
    """(values, codes) of a null-free ``string`` / ``large_string`` array,
    coded on ``device``, or None when two different strings share a key.

    ``values`` = the distinct strings, sorted (an object array of ``str``),
    ``codes`` = int32 [n] on ``device``, each row's rank in ``values``:
    both the host encoder's.  Waits for the card twice (the group count and
    the flag, then the representatives)."""
    dev = torch.device(device)
    if len(arr) == 0:
        return np.array([], dtype=object), torch.empty(0, dtype=torch.int32, device=dev)
    offsets, data, base = arrow_string_buffers(arr)
    d_off, d_data = to_device(offsets, dev), to_device(data, dev)
    group, rep, k = group_keys(string_keys(d_off, d_data, base))
    mismatch = verify_groups(d_off, d_data, base, group, rep)
    k, bad = to_host(torch.cat((k.reshape(1), mismatch.to(torch.int64)))).tolist()
    if bad:
        return None
    values = arr.take(pa.array(to_host(rep[:k]))).to_numpy(zero_copy_only=False)
    order = np.argsort(values, kind="stable")
    rank = np.empty(k, np.int32)
    rank[order] = np.arange(k, dtype=np.int32)
    return values[order], torch.index_select(to_device(rank, dev), 0, group)
