"""Packed-u32 merge count: BITS count(*) over pre-sorted cached views.

Port of sequila_tpu/ops/pallas/merge_count.py's count(*) route.  Both join
sides are registered tables whose (key, value)-sorted views are cached
(models/table.py::sorted_interval_view), so a query only has to rank one
sorted sequence inside another:

- every (key, value) tuple packs into ONE u32 whose unsigned order equals
  the lexicographic order (per joint key the observed value range of both
  sides, shifted by the planner's ±lit deltas, is compacted into
  ``[base_j, base_j + span_j)``); the numpy planning (``_joint_domain``,
  ``_c_tab``, ``plan_packing``) is the JAX package's, unchanged;
- ``pack_view`` applies that packing to one cached view and
  ``merge_rank_sorted`` ranks the sorted build tuples inside the sorted
  probe arrays — both hand-written CUDA kernels (csrc/merge_rank.cu).

Count identity (BITS, Layer & Quinlan 2012):

    total = sum_b [ #{q: qs <= end_b} - #{q: qe < start_b} ]

Build PAD rows (sentinel 0xFFFFFFFF) rank the whole padded probe array in
both passes and cancel; probe PAD slots (0xFFFFFFFE, above every real
pack) are counted by neither pass.  Exact for non-degenerate probes and
non-inverted builds — the operator routes those away first.

Packed views are carried in int32 tensors holding the u32 bit patterns:
PyTorch implements few operators for ``torch.uint32``, and the kernels read
the buffers as unsigned.  Each wrapper launches its CUDA kernel for a CUDA
tensor (or raises) and runs its plain PyTorch version only for a tensor on
the CPU; ``<wrapper>.launches`` counts kernel launches.  JAX's int32-only
limb sums and the ``_M_LIMIT`` guard are gone: ranks sum in 64 bits.
"""

from __future__ import annotations

import numpy as np
import torch

PADV = np.int32(2**31 - 1)
BUILD_PAD = 0xFFFFFFFF
PROBE_PAD = 0xFFFFFFFE
# headroom: both sentinels must sort above every real packed value
_SPAN_LIMIT = 2**32 - 2
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host planning (numpy, shared semantics with the JAX package)
# ---------------------------------------------------------------------------


def _joint_domain(remap_b, remap_q, nkeys, mn_b, mx_b, d_b, mn_q, mx_q, d_q):
    """Per-joint-key (lo, base) of one packed u32 domain spanning both
    sides' (shifted) value ranges, or None when the summed spans exceed
    the 32-bit budget."""
    lo = np.full(nkeys, np.iinfo(np.int64).max, np.int64)
    hi = np.full(nkeys, np.iinfo(np.int64).min, np.int64)
    np.minimum.at(lo, remap_b, mn_b + d_b)
    np.maximum.at(hi, remap_b, mx_b + d_b)
    np.minimum.at(lo, remap_q, mn_q + d_q)
    np.maximum.at(hi, remap_q, mx_q + d_q)
    span = np.maximum(hi - lo + 1, 0)  # keys absent from both -> 0
    total = int(span.sum())
    if total > _SPAN_LIMIT:
        return None
    base = np.zeros(nkeys, np.int64)
    np.cumsum(span[:-1], out=base[1:])
    return lo, base


def _c_tab(remap, lo, base, d):
    """Per-row u32 add table folding segment base, per-key minimum and the
    planner delta into one gather (mod-2^32 exact; see pack_view)."""
    j = remap.astype(np.int64)
    return ((base[j] - lo[j] + d) & 0xFFFFFFFF).astype(np.uint32)


def plan_packing(remap_b, remap_q, views, deltas):
    """Per-key u32 segment bases for both passes, or None if infeasible.

    ``views`` = ((bmin_s, bmax_s), (bmin_e, bmax_e), (qmin_s, qmax_s),
    (qmin_e, qmax_e)) int64 per-LOCAL-code extrema (Table.per_key_minmax);
    ``deltas`` = (d_bs, d_be, d_qs, d_qe).  Returns per-side local-code
    C tables (np.uint32) for the four packed views, or None when a pass's
    summed spans exceed the 32-bit budget.
    """
    (bs_mn, bs_mx), (be_mn, be_mx), (qs_mn, qs_mx), (qe_mn, qe_mx) = views
    d_bs, d_be, d_qs, d_qe = deltas
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1

    # pass 1 packs (end_b + d_be) against (qs + d_qs)
    p1 = _joint_domain(remap_b, remap_q, nkeys, be_mn, be_mx, d_be, qs_mn, qs_mx, d_qs)
    # pass 2 packs (start_b + d_bs) against (qe + d_qe)
    p2 = _joint_domain(remap_b, remap_q, nkeys, bs_mn, bs_mx, d_bs, qe_mn, qe_mx, d_qe)
    if p1 is None or p2 is None:
        return None
    lo1, base1 = p1
    lo2, base2 = p2

    return (
        _c_tab(remap_b, lo1, base1, d_be),  # build (k, end)
        _c_tab(remap_q, lo1, base1, d_qs),  # probe (k, qs)
        _c_tab(remap_b, lo2, base2, d_bs),  # build (k, start)
        _c_tab(remap_q, lo2, base2, d_qe),  # probe (k, qe)
    )


def c_tab_tensor(c_tab: np.ndarray, device) -> torch.Tensor:
    """A np.uint32 C table as an int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(c_tab).view(np.int32)).to(device)


def as_u32(packed: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) of an int32 tensor holding u32 bits."""
    return packed.to(torch.int64) & _U32


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain PyTorch versions
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype=torch.int32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pack_view_plain(k, v, c_tab, pad_sentinel: int) -> torch.Tensor:
    """Plain PyTorch pack_view: int64 arithmetic, u32 bits out as int32."""
    c64 = c_tab.to(torch.int64) & _U32
    safe = k.clamp(0, c_tab.numel() - 1).to(torch.int64)
    packed = (c64[safe] + v.to(torch.int64)) & _U32
    packed = torch.where(k == int(PADV), torch.full_like(packed, pad_sentinel), packed)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def pack_view(k, v, c_tab, pad_sentinel: int) -> torch.Tensor:
    """Monotone (key code, value) -> u32 packing of one cached sorted view.

    ``c_tab[k] = (base_k - lo_k + delta) mod 2^32`` (int32 bits) folds the
    segment base, the per-key minimum and the planner's ±lit delta into one
    gather; the mod-2^32 add is exact because every true packed value fits
    32 bits (plan_packing verified the span).  PAD rows map to
    ``pad_sentinel``.  Returns int32 holding the u32 bits.
    Replaces the XLA glue sequila_tpu/ops/pallas/merge_count.py:158
    ::_pack_view."""
    for t, name in ((k, "k"), (v, "v"), (c_tab, "c_tab")):
        _check(t, name)
    if k.numel() != v.numel():
        raise ValueError(f"k and v differ in length: {k.numel()} != {v.numel()}")
    if c_tab.numel() == 0 or c_tab.numel() >= 2**31:
        raise ValueError(f"c_tab must hold 1 .. 2^31-1 entries, got {c_tab.numel()}")
    if not 0 <= pad_sentinel <= _U32:
        raise ValueError(f"pad_sentinel {pad_sentinel} is not a u32")
    dev = _same_device(k, v, c_tab)
    if dev.type == "cpu":
        return pack_view_plain(k, v, c_tab, pad_sentinel)
    from sequila_tpu_torch.ops.cuda import _lib

    out = torch.empty_like(k)
    n = k.numel()
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib.lib().seq_pack_view(
            k.data_ptr(), v.data_ptr(), c_tab.data_ptr(), c_tab.numel(),
            pad_sentinel, out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "pack_view")
    pack_view.launches += 1
    return out


pack_view.launches = 0


def merge_rank_plain(a, q, *, strict: bool, reduce: bool = False) -> torch.Tensor:
    """Plain PyTorch merge_rank_sorted: searchsorted over int64-widened u32."""
    ranks = torch.searchsorted(as_u32(a), as_u32(q), right=not strict)
    if reduce:
        return ranks.sum(dtype=torch.int64)
    return ranks.to(torch.int32)


def merge_rank_sorted(a, q, *, strict: bool, reduce: bool = False) -> torch.Tensor:
    """Rank each sorted u32 query ``q`` in the sorted u32 table ``a``.

    strict=True  -> #{a <  q};  strict=False -> #{a <= q} (unsigned order).
    Returns the int32 ranks, or with ``reduce=True`` their int64 sum as a
    0-d tensor (the kernel then writes no ranks).  ``a`` and ``q`` are
    int32 tensors holding u32 bits, each sorted as u32.
    Replaces the TPU kernel sequila_tpu/ops/pallas/merge_count.py:110
    ::_merge_rank_sorted (B1)."""
    _check(a, "a")
    _check(q, "q")
    if a.numel() >= 2**31:
        raise ValueError(f"table of {a.numel()} rows: ranks must fit int32")
    dev = _same_device(a, q)
    if dev.type == "cpu":
        return merge_rank_plain(a, q, strict=strict, reduce=reduce)
    from sequila_tpu_torch.ops.cuda import _lib

    m = q.numel()
    total = torch.zeros((), dtype=torch.int64, device=dev) if reduce else None
    ranks = None if reduce else torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return total if reduce else ranks
    with torch.cuda.device(dev):
        err = _lib.lib().seq_merge_rank(
            a.data_ptr(), a.numel(), q.data_ptr(), m, int(strict),
            None if reduce else ranks.data_ptr(),
            total.data_ptr() if reduce else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "merge_rank_sorted")
    merge_rank_sorted.launches += 1
    return total if reduce else ranks


merge_rank_sorted.launches = 0


def merge_count_passes(
    bqs_k, bqs_v, c_bqs,  # build sorted by (k, end):   queries of pass 1
    pqs_k, pqs_v, c_pqs,  # probe sorted by (k, qs):    table of pass 1
    bqe_k, bqe_v, c_bqe,  # build sorted by (k, start): queries of pass 2
    pqe_k, pqe_v, c_pqe,  # probe sorted by (k, qe):    table of pass 2
) -> torch.Tensor:
    """Both BITS rank passes; returns the count as an int64 0-d tensor.

    Pass 1 sums over build rows #{qs <= end_b}, pass 2 #{qe < start_b}.
    Build PAD rows rank the padded probe length in both passes and cancel;
    probe PAD slots (sentinel below the build sentinel, above every real
    pack) are counted by neither pass."""
    q1 = pack_view(bqs_k, bqs_v, c_bqs, BUILD_PAD)
    a1 = pack_view(pqs_k, pqs_v, c_pqs, PROBE_PAD)
    q2 = pack_view(bqe_k, bqe_v, c_bqe, BUILD_PAD)
    a2 = pack_view(pqe_k, pqe_v, c_pqe, PROBE_PAD)
    r1 = merge_rank_sorted(a1, q1, strict=False, reduce=True)
    r2 = merge_rank_sorted(a2, q2, strict=True, reduce=True)
    return r1 - r2
