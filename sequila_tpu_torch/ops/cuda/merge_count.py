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
  ``merge_rank_segments`` ranks sorted queries inside sorted tables, any
  number of independent segments in one merge-path launch — both
  hand-written CUDA kernels (csrc/merge_rank.cu).  A count(*) is one
  launch for both passes (``merge_count_passes``), and so are per-probe
  counts (``merge_probe_count_passes``: the probe views ranked in the
  build views, ranks stored in view order, then one ``unpermute_counts``
  launch that takes their difference to probe row order) and the genomic
  verbs' four coverage ranks (``plan_verb_ranks`` / ``merge_verb_rank4``:
  ranks stored in view order, then one ``unpermute_ranks`` launch,
  finished by ``coverage_from_ranks``).

Count identity (BITS, Layer & Quinlan 2012):

    total = sum_b [ #{q: qs <= end_b} - #{q: qe < start_b} ]

Build PAD rows (sentinel 0xFFFFFFFF) rank the whole padded probe array in
both passes and cancel; probe PAD slots (0xFFFFFFFE, above every real
pack) are counted by neither pass.  Exact for non-degenerate probes and
non-inverted builds — the operator routes those away first.

The same two kernels give the materializing join its emission bounds
(``plan_level_bounds`` / ``merge_level_bounds``): per level of the
interval index, the level slice (packed on load) is the table and the
packed probe views are the queries, two segments a level, every level in
one launch, exact for every shape.

Packed views are carried in int32 tensors holding the u32 bit patterns:
PyTorch implements few operators for ``torch.uint32``, and the kernels read
the buffers as unsigned.  Each wrapper launches its CUDA kernel for a CUDA
tensor (or raises) and runs its plain PyTorch version only for a tensor on
the CPU; each launch adds one to the counter ``launch.<kernel>``
(utils/metrics.count: ``launch.pack_view``, ``launch.merge_path``,
``launch.unpermute_counts``, ``launch.unpermute_ranks``).  JAX's int32-only
limb sums and the ``_M_LIMIT`` guard are gone: ranks sum in 64 bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sequila_tpu_torch.utils.metrics import count, to_device, to_host

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
    return to_device(np.ascontiguousarray(c_tab).view(np.int32), device)


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
    count("launch.pack_view")
    return out


def merge_rank_plain(a, q, *, strict: bool, reduce: bool = False) -> torch.Tensor:
    """Plain PyTorch merge_rank_sorted: searchsorted over int64-widened u32."""
    ranks = torch.searchsorted(as_u32(a), as_u32(q), right=not strict)
    if reduce:
        return ranks.sum(dtype=torch.int64)
    return ranks.to(torch.int32)


# ---------------------------------------------------------------------------
# The segmented merge-path launch (csrc/merge_rank.cu::merge_path_kernel)
# ---------------------------------------------------------------------------

# the kernel's tiling: THREADS x ITEMS merge diagonals a tile, TILES
# tiles (SPAN diagonals) a block, one warp for each tile boundary
THREADS = 256
ITEMS = 8
TILE = THREADS * ITEMS
TILES = THREADS // 32 - 1
SPAN = TILES * TILE
N_SLOTS = 6  # per-call tensors a launch names (kBases)
N_INLINE = 2  # segments passed as kernel parameters (kInline)
# int64 fields of one descriptor row (csrc/merge_rank.cu::Segment)
(_F_A_SLOT, _F_A_OFF, _F_RAW_K, _F_RAW_V, _F_C_TAB, _F_N_TAB, _F_PAD, _F_N,
 _F_Q_SLOT, _F_Q_OFF, _F_M, _F_STRICT, _F_OUT_SLOT, _F_OUT_OFF, _F_ORD,
 _F_N_REAL, _F_TOTAL_SLOT, _F_TOTAL_OFF, _F_BLOCK0) = range(19)
_F = 20


class Segment(NamedTuple):
    """One rank problem of a segmented B1 launch.

    The queries, a packed table and the outputs live in the launch's
    per-call tensors ("slots"), named here as (slot, element offset), so a
    plan built once serves every call.  ``raw`` = (k, v, c_tab, pad) is a
    table of key codes and values packed on load; its tensors are read in
    place and must outlive the plan.  ``out``: int32 ranks, written to
    ``out[ord[j]]`` (or ``out[j]`` without an order) for j < n_real;
    ``total``: an int64 slot the ranks of all m queries add into."""

    n: int
    m: int
    q: tuple[int, int]
    strict: bool
    a: tuple[int, int] | None = None
    raw: tuple | None = None
    out: tuple[int, int] | None = None
    ord: torch.Tensor | None = None
    n_real: int | None = None
    total: tuple[int, int] | None = None


class SegmentPlan(NamedTuple):
    segs: tuple
    block0: np.ndarray  # int64 [S + 1]: each segment's first block, then all
    device: torch.device  # where the segments' raw tables and orders live
    need: tuple  # per slot: (dtype, least numel), or None for an unused slot
    desc: np.ndarray | None  # int64 [S, _F] descriptors (CUDA), host copy
    desc_dev: torch.Tensor | None  # the same on the card when S > N_INLINE


def segment_blocks(n: int, m: int) -> int:
    """Blocks of a segment: its n + m merge diagonals in spans of SPAN;
    none without queries, which have no rank to give."""
    return -(-(n + m) // SPAN) if m else 0


def _n_real(s: Segment) -> int:
    return s.m if s.n_real is None else s.n_real


def _slot_needs(segs) -> tuple:
    """Per slot the dtype the segments read it as and the elements they
    reach."""
    need: dict[int, tuple] = {}
    for s in segs:
        refs = [(s.q, s.m, torch.int32)]
        if s.a is not None:
            refs.append((s.a, s.n, torch.int32))
        if s.out is not None:
            refs.append((s.out, _n_real(s), torch.int32))
        if s.total is not None:
            refs.append((s.total, 1, torch.int64))
        for (i, off), length, dtype in refs:
            if not 0 <= i < N_SLOTS or off < 0:
                raise ValueError(f"slot reference {(i, off)}: slots are 0 .. {N_SLOTS - 1}")
            was = need.get(i, (dtype, 0))
            if was[0] != dtype:
                raise ValueError(f"slot {i} read as {was[0]} and as {dtype}")
            need[i] = (dtype, max(was[1], off + length))
    return tuple(need.get(i) for i in range(max(need) + 1))


def plan_segments(segs, device) -> SegmentPlan:
    """Block prefix, slot needs and, for the card, the descriptor table of
    ``segs``.

    Built once per plan: with more than N_INLINE segments the descriptors
    are uploaded here, so a warm call copies nothing from the host."""
    segs = tuple(segs)
    if not segs:
        raise ValueError("a segmented launch needs at least one segment")
    block0 = np.zeros(len(segs) + 1, np.int64)
    np.cumsum([segment_blocks(s.n, s.m) for s in segs], out=block0[1:])
    owned = []  # the raw tables and orders, read in place by the kernel
    for s in segs:
        if (s.a is None) == (s.raw is None):
            raise ValueError("a segment's table is packed (a) or raw, not both or neither")
        if not 0 <= s.n < 2**31:
            raise ValueError(f"table of {s.n} rows: ranks must fit int32")
        if s.ord is not None and (s.out is None or s.ord.numel() != _n_real(s)):
            raise ValueError("an order needs an output and one entry a written rank")
        if not 0 <= _n_real(s) <= s.m:
            raise ValueError(f"n_real {s.n_real} outside [0, {s.m}]")
        if s.ord is not None:
            _check(s.ord, "ord", torch.int64)
            owned.append(s.ord)
        if s.raw is not None:
            k, v, c_tab, pad = s.raw
            for t, name in ((k, "k"), (v, "v"), (c_tab, "c_tab")):
                _check(t, name)
            if k.numel() != s.n or v.numel() != s.n or not 0 < c_tab.numel() < 2**31:
                raise ValueError("a raw table's k and v hold n rows and c_tab 1 .. 2^31-1")
            if not 0 <= pad <= _U32:
                raise ValueError(f"pad sentinel {pad} is not a u32")
            owned += [k, v, c_tab]
    device = _same_device(*owned) if owned else torch.device(device)
    need = _slot_needs(segs)
    if device.type != "cuda":
        return SegmentPlan(segs, block0, device, need, None, None)
    desc = np.zeros((len(segs), _F), np.int64)
    for row, s, b0 in zip(desc, segs, block0):
        row[[_F_A_SLOT, _F_OUT_SLOT, _F_TOTAL_SLOT]] = -1
        if s.a is not None:
            row[_F_A_SLOT], row[_F_A_OFF] = s.a
        else:
            k, v, c_tab, pad = s.raw
            row[[_F_RAW_K, _F_RAW_V, _F_C_TAB]] = (k.data_ptr(), v.data_ptr(), c_tab.data_ptr())
            row[_F_N_TAB], row[_F_PAD] = c_tab.numel(), pad
        row[_F_N], row[_F_M], row[_F_STRICT] = s.n, s.m, int(s.strict)
        row[_F_Q_SLOT], row[_F_Q_OFF] = s.q
        if s.out is not None:
            row[_F_OUT_SLOT], row[_F_OUT_OFF] = s.out
            row[_F_ORD] = 0 if s.ord is None else s.ord.data_ptr()
            row[_F_N_REAL] = _n_real(s)
        if s.total is not None:
            row[_F_TOTAL_SLOT], row[_F_TOTAL_OFF] = s.total
        row[_F_BLOCK0] = b0
    desc_dev = to_device(desc, device) if len(segs) > N_INLINE else None
    return SegmentPlan(segs, block0, device, need, desc, desc_dev)


def _slot(slots, ref, length: int, dtype) -> torch.Tensor:
    """The ``length`` elements of slot ``ref`` = (slot, offset)."""
    i, off = ref
    t = slots[i]
    if t.dtype != dtype:
        raise TypeError(f"slot {i}: expected {dtype}, got {t.dtype}")
    return t[off:off + length]


def _check_slots(plan, slots, n_slots: int = N_SLOTS) -> torch.device:
    """Validate the per-call tensors against the plan's needs (per slot,
    not per segment: a warm call stays cheap); their device.  ``plan`` is
    a SegmentPlan, or any plan with its ``need`` and ``device``."""
    if not len(plan.need) <= len(slots) <= n_slots:
        raise ValueError(f"the plan reads {len(plan.need)} slots of at most {n_slots}, "
                         f"got {len(slots)}")
    for i, t in enumerate(slots):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"slot {i}: expected a contiguous 1-D tensor")
    dev = _same_device(*slots)
    want = plan.device
    if dev.type != want.type or want.index not in (None, dev.index):
        raise ValueError(f"a plan on {want}, slots on {dev}")
    for i, need in enumerate(plan.need):
        if need is None:
            continue
        dtype, numel = need
        if slots[i].dtype != dtype:
            raise TypeError(f"slot {i}: expected {dtype}, got {slots[i].dtype}")
        if slots[i].numel() < numel:
            raise ValueError(f"slot {i}: {slots[i].numel()} elements, the plan reads {numel}")
    return dev


def merge_rank_segments_plain(segs, slots) -> None:
    """Plain PyTorch version of the segmented launch: per segment,
    pack_view_plain for a raw table, merge_rank_plain, then the sum or the
    ranks through the order."""
    for s in segs:
        q = _slot(slots, s.q, s.m, torch.int32)
        if s.a is not None:
            a = _slot(slots, s.a, s.n, torch.int32)
        else:
            a = pack_view_plain(*s.raw)
        ranks = merge_rank_plain(a, q, strict=s.strict)
        if s.total is not None:
            _slot(slots, s.total, 1, torch.int64).add_(ranks.sum(dtype=torch.int64))
        if s.out is not None:
            n_real = _n_real(s)
            out = _slot(slots, s.out, n_real, torch.int32)
            if s.ord is None:
                out.copy_(ranks[:n_real])
            else:
                out[s.ord] = ranks[:n_real]


def segments_launcher(plan: SegmentPlan, slots):
    """Validate ``slots`` against ``plan`` once and return a callable that
    runs every segment in ONE launch of the merge-path kernel (B1): ranks
    land in their output slots, sums add into their int64 slots (zero them
    first).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.  Each launch adds one to ``launch.merge_path``."""
    slots = tuple(slots)
    dev = _check_slots(plan, slots)
    if dev.type == "cpu":
        return lambda: merge_rank_segments_plain(plan.segs, slots)
    blocks = int(plan.block0[-1])
    if blocks == 0:
        return lambda: None
    from sequila_tpu_torch.ops.cuda import _lib

    fn = _lib.lib().seq_merge_path
    bases = np.zeros(N_SLOTS, np.uint64)
    bases[: len(slots)] = [t.data_ptr() for t in slots]
    inline = None if plan.desc_dev is not None else plan.desc.ctypes.data
    table = None if plan.desc_dev is None else plan.desc_dev.data_ptr()
    args = (inline, table, len(plan.segs), blocks, bases.ctypes.data)

    def launch(keep=(plan, slots, bases)):  # the launch reads their memory
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(err, "merge_rank_segments")
        count("launch.merge_path")

    return launch


def merge_rank_segments(plan: SegmentPlan, slots) -> None:
    """Run every segment of ``plan`` over the per-call tensors ``slots``
    in one launch (see segments_launcher).  Replaces the TPU kernel
    sequila_tpu/ops/pallas/merge_count.py:110::_merge_rank_sorted (B1) and
    its per-level caller :615."""
    segments_launcher(plan, slots)()


@functools.lru_cache(maxsize=64)
def _packed_plan(n: int, m: int, strict: bool, reduce: bool, device: torch.device) -> SegmentPlan:
    out = {"total": (2, 0)} if reduce else {"out": (2, 0)}
    return plan_segments([Segment(n, m, q=(1, 0), strict=strict, a=(0, 0), **out)], device)


@functools.lru_cache(maxsize=64)
def _count_plan(n1: int, m1: int, n2: int, m2: int, device: torch.device) -> SegmentPlan:
    return plan_segments(count_segments(n1, m1, n2, m2), device)


def merge_rank_sorted(a, q, *, strict: bool, reduce: bool = False) -> torch.Tensor:
    """Rank each sorted u32 query ``q`` in the sorted u32 table ``a``.

    strict=True  -> #{a <  q};  strict=False -> #{a <= q} (unsigned order).
    Returns the int32 ranks, or with ``reduce=True`` their int64 sum as a
    0-d tensor (the kernel then writes no ranks).  ``a`` and ``q`` are
    int32 tensors holding u32 bits, each sorted as u32.  One packed
    segment of merge_rank_segments; ``launch.merge_path`` counts every
    launch of that kernel, whoever calls it.
    Replaces the TPU kernel sequila_tpu/ops/pallas/merge_count.py:110
    ::_merge_rank_sorted (B1)."""
    _check(a, "a")
    _check(q, "q")
    dev = _same_device(a, q)
    if reduce:
        out = torch.zeros(1, dtype=torch.int64, device=dev)
    else:
        out = torch.empty(q.numel(), dtype=torch.int32, device=dev)
    merge_rank_segments(_packed_plan(a.numel(), q.numel(), strict, reduce, dev), (a, q, out))
    return out[0] if reduce else out


def merge_count_passes(
    bqs_k, bqs_v, c_bqs,  # build sorted by (k, end):   queries of pass 1
    pqs_k, pqs_v, c_pqs,  # probe sorted by (k, qs):    table of pass 1
    bqe_k, bqe_v, c_bqe,  # build sorted by (k, start): queries of pass 2
    pqe_k, pqe_v, c_pqe,  # probe sorted by (k, qe):    table of pass 2
) -> torch.Tensor:
    """Both BITS rank passes in one segmented launch; returns the count as
    an int64 0-d tensor.

    Pass 1 sums over build rows #{qs <= end_b}, pass 2 #{qe < start_b}.
    Build PAD rows rank the padded probe length in both passes and cancel;
    probe PAD slots (sentinel below the build sentinel, above every real
    pack) are counted by neither pass."""
    q1 = pack_view(bqs_k, bqs_v, c_bqs, BUILD_PAD)
    a1 = pack_view(pqs_k, pqs_v, c_pqs, PROBE_PAD)
    q2 = pack_view(bqe_k, bqe_v, c_bqe, BUILD_PAD)
    a2 = pack_view(pqe_k, pqe_v, c_pqe, PROBE_PAD)
    totals = torch.zeros(2, dtype=torch.int64, device=q1.device)
    plan = _count_plan(a1.numel(), q1.numel(), a2.numel(), q2.numel(), q1.device)
    merge_rank_segments(plan, (a1, q1, a2, q2, totals))
    return totals[0] - totals[1]


class ProbeCountPlan(NamedTuple):
    segplan: SegmentPlan  # the two segments of one B1 launch
    pqe: tuple  # (k, v, c_tab) of the probe view sorted by (k, qe)
    pqs: tuple  # (k, v, c_tab) of the probe view sorted by (k, qs)
    n: int  # the probe's real rows
    inv_qe: torch.Tensor  # int32 [n]: row i's slot in the (k, qe) view
    inv_qs: torch.Tensor  # int32 [n]: row i's slot in the (k, qs) view


def plan_probe_counts(
    pqe_k, pqe_v, c_qe,  # probe sorted by (k, qe):    queries of pass A
    bst_k, bst_v, c_bs,  # build sorted by (k, start): table of pass A
    pqs_k, pqs_v, c_qs,  # probe sorted by (k, qs):    queries of pass B
    ben_k, ben_v, c_be,  # build sorted by (k, end):   table of pass B
    inv_qe, inv_qs,      # int32 inverse orders of the probe views' real rows
) -> ProbeCountPlan:
    """Plan of merge_probe_count_passes: the two segments of one B1 launch.

    The count(*) passes rank *build* tuples in the sorted probe views; the
    per-probe direction ranks *probe* tuples in the sorted build views with
    the SAME four packings (plan_packing), so the build views are the
    tables, packed on load with PROBE_PAD, and the probe views the queries,
    packed by pack_view with BUILD_PAD.  Pass A (non-strict) ranks each
    probe end among the build starts, pass B (strict) each probe start
    among the build ends; each stores the ranks of the view's real rows
    (they lead, PAD slots trail) direct, in view order, into its row of
    the [2, n] ranks, which unpermute_counts takes to probe row order
    through the inverse orders (``Table.sorted_interval_inverse``).
    Build PAD rows pack to PROBE_PAD, above every real query, and count in
    neither pass.  Port of the device half of
    sequila_tpu/ops/pallas/merge_count.py:196::merge_probe_count_passes;
    its host chunk windows and padded orders are TPU workarounds the
    merge path does not need."""
    n = inv_qe.numel()
    if inv_qs.numel() != n:
        raise ValueError(f"inverse orders of {n} and {inv_qs.numel()} rows")
    _check(inv_qe, "inv_qe")
    _check(inv_qs, "inv_qs")
    segs = (
        Segment(bst_k.numel(), pqe_k.numel(), q=(0, 0), strict=False,
                raw=(bst_k, bst_v, c_bs, PROBE_PAD), out=(2, 0), n_real=n),
        Segment(ben_k.numel(), pqs_k.numel(), q=(1, 0), strict=True,
                raw=(ben_k, ben_v, c_be, PROBE_PAD), out=(2, n), n_real=n),
    )
    return ProbeCountPlan(plan_segments(segs, inv_qe.device),
                          (pqe_k, pqe_v, c_qe), (pqs_k, pqs_v, c_qs), n, inv_qe, inv_qs)


def unpermute_counts_plain(ranks, inv_e, inv_s) -> torch.Tensor:
    """Plain PyTorch unpermute_counts: each row indexed through its view's
    inverse order, then the difference."""
    return ranks[0][inv_e] - ranks[1][inv_s]


def unpermute_counts(ranks, inv_e, inv_s) -> torch.Tensor:
    """Per-probe counts from two rank rows stored in view order: int32
    [n], ``out[i] = ranks[0, inv_e[i]] - ranks[1, inv_s[i]]``.

    ``ranks`` = contiguous int32 [2, n]; ``inv_e`` / ``inv_s`` = int32 [n]:
    each probe row's slot in the view of row 0 / row 1 (permutations of
    0 .. n - 1, which the kernel does not check).  One launch of
    csrc/merge_rank.cu::unpermute_counts_kernel for CUDA tensors, counted
    in ``launch.unpermute_counts``; the plain version for CPU tensors.
    Replaces the two XLA scatters and the subtraction of
    sequila_tpu/ops/pallas/merge_count.py:237-243
    (merge_probe_count_passes)."""
    if ranks.dtype != torch.int32 or ranks.dim() != 2 or ranks.shape[0] != 2:
        raise ValueError(f"ranks: expected int32 [2, n], got {ranks.dtype} {tuple(ranks.shape)}")
    if not ranks.is_contiguous():
        raise ValueError("ranks: expected a contiguous tensor")
    _check(inv_e, "inv_e")
    _check(inv_s, "inv_s")
    n = ranks.shape[1]
    if inv_e.numel() != n or inv_s.numel() != n:
        raise ValueError(f"inverse orders of {inv_e.numel()} and {inv_s.numel()} rows, "
                         f"ranks of {n}")
    dev = _same_device(ranks, inv_e, inv_s)
    if dev.type == "cpu":
        return unpermute_counts_plain(ranks, inv_e, inv_s)
    from sequila_tpu_torch.ops.cuda import _lib

    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib.lib().seq_unpermute_counts(
            ranks.data_ptr(), inv_e.data_ptr(), inv_s.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "unpermute_counts")
    count("launch.unpermute_counts")
    return out


def merge_probe_count_passes(plan: ProbeCountPlan) -> torch.Tensor:
    """Per-probe BITS counts (CountOverlaps) in probe row order, int32:

        count_q = #{b: start_b <= qe_q} - #{b: end_b < qs_q}

    Build rows of smaller joint keys land in both terms (their packed start
    AND end sit in lower u32 segments) and cancel; larger keys land in
    neither; same-key rows reduce to exact BITS.  Two pack_view launches
    for the probe views, one B1 launch for both passes (ranks stored
    direct, in view order), one unpermute_counts launch (the difference
    through the inverse orders).  Port of
    sequila_tpu/ops/pallas/merge_count.py:196::merge_probe_count_passes,
    whose two Pallas B1 calls (:229-230) are the two segments here and
    whose scatters and subtraction (:237-243) are the un-permute."""
    q_e = pack_view(*plan.pqe, BUILD_PAD)
    q_s = pack_view(*plan.pqs, BUILD_PAD)
    ranks = torch.empty((2, plan.n), dtype=torch.int32, device=q_e.device)
    merge_rank_segments(plan.segplan, (q_e, q_s, ranks.view(-1)))
    return unpermute_counts(ranks, plan.inv_qe, plan.inv_qs)


def merge_probe_count_passes_plain(plan: ProbeCountPlan) -> torch.Tensor:
    """Plain PyTorch merge_probe_count_passes with no segment machinery:
    per pass pack_view_plain of both sides and merge_rank_plain, the ranks
    in view order; then unpermute_counts_plain through the inverse
    orders."""
    ranks = torch.stack([
        merge_rank_plain(pack_view_plain(*seg.raw), pack_view_plain(*qry, BUILD_PAD),
                         strict=seg.strict)[:plan.n]
        for seg, qry in zip(plan.segplan.segs, (plan.pqe, plan.pqs))
    ])
    return unpermute_counts_plain(ranks, plan.inv_qe, plan.inv_qs)


# ---------------------------------------------------------------------------
# The genomic verbs' rank passes (count_overlaps, coverage)
# ---------------------------------------------------------------------------


class VerbRankPlan(NamedTuple):
    segplan: SegmentPlan  # the four segments of one B1 launch
    packs: tuple  # per query slot (k, v, c_tab) of a probe view, packed with BUILD_PAD
    n: int  # the probe's real rows
    inv_qe: torch.Tensor  # int32 [n]: row i's slot in the (k, qe) view
    inv_qs: torch.Tensor  # int32 [n]: row i's slot in the (k, qs) view


def plan_verb_ranks(build, probe, cols_b, cols_q, *, want4: bool, device):
    """Plan of the verb layer's merge rank passes on ``device``, or None.

    ``cols_*`` are (key, start, end) column INDICES of Tables (build = the
    counted side, probe = the enriched side; no ±deltas at the verb layer).
    want4=False returns the ProbeCountPlan of merge_probe_count_passes
    (count_overlaps); want4=True a VerbRankPlan of merge_verb_rank4
    (coverage).  None when the preconditions or the 32-bit span budget
    disqualify the packing, checked in the JAX package's order: an empty
    side, NULL keys, a degenerate probe or inverted build row (they break
    the BITS rank algebra), key columns of different types, then a joint
    domain over 32 bits; callers fall back to the rank kernels.  Port of
    sequila_tpu/ops/pallas/merge_count.py:359::plan_verb_ranks without its
    host chunk windows and padded orders (TPU workarounds the merge path
    does not need): both plans carry the probe views' cached int32 inverse
    orders."""
    from sequila_tpu_torch.models.table import view_extrema, view_remaps

    kb, s_b, e_b = cols_b
    kq, s_q, e_q = cols_q
    if build.num_rows == 0 or probe.num_rows == 0:
        return None
    if build.column(kb).null_count or probe.column(kq).null_count:
        return None
    if probe.min_i32_diff(e_q, s_q, device) < 0 or build.min_i32_diff(e_b, s_b, device) < 0:
        return None
    remaps = view_remaps(build, kb, probe, kq, device)
    if remaps is None:
        return None
    remap_b, remap_q = remaps
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1
    bs_mm, be_mm, qs_mm, qe_mm = view_extrema(build, kb, probe, kq, (s_b, e_b, s_q, e_q), device)

    def dom(b_mm, q_mm):
        return _joint_domain(
            remap_b, remap_q, nkeys, b_mm[0], b_mm[1], 0, q_mm[0], q_mm[1], 0
        )

    # domain 2 (bs, qe): #{start_b <= qe}; domain 1 (be, qs): #{end_b < qs};
    # coverage adds domain 3 (be, qe): #{end_b <= qe} and 4 (bs, qs):
    # #{start_b < qs}
    doms = [dom(bs_mm, qe_mm), dom(be_mm, qs_mm)]
    if want4:
        doms += [dom(be_mm, qe_mm), dom(bs_mm, qs_mm)]
    if None in doms:
        return None
    dev = torch.device(device)
    c_q = [c_tab_tensor(_c_tab(remap_q, *d, 0), dev) for d in doms]
    c_b = [c_tab_tensor(_c_tab(remap_b, *d, 0), dev) for d in doms]
    pqe_k, pqe_v, _ = probe.sorted_interval_view(kq, e_q, dev)
    pqs_k, pqs_v, _ = probe.sorted_interval_view(kq, s_q, dev)
    bst_k, bst_v, _ = build.sorted_interval_view(kb, s_b, dev)
    ben_k, ben_v, _ = build.sorted_interval_view(kb, e_b, dev)
    inv_qe = probe.sorted_interval_inverse(kq, e_q, dev)
    inv_qs = probe.sorted_interval_inverse(kq, s_q, dev)
    if not want4:
        return plan_probe_counts(
            pqe_k, pqe_v, c_q[0], bst_k, bst_v, c_b[0],
            pqs_k, pqs_v, c_q[1], ben_k, ben_v, c_b[1], inv_qe, inv_qs,
        )
    n = probe.num_rows
    # per segment: (queries, the build view with its C table, strict); query
    # slot i holds the probe view of segment i, whose real ranks go direct,
    # in view order, to row i of the [4, n] view-order ranks
    parts = (
        ((pqe_k, pqe_v, c_q[0]), (bst_k, bst_v, c_b[0]), False),  # ub_s
        ((pqs_k, pqs_v, c_q[1]), (ben_k, ben_v, c_b[1]), True),   # lb_e
        ((pqe_k, pqe_v, c_q[2]), (ben_k, ben_v, c_b[2]), False),  # ub_e
        ((pqs_k, pqs_v, c_q[3]), (bst_k, bst_v, c_b[3]), True),   # lb_s
    )
    segs = tuple(
        Segment(tab[0].numel(), qry[0].numel(), q=(i, 0), strict=strict,
                raw=(*tab, PROBE_PAD), out=(4, i * n), n_real=n)
        for i, (qry, tab, strict) in enumerate(parts)
    )
    return VerbRankPlan(plan_segments(segs, dev), tuple(p[0] for p in parts), n,
                        inv_qe, inv_qs)


def unpermute_ranks_plain(ranks, inv_e, inv_s) -> torch.Tensor:
    """Plain PyTorch unpermute_ranks: each row indexed through its view's
    inverse order."""
    return torch.stack([row[inv] for row, inv in zip(ranks, (inv_e, inv_s, inv_e, inv_s))])


def unpermute_ranks(ranks, inv_e, inv_s) -> torch.Tensor:
    """Four rank rows stored in view order back to probe row order: (4, n)
    int32, ``out[p, i] = ranks[p, inv[i]]`` with inv = ``inv_e`` for rows
    0 and 2 and ``inv_s`` for rows 1 and 3.

    ``ranks`` = contiguous int32 [4, n]; ``inv_e`` / ``inv_s`` = int32 [n]:
    each probe row's slot in the view of rows 0, 2 / 1, 3 (permutations of
    0 .. n - 1, which the kernel does not check).  One launch of
    csrc/merge_rank.cu::unpermute_planes_kernel for CUDA tensors, counted
    in ``launch.unpermute_ranks``; the plain version for CPU tensors.
    Replaces the XLA scatter of sequila_tpu/ops/pallas/merge_count.py:345
    (merge_verb_rank4's scat)."""
    if ranks.dtype != torch.int32 or ranks.dim() != 2 or ranks.shape[0] != 4:
        raise ValueError(f"ranks: expected int32 [4, n], got {ranks.dtype} {tuple(ranks.shape)}")
    if not ranks.is_contiguous():
        raise ValueError("ranks: expected a contiguous tensor")
    _check(inv_e, "inv_e")
    _check(inv_s, "inv_s")
    n = ranks.shape[1]
    if inv_e.numel() != n or inv_s.numel() != n:
        raise ValueError(f"inverse orders of {inv_e.numel()} and {inv_s.numel()} rows, "
                         f"ranks of {n}")
    dev = _same_device(ranks, inv_e, inv_s)
    if dev.type == "cpu":
        return unpermute_ranks_plain(ranks, inv_e, inv_s)
    from sequila_tpu_torch.ops.cuda import _lib

    out = torch.empty_like(ranks)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib.lib().seq_unpermute_planes(
            ranks.data_ptr(), inv_e.data_ptr(), inv_s.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "unpermute_ranks")
    count("launch.unpermute_ranks")
    return out


def merge_verb_rank4(plan: VerbRankPlan) -> torch.Tensor:
    """The four per-probe rank passes of the coverage decomposition
    (ops/genomic.py::coverage's level-free algebra) over cached sorted
    views, no device sort: (4, n) int32 in probe row order, rows
    [ub_s, lb_e, ub_e, lb_s] = [#{start_b <= qe}, #{end_b < qs},
    #{end_b <= qe}, #{start_b < qs}].

    Four pack_view launches pack the probe views ((k, qe) under domains 2
    and 3, (k, qs) under 1 and 4, BUILD_PAD), then ONE B1 launch runs four
    segments: the build views are the tables, packed on load with
    PROBE_PAD, and each segment stores its real ranks direct, in view
    order, into its row (coalesced).  One unpermute_ranks launch takes
    them to probe row order through the views' cached inverse orders.
    Cross-key rows land in matched pass pairs and cancel in every consumer
    expression (total = ub_s - lb_e, nA = ub_e - lb_e, nB = ub_s - lb_s,
    and the prefix-sum differences read same-key rank ranges by
    construction).  Port of
    sequila_tpu/ops/pallas/merge_count.py:303::merge_verb_rank4, whose four
    Pallas B1 calls (:323-342) are the four segments here and whose
    scatter (:345) is the un-permute."""
    packed = [pack_view(*p, BUILD_PAD) for p in plan.packs]
    ranks = torch.empty((4, plan.n), dtype=torch.int32, device=packed[0].device)
    merge_rank_segments(plan.segplan, (*packed, ranks.view(-1)))
    return unpermute_ranks(ranks, plan.inv_qe, plan.inv_qs)


def merge_verb_rank4_plain(plan: VerbRankPlan) -> torch.Tensor:
    """Plain PyTorch merge_verb_rank4 with no segment machinery: per pass
    pack_view_plain of both sides and merge_rank_plain, the ranks in view
    order; then unpermute_ranks_plain through the inverse orders."""
    ranks = torch.stack([
        merge_rank_plain(pack_view_plain(*seg.raw), pack_view_plain(*qry, BUILD_PAD),
                         strict=seg.strict)[:plan.n]
        for seg, qry in zip(plan.segplan.segs, plan.packs)
    ])
    return unpermute_ranks_plain(ranks, plan.inv_qe, plan.inv_qs)


def coverage_from_ranks(ranks, qs, qe, psum, esum):
    """int64 finish of the coverage decomposition over merge ranks, as
    torch ops on the ranks' device; returns (count, bases) int64 numpy
    arrays, the only data that crosses to the host.

    ``ranks`` = (4, n) int32 [ub_s, lb_e, ub_e, lb_s] in probe row order
    (merge_verb_rank4); ``qs``/``qe`` the probe's starts and ends in row
    order; ``psum``/``esum`` = int64 exclusive prefix sums of the build's
    (k, start)-view starts / (k, end)-view ends.  Same algebra as
    ops/genomic.py::coverage's level-free branch.  Port of
    sequila_tpu/ops/pallas/merge_count.py:460::coverage_from_ranks."""
    dev = ranks.device

    def i64(t):
        return torch.as_tensor(t).to(dev, torch.int64)

    ub_s, lb_e, ub_e, lb_s = ranks.to(torch.int64)
    psum, esum = i64(psum), i64(esum)
    total = ub_s - lb_e
    nA = ub_e - lb_e
    nB = ub_s - lb_s
    sumA_end = esum[ub_e] - esum[lb_e]
    sumB_start = psum[ub_s] - psum[lb_s]
    sum_min_end = sumA_end + i64(qe) * (total - nA)
    sum_max_start = sumB_start + i64(qs) * (total - nB)
    return to_host(total), to_host(sum_min_end - sum_max_start)


def count_segments(n1: int, m1: int, n2: int, m2: int) -> tuple:
    """The two segments of a count(*) over the slots (a1, q1, a2, q2,
    totals[2]): pass 1 non-strict into totals[0], pass 2 strict into
    totals[1]."""
    return (
        Segment(n1, m1, q=(1, 0), strict=False, a=(0, 0), total=(4, 0)),
        Segment(n2, m2, q=(3, 0), strict=True, a=(2, 0), total=(4, 1)),
    )


# ---------------------------------------------------------------------------
# Merge-based level bounds: pair emission without device sorts
# ---------------------------------------------------------------------------


def plan_level_bounds(index, probe, r_key, qs_cd, qe_cd, bs_cd, be_cd,
                      remap_b, remap_q, views):
    """Segmented merge-rank plan for emission bounds, or None.

    Each level slice of the build index is sorted by (key, start) and, by
    the monotone-end level invariant, also by (key, end), so both bounds
    of every level rank the cached sorted probe views inside an already
    sorted packed-u32 array: 2L segments of one merge_rank_segments launch
    and no device sort.  Exact for every query shape (degenerate stabbing
    probes, inverted build rows): the level-run identity needs no BITS
    subset argument, so this route is wider than the merge count.

    ``index``: IntervalIndex over JOINT key codes with the planner's ±lit
    bound deltas already applied to its stored starts and ends, so the
    index-side C tables carry delta 0 while the domains span the raw
    extrema plus delta.  ``views`` = per-LOCAL-code extrema of the four raw
    columns (models/table.view_extrema: bs, be, qs, qe); ``*_cd`` =
    (column index, delta).  The plan lives on ``index.device``.  Port of
    sequila_tpu/ops/pallas/merge_count.py::plan_level_bounds; the CUDA B1
    reads no chunk windows, and packs each level's REAL rows raw from the
    index's device arrays on load (a level's PAD tail would pack to
    PROBE_PAD, above every real query, and change no rank).
    """
    nkeys = int(max(remap_b.max(initial=-1), remap_q.max(initial=-1))) + 1
    if nkeys <= 0 or index.n_rows == 0:
        return None
    bs_mm, be_mm, qs_mm, qe_mm = views
    d_bs, d_be, d_qs, d_qe = bs_cd[1], be_cd[1], qs_cd[1], qe_cd[1]
    # domain 2 packs build starts against probe ends; domain 1 packs
    # build ends against probe starts — the count path's pairing
    d2 = _joint_domain(
        remap_b, remap_q, nkeys, bs_mm[0], bs_mm[1], d_bs, qe_mm[0], qe_mm[1], d_qe
    )
    d1 = _joint_domain(
        remap_b, remap_q, nkeys, be_mm[0], be_mm[1], d_be, qs_mm[0], qs_mm[1], d_qs
    )
    if d1 is None or d2 is None:
        return None
    dev = index.device
    ident = np.arange(nkeys, dtype=np.int32)
    # index levels store raw+delta values -> joint-key C tables with delta
    # 0; probe views store raw values -> local-code C tables with the
    # planner delta folded in
    c_bj2 = c_tab_tensor(_c_tab(ident, *d2, 0), dev)
    c_bj1 = c_tab_tensor(_c_tab(ident, *d1, 0), dev)
    c_qe = c_tab_tensor(_c_tab(remap_q, *d2, d_qe), dev)
    c_qs = c_tab_tensor(_c_tab(remap_q, *d1, d_qs), dev)

    pqe_k, pqe_v, n = probe.sorted_interval_view(r_key, qe_cd[0], dev)
    pqs_k, pqs_v, _ = probe.sorted_interval_view(r_key, qs_cd[0], dev)
    m_pad = pqe_k.numel()
    # the views' real rows lead and their PAD slots trail, so the orders
    # (real rows only) scatter the first n ranks and nothing else
    ord_qe, ord_qs = (
        probe.sorted_interval_order(r_key, c, dev).long() for c in (qe_cd[0], qs_cd[0])
    )
    # slots of a call: 0 packed probe ends, 1 packed probe starts, 2 the
    # [2, L, n] bounds (lb rows, then ub rows) flattened
    L = index.num_levels
    segs = []
    for lv in range(L):
        lo, size = index.level_offsets[lv], index.level_sizes[lv]
        k_l = index.keys[lo:lo + size]
        # ub: the probe ends among the level's starts, #{start <= qe}
        segs.append(Segment(size, m_pad, q=(0, 0), strict=False,
                            raw=(k_l, index.starts[lo:lo + size], c_bj2, PROBE_PAD),
                            out=(2, (L + lv) * n), ord=ord_qe, n_real=n))
        # lb: the probe starts among its ends, #{end < qs}
        segs.append(Segment(size, m_pad, q=(1, 0), strict=True,
                            raw=(k_l, index.ends[lo:lo + size], c_bj1, PROBE_PAD),
                            out=(2, lv * n), ord=ord_qs, n_real=n))
    return plan_segments(segs, dev), pqe_k, pqe_v, pqs_k, pqs_v, c_qe, c_qs, L, n


def merge_level_bounds(plan):
    """Run the plan: per-level [lb, ub) emission bounds, [L, n] int32 in
    PROBE ROW order (n = the probe's real rows) — drop-in for
    ops/interval_join.overlap_bounds.  Two pack_view launches for the probe
    views, then one B1 launch for every level and both bounds."""
    segplan, pqe_k, pqe_v, pqs_k, pqs_v, c_qe, c_qs, L, n = plan
    q_e = pack_view(pqe_k, pqe_v, c_qe, BUILD_PAD)
    q_s = pack_view(pqs_k, pqs_v, c_qs, BUILD_PAD)
    bounds = torch.empty((2, L, n), dtype=torch.int32, device=q_e.device)
    merge_rank_segments(segplan, (q_e, q_s, bounds.view(-1)))
    return bounds[0], bounds[1]
