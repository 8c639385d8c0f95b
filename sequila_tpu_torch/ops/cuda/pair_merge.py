"""Segmented merge path over sorted (key, value) pairs: the launch behind
B2 (stream_rank.py) and B3 (rank_kernel.py).

csrc/pair_merge.cu::pair_merge_kernel ranks sorted int32 (key, value)
queries in sorted (key, value) tables, pairs compared signed-
lexicographically (the order of ops/ranks.composite), any number of
independent segments in one launch.  A segment may clamp each rank to B2's
per-block windows, and writes its int32 ranks and/or adds their sum into
an int64.  Plans and slots work as B1's (merge_count.py::plan_segments and
segments_launcher): a plan built once names the per-call tensors as
(slot, element offset), so a warm call copies nothing from the host but
the kernel's parameters.

The launcher launches the CUDA kernel for CUDA tensors (or raises) and
runs the plain PyTorch version only for CPU tensors; each launch adds one
to the counter ``launch.pair_merge`` (utils/metrics.count), whichever of
B2 and B3 it serves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sequila_tpu_torch.ops.cuda.merge_count import _check_slots, _same_device, _slot
from sequila_tpu_torch.ops.ranks import composite
from sequila_tpu_torch.utils.metrics import count

# the kernel's tiling: THREADS x ITEMS merge diagonals a tile, TILES
# tiles (SPAN diagonals) a block, one warp for each tile boundary
THREADS = 256
ITEMS = 8
TILE = THREADS * ITEMS
TILES = 4
SPAN = TILES * TILE
N_SLOTS = 16  # per-call tensors a launch names (kBases)
N_INLINE = 2  # segments passed as kernel parameters (kInline)
# B2's windows: one (c_lo, n_chunks) a BLOCK of queries, in CHUNK-row chunks
BLOCK = 256
CHUNK = 2048
# int64 fields of one descriptor row, in the order of
# csrc/pair_merge.cu::Segment
FIELDS = ("ak_slot", "ak_off", "av_slot", "av_off", "n",
          "qk_slot", "qk_off", "qv_slot", "qv_off", "m", "strict",
          "lo_slot", "lo_off", "nch_slot", "nch_off",
          "out_slot", "out_off", "total_slot", "total_off", "block0")
_F = {name: i for i, name in enumerate(FIELDS)}


class PairSegment(NamedTuple):
    """One rank problem of a pair-merge launch: the table (a_k, a_v) of n
    rows and the queries (q_k, q_v) of m rows, each an int32 (slot,
    offset).  ``c_lo``/``n_chunks``: B2's windows (int32, one a BLOCK of
    queries), both or neither; ``out``: int32 ranks; ``total``: an int64
    slot the ranks of all m queries add into."""

    n: int
    m: int
    a_k: tuple[int, int]
    a_v: tuple[int, int]
    q_k: tuple[int, int]
    q_v: tuple[int, int]
    strict: bool
    c_lo: tuple[int, int] | None = None
    n_chunks: tuple[int, int] | None = None
    out: tuple[int, int] | None = None
    total: tuple[int, int] | None = None


class PairPlan(NamedTuple):
    segs: tuple
    block0: np.ndarray  # int64 [S + 1]: each segment's first block, then all
    device: torch.device
    need: tuple  # per slot: (dtype, least numel), or None for an unused slot
    desc: np.ndarray | None  # int64 [S, len(FIELDS)] descriptors (CUDA), host copy
    desc_dev: torch.Tensor | None  # the same on the card when S > N_INLINE


def segment_blocks(n: int, m: int) -> int:
    """Blocks of a segment: its n + m merge diagonals in spans of SPAN;
    none without queries, which have no rank to give."""
    return -(-(n + m) // SPAN) if m else 0


def _refs(s: PairSegment):
    """(slot reference, elements read or written, dtype) of a segment."""
    windows = -(-s.m // BLOCK)
    refs = [(s.a_k, s.n, torch.int32), (s.a_v, s.n, torch.int32),
            (s.q_k, s.m, torch.int32), (s.q_v, s.m, torch.int32)]
    if s.c_lo is not None:
        refs += [(s.c_lo, windows, torch.int32), (s.n_chunks, windows, torch.int32)]
    if s.out is not None:
        refs.append((s.out, s.m, torch.int32))
    if s.total is not None:
        refs.append((s.total, 1, torch.int64))
    return refs


def _slot_needs(segs) -> tuple:
    need: dict[int, tuple] = {}
    for s in segs:
        for (i, off), length, dtype in _refs(s):
            if not 0 <= i < N_SLOTS or off < 0:
                raise ValueError(f"slot reference {(i, off)}: slots are 0 .. {N_SLOTS - 1}")
            was = need.get(i, (dtype, 0))
            if was[0] != dtype:
                raise ValueError(f"slot {i} read as {was[0]} and as {dtype}")
            need[i] = (dtype, max(was[1], off + length))
    return tuple(need.get(i) for i in range(max(need) + 1))


def plan_pair_segments(segs, device) -> PairPlan:
    """Block prefix, slot needs and, for the card, the descriptor table of
    ``segs``: built once per plan, so a warm call copies nothing."""
    segs = tuple(segs)
    if not segs:
        raise ValueError("a pair-merge launch needs at least one segment")
    for s in segs:
        if not 0 <= s.n < 2**31 or s.m < 0:
            raise ValueError(f"table of {s.n} rows, {s.m} queries: ranks must fit int32")
        if (s.c_lo is None) != (s.n_chunks is None):
            raise ValueError("a segment's windows need both c_lo and n_chunks")
    block0 = np.zeros(len(segs) + 1, np.int64)
    np.cumsum([segment_blocks(s.n, s.m) for s in segs], out=block0[1:])
    device = torch.device(device)
    need = _slot_needs(segs)
    if device.type != "cuda":
        return PairPlan(segs, block0, device, need, None, None)
    desc = descriptors(segs, block0)
    desc_dev = torch.from_numpy(desc).to(device) if len(segs) > N_INLINE else None
    return PairPlan(segs, block0, device, need, desc, desc_dev)


def descriptors(segs, block0) -> np.ndarray:
    """int64 [S, len(FIELDS)]: the rows csrc/pair_merge.cu::Segment reads,
    slot -1 where a segment has no windows, ranks or sum."""
    desc = np.zeros((len(segs), len(FIELDS)), np.int64)
    for row, s, b0 in zip(desc, segs, block0):
        for prefix, ref in (("ak", s.a_k), ("av", s.a_v), ("qk", s.q_k), ("qv", s.q_v),
                            ("lo", s.c_lo), ("nch", s.n_chunks), ("out", s.out),
                            ("total", s.total)):
            row[_F[f"{prefix}_slot"]], row[_F[f"{prefix}_off"]] = (-1, 0) if ref is None else ref
        row[_F["n"]], row[_F["m"]], row[_F["strict"]] = s.n, s.m, int(s.strict)
        row[_F["block0"]] = b0
    return desc


def pair_rank_plain(a_k, a_v, q_k, q_v, *, strict: bool, c_lo=None,
                    n_chunks=None) -> torch.Tensor:
    """Plain PyTorch rank of one segment (int64): a searchsorted over int64
    composites, clamped to each query block's window when given — the TPU
    kernel's ``c_lo * CHUNK + #{window rows before q}`` for c_lo >= 0."""
    ranks = torch.searchsorted(composite(a_k, a_v), composite(q_k, q_v), right=not strict)
    if c_lo is None:
        return ranks
    blk = torch.arange(q_k.numel(), device=q_k.device) // BLOCK
    lo = c_lo.to(torch.int64)[blk]
    w0 = lo * CHUNK
    w1 = torch.clamp((lo + n_chunks.to(torch.int64)[blk].clamp(min=0)) * CHUNK,
                     max=a_k.numel())
    return torch.minimum(torch.maximum(ranks, w0), torch.maximum(w1, w0))


def pair_segments_plain(segs, slots) -> None:
    """Plain PyTorch version of the launch: pair_rank_plain per segment,
    then its sum and/or its ranks."""

    def get(ref, length, dtype=torch.int32):
        return _slot(slots, ref, length, dtype)

    for s in segs:
        windows = -(-s.m // BLOCK)
        ranks = pair_rank_plain(
            get(s.a_k, s.n), get(s.a_v, s.n), get(s.q_k, s.m), get(s.q_v, s.m),
            strict=s.strict,
            c_lo=None if s.c_lo is None else get(s.c_lo, windows),
            n_chunks=None if s.c_lo is None else get(s.n_chunks, windows),
        )
        if s.total is not None:
            get(s.total, 1, torch.int64).add_(ranks.sum(dtype=torch.int64))
        if s.out is not None:
            get(s.out, s.m).copy_(ranks)


def segments_launcher(plan: PairPlan, slots):
    """Validate ``slots`` against ``plan`` once and return a callable that
    runs every segment in ONE launch of the pair-merge kernel: ranks land
    in their output slots, sums add into their int64 slots (zero them
    first).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise.  Each launch adds one to ``launch.pair_merge``."""
    slots = tuple(slots)
    dev = _check_slots(plan, slots, N_SLOTS)
    if dev.type == "cpu":
        return lambda: pair_segments_plain(plan.segs, slots)
    blocks = int(plan.block0[-1])
    if blocks == 0:
        return lambda: None
    from sequila_tpu_torch.ops.cuda import _lib

    fn = _lib.lib().seq_pair_merge
    bases = np.zeros(N_SLOTS, np.uint64)
    bases[: len(slots)] = [t.data_ptr() for t in slots]
    inline = None if plan.desc_dev is not None else plan.desc.ctypes.data
    table = None if plan.desc_dev is None else plan.desc_dev.data_ptr()
    args = (inline, table, len(plan.segs), blocks, bases.ctypes.data)

    def launch(keep=(plan, slots, bases)):  # the launch reads their memory
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(err, "pair_merge_segments")
        count("launch.pair_merge")

    return launch


def pair_merge_segments(plan: PairPlan, slots) -> None:
    """Run every segment of ``plan`` over the per-call tensors ``slots``
    in one launch (see segments_launcher).  Replaces the TPU kernels
    sequila_tpu/ops/pallas/stream_rank.py:86::_stream_rank_sorted (B2) and
    sequila_tpu/ops/pallas/rank_kernel.py:126::_pallas_rank_sorted (B3)."""
    segments_launcher(plan, slots)()


@functools.lru_cache(maxsize=64)
def _rank_plan(n: int, m: int, strict: bool, windowed: bool, reduce: bool,
               device: torch.device) -> PairPlan:
    win = dict(c_lo=(5, 0), n_chunks=(6, 0)) if windowed else {}
    out = dict(total=(4, 0)) if reduce else dict(out=(4, 0))
    return plan_pair_segments([PairSegment(n, m, a_k=(0, 0), a_v=(1, 0), q_k=(2, 0), q_v=(3, 0),
                                           strict=strict, **win, **out)], device)


def rank_pairs(a_k, a_v, q_k, q_v, *, strict: bool, reduce: bool, windows=()) -> torch.Tensor:
    """One segment over the slots (a_k, a_v, q_k, q_v, out, *windows):
    int32 ranks, or with ``reduce`` their int64 sum as a 0-d tensor."""
    dev = _same_device(a_k, a_v, q_k, q_v, *windows)
    m = q_k.numel()
    out = (torch.zeros(1, dtype=torch.int64, device=dev) if reduce
           else torch.empty(m, dtype=torch.int32, device=dev))
    plan = _rank_plan(a_k.numel(), m, strict, bool(windows), reduce, dev)
    pair_merge_segments(plan, (a_k, a_v, q_k, q_v, out, *windows))
    return out[0] if reduce else out
