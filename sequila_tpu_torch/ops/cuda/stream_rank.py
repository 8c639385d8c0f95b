"""Windowed lexicographic ranks of the `stream` count(*) route.

Port of sequila_tpu/ops/pallas/stream_rank.py.  The count runs over the
tables' cached (key, value)-sorted views, with no device sort:

- ``host_windows`` (numpy, copied) gives each block of BLOCK sorted
  queries its window of CHUNK-row build chunks ``[c_lo, c_lo + n_chunks)``
  from int64 composites of the cached host views;
- ``stream_rank_sorted`` ranks the queries, each clamped to its block's
  window: one windowed segment of the hand-written CUDA merge path over
  pairs, csrc/pair_merge.cu (B2, ops/cuda/pair_merge.py), which reads
  every build and query pair once whatever the windows;
- ``stream_count_passes`` runs the two BITS passes over the views
  ``stream_pass_inputs`` prepares (both sides' codes remapped into the
  joint key space, the planner's ±lit deltas and the PAD rules applied)
  as two segments of one launch, each summed into its own int64 (the JAX
  package returned 64-bucket int32 partials).

Comparisons are signed int32 lexicographic on (key, value).  The wrapper
launches its CUDA kernel for CUDA tensors (or raises) and runs its plain
PyTorch version only for CPU tensors; the counter ``launch.pair_merge``
counts kernel launches, those of ``stream_count_passes`` included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sequila_tpu_torch.ops.cuda.merge_count import _check
from sequila_tpu_torch.ops.cuda.pair_merge import (
    BLOCK,
    CHUNK,
    PairPlan,
    PairSegment,
    pair_rank_plain,
    plan_pair_segments,
    rank_pairs,
    segments_launcher,
)
from sequila_tpu_torch.ops.ranks import composite

PAD = 2**31 - 1


def _check_build(a2: torch.Tensor) -> None:
    if a2.dtype != torch.int32:
        raise TypeError(f"a2: expected torch.int32, got {a2.dtype}")
    if a2.dim() != 2 or a2.shape[0] != 2 or a2.shape[1] % CHUNK:
        raise ValueError(f"a2: expected shape (2, a multiple of {CHUNK}), got {tuple(a2.shape)}")
    if not a2.is_contiguous():
        raise ValueError("a2: expected a contiguous tensor")
    if a2.shape[1] >= 2**31:
        raise ValueError(f"build of {a2.shape[1]} rows: ranks must fit int32")


def stream_rank_plain(a2, c_lo, n_chunks, q_keys, q_vals, *, strict: bool,
                      reduce: bool = False) -> torch.Tensor:
    """Plain PyTorch stream_rank_sorted: the global rank over int64
    composites, clamped to each block's window — the kernel's
    ``c_lo * CHUNK + #{build rows of the window before q}`` for windows
    with ``c_lo >= 0``."""
    ranks = pair_rank_plain(a2[0], a2[1], q_keys, q_vals, strict=strict, c_lo=c_lo,
                            n_chunks=n_chunks)
    if reduce:
        return ranks.sum()
    return ranks.to(torch.int32)


def stream_rank_sorted(a2, c_lo, n_chunks, q_keys, q_vals, *, strict: bool,
                       reduce: bool = False) -> torch.Tensor:
    """Rank sorted (key, value) queries in their windows of the sorted
    build ``a2`` (int32, shape (2, n_pad): keys then values, n_pad a
    multiple of CHUNK).

    ``c_lo``/``n_chunks`` (int32, one per block of BLOCK queries) are the
    windows of ``host_windows``; strict=True counts build tuples ``<`` the
    query, strict=False ``<=``.  Returns int32 ranks, or with
    ``reduce=True`` their int64 sum as a 0-d tensor.  One windowed segment
    of the pair-merge launch (pair_merge.py).
    Replaces the TPU kernel sequila_tpu/ops/pallas/stream_rank.py:86
    ::_stream_rank_sorted (B2)."""
    _check_build(a2)
    for t, name in ((c_lo, "c_lo"), (n_chunks, "n_chunks"), (q_keys, "q_keys"),
                    (q_vals, "q_vals")):
        _check(t, name)
    m = q_keys.numel()
    if q_vals.numel() != m:
        raise ValueError(f"q_keys and q_vals differ in length: {m} != {q_vals.numel()}")
    blocks = -(-m // BLOCK)
    if c_lo.numel() != blocks or n_chunks.numel() != blocks:
        raise ValueError(
            f"{blocks} query blocks need as many windows, got {c_lo.numel()} and "
            f"{n_chunks.numel()}"
        )
    return rank_pairs(a2[0], a2[1], q_keys, q_vals, strict=strict, reduce=reduce,
                      windows=(c_lo, n_chunks))


def _remap_keys(k, remap):
    safe = k.clamp(0, remap.numel() - 1).to(torch.int64)
    return torch.where(k == PAD, PAD, remap[safe])


def stream_count_passes(*views, d_bs: int, d_be: int, d_qs: int, d_qe: int) -> torch.Tensor:
    """Sort-free count(*) over cached sorted views (Table.sorted_interval_
    view) — no device sort anywhere.  ``views`` are stream_pass_inputs'.

    Pass u ranks the probe (k, qe) view in the build (k, start) view
    (#{start <= qe}); pass l ranks the probe (k, qs) view in the build
    (k, end) view (#{end < qs}); both in ONE launch (one B2 launch on the
    card).  Returns their difference as an int64 0-d tensor.  Degenerate
    (qs > qe) rows must be pre-excluded."""
    pass_u, pass_l = stream_pass_inputs(*views, d_bs=d_bs, d_be=d_be, d_qs=d_qs, d_qe=d_qe)
    launch, totals = stream_count_launcher(pass_u, pass_l)
    launch()
    return totals[0] - totals[1]


def count_segments(n_u: int, m_u: int, n_l: int, m_l: int) -> tuple:
    """The two segments of a stream count(*) over the slots of
    stream_count_launcher: pass u non-strict into totals[0], pass l strict
    into totals[1], each clamped to its own windows."""

    def seg(base, n, m, strict, total):
        return PairSegment(n, m, a_k=(base, 0), a_v=(base + 1, 0), q_k=(base + 2, 0),
                           q_v=(base + 3, 0), strict=strict, c_lo=(base + 4, 0),
                           n_chunks=(base + 5, 0), total=(12, total))

    return seg(0, n_u, m_u, False, 0), seg(6, n_l, m_l, True, 1)


@functools.lru_cache(maxsize=64)
def _count_plan(n_u: int, m_u: int, n_l: int, m_l: int, device: torch.device) -> PairPlan:
    return plan_pair_segments(count_segments(n_u, m_u, n_l, m_l), device)


def stream_count_launcher(pass_u, pass_l):
    """(launch, totals): ``launch()`` adds both passes' rank sums into the
    int64 ``totals`` [u, l] in one pair-merge launch over the slots
    (a_k, a_v, q_k, q_v, c_lo, n_chunks) of pass u, the same of pass l,
    then totals.  Each launch on the card adds one to
    ``launch.pair_merge``; the bare launch is what a timing of the kernel
    alone should call."""
    slots = []
    for a2, c_lo, n_chunks, q_keys, q_vals in (pass_u, pass_l):
        _check_build(a2)
        slots += [a2[0], a2[1], q_keys, q_vals, c_lo, n_chunks]
    totals = torch.zeros(2, dtype=torch.int64, device=pass_u[3].device)
    plan = _count_plan(pass_u[0].shape[1], pass_u[3].numel(), pass_l[0].shape[1],
                       pass_l[3].numel(), totals.device)
    return segments_launcher(plan, (*slots, totals)), totals


def stream_pass_inputs(
    bk, bs_v, be_k, be_v, qk_s, qe_v, qk_e, qs_v,
    remap_b, remap_q,
    c_lo_u, n_chunks_u, c_lo_l, n_chunks_l,
    *, d_bs: int, d_be: int, d_qs: int, d_qe: int,
):
    """The two passes' stream_rank_sorted arguments (a2, c_lo, n_chunks,
    q_keys, q_vals): order-preserving dictionary codes remapped into the
    joint space, bounds adjusted by the planner's ±lit deltas, PAD rows
    set to each side's sentinel.  Windows (c_lo/n_chunks per query block)
    come from ``host_windows``."""

    def adjust_build(k, v, d):
        # build padding compares as (PAD, PAD): above every probe value
        return torch.where(k == PAD, PAD, v + d)

    def adjust_probe(k, v, d):
        # probe padding compares as (PAD, PAD-1): counts all real build in
        # BOTH rank passes (and no build padding), so it cancels in ub-lb
        return torch.where(k == PAD, PAD - 1, v + d)

    a_u = torch.stack([_remap_keys(bk, remap_b), adjust_build(bk, bs_v, d_bs)])
    a_l = torch.stack([_remap_keys(be_k, remap_b), adjust_build(be_k, be_v, d_be)])
    return (
        (a_u, c_lo_u, n_chunks_u, _remap_keys(qk_s, remap_q), adjust_probe(qk_s, qe_v, d_qe)),
        (a_l, c_lo_l, n_chunks_l, _remap_keys(qk_e, remap_q), adjust_probe(qk_e, qs_v, d_qs)),
    )


def host_windows(bk_h, bv_h, qk_h, qv_h):
    """Per-block chunk windows computed on the host (int64 composites +
    np.searchsorted over the cached host copies) — no device sort."""
    B = np.int64(2**31)
    comp_b = (bk_h.astype(np.int64) << 32) | (bv_h.astype(np.int64) + B)
    firsts = slice(0, None, BLOCK)
    lasts = slice(BLOCK - 1, None, BLOCK)
    comp_qf = (qk_h[firsts].astype(np.int64) << 32) | (qv_h[firsts].astype(np.int64) + B)
    comp_ql = (qk_h[lasts].astype(np.int64) << 32) | (qv_h[lasts].astype(np.int64) + B)
    lo_rank = np.searchsorted(comp_b, comp_qf, side="left")
    hi_rank = np.searchsorted(comp_b, comp_ql, side="right")
    c_lo = (lo_rank // CHUNK).astype(np.int32)
    c_hi = (-((-hi_rank) // CHUNK)).astype(np.int32)
    return c_lo, np.maximum(c_hi - c_lo, 0).astype(np.int32)


def device_windows(a_k, a_v, q_k, q_v):
    """host_windows on the device: int32 (c_lo, n_chunks) of each block of
    BLOCK sorted queries (a multiple of BLOCK of them) in the sorted build,
    from one rank of each block's first and last query."""
    comp_a = composite(a_k, a_v)
    lo_rank = torch.searchsorted(comp_a, composite(q_k[::BLOCK], q_v[::BLOCK]))
    hi_rank = torch.searchsorted(
        comp_a, composite(q_k[BLOCK - 1 :: BLOCK], q_v[BLOCK - 1 :: BLOCK]), right=True
    )
    c_lo = lo_rank // CHUNK
    n_chunks = torch.clamp(-((-hi_rank) // CHUNK) - c_lo, min=0)
    return c_lo.to(torch.int32), n_chunks.to(torch.int32)


def sorted_padded(keys, vals, size: int):
    """(sorted keys, sorted values, order): the (key, value) pairs padded
    with (PAD, PAD) to ``size`` rows and sorted lexicographically;
    ``order[i]`` is the input row of sorted slot i."""
    pad = size - keys.numel()
    fill = torch.full((pad,), PAD, dtype=torch.int32, device=keys.device)
    comp, order = torch.sort(composite(torch.cat([keys, fill]), torch.cat([vals, fill])),
                             stable=True)
    s_k = (comp >> 32).to(torch.int32)
    s_v = ((comp & 0xFFFFFFFF) - 2**31).to(torch.int32)
    return s_k, s_v, order


def rank_lex_stream(build_keys, query_keys, side: str = "left"):
    """Drop-in for ops/ranks.rank_lex_sort on 2-tuple keys through the
    stream kernel: sorts both sides, bounds each block's window with one
    small rank of its first and last query, ranks, and scatters the ranks
    back to query order."""
    bk, bv = build_keys
    qk, qv = query_keys
    n = bk.numel()
    m = qk.numel()
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.int32, device=qk.device)
    a_k, a_v, _ = sorted_padded(bk, bv, -(-n // CHUNK) * CHUNK)
    sk, sv, sidx = sorted_padded(qk, qv, -(-m // BLOCK) * BLOCK)
    ranks_sorted = stream_rank_sorted(
        torch.stack([a_k, a_v]), *device_windows(a_k, a_v, sk, sv), sk, sv,
        strict=side == "left",
    )
    ranks = torch.empty_like(ranks_sorted)
    ranks[sidx] = ranks_sorted
    return ranks[:m]
