"""Interval-join counts over the level index (port of the count half of
sequila_tpu/ops/interval_join.py).

1. ``overlap_bounds`` — for every probe row and every index level, the
   contiguous match run ``[lb, ub)`` via two level-local lexicographic
   ranks.  End-inclusive i32 semantics, exactly as the reference
   (`start <= qe AND end >= qs`).
2. ``count_matches`` — exact per-probe-row overlap counts (the BITS count,
   or its generalization over levels).
3. ``counts_bits_fused`` — the whole count(*) of a resident table pair in
   one pass: remap, two ranks, reduce, plus the number of degenerate probe
   rows that force the caller onto the level path.

These were XLA programs in the JAX package, not Pallas kernels, and are
plain torch ops here.  Two strategies of the JAX package become:
- 'sort' (the co-sort): per level, one ``torch.searchsorted`` of int64
  ``(key, value)`` composites over that level's contiguous slice — a
  (level, key, value) triple does not fit 64 bits, but each level slice is
  sorted by (key, value) on its own (the level invariant);
- 'bsearch': the JAX package's fixed-step vectorized binary search with
  gathers, step for step.
JAX's int32-only reductions (64-bucket partials) are int64 sums here.
"""

from __future__ import annotations

import numpy as np
import torch

from sequila_tpu_torch.ops.interval_index import IntervalIndex
from sequila_tpu_torch.ops.ranks import composite, rank_lex_sort

# ---------------------------------------------------------------------------
# Bounds (lb, ub) per level
# ---------------------------------------------------------------------------


def _level_slices(level_offsets, total: int):
    ends = list(level_offsets[1:]) + [total]
    return list(zip(level_offsets, ends))


def level_ranks(
    levels, keys, vals, qk, qv, *, num_levels: int, level_offsets, side: str
):
    """Per-level, level-local rank of (key, value) tuples.

    Returns [num_levels, m] int32: for each probe and level, the number of
    level entries with (key, val) lexicographically < (side='left') or <=
    (side='right') the query.  ``levels`` is accepted for signature parity:
    the level structure is implied by the offsets."""
    del levels
    q = composite(qk, qv)
    right = side == "right"
    out = torch.empty((num_levels, qk.numel()), dtype=torch.int32, device=qk.device)
    for lv, (lo, hi) in enumerate(_level_slices(level_offsets, keys.numel())):
        b = composite(keys[lo:hi], vals[lo:hi])
        out[lv] = torch.searchsorted(b, q, right=right).to(torch.int32)
    return out


def _bounds_sort(
    levels, keys, starts, ends, qk, qs, qe, *, num_levels: int, level_offsets
):
    """Rank strategy of the Coitrees/SuperIntervals algorithms."""
    ub = level_ranks(
        levels, keys, starts, qk, qe,
        num_levels=num_levels, level_offsets=level_offsets, side="right",
    )
    lb = level_ranks(
        levels, keys, ends, qk, qs,
        num_levels=num_levels, level_offsets=level_offsets, side="left",
    )
    return lb, ub


def _level_bsearch_one(keys, vals, qk, q, *, off, pad, strict_less):
    """Level-local rank of (qk, q) in one level's (key, val) slice via
    vectorized binary search — the shared primitive of _bounds_bsearch
    and level_ranks_bsearch."""
    steps = max(1, int(np.ceil(np.log2(pad + 1))))
    lo = torch.zeros_like(qk)
    hi = torch.full_like(qk, pad)
    for _ in range(steps):
        mid = (lo + hi) // 2
        at = (off + torch.clamp(mid, max=pad - 1)).to(torch.int64)
        km = keys[at]
        vm = vals[at]
        if strict_less:  # count entries with (key, val) < (qk, q)
            less = (km < qk) | ((km == qk) & (vm < q))
        else:  # count entries with (key, val) <= (qk, q)
            less = (km < qk) | ((km == qk) & (vm <= q))
        # once lo == hi the search has converged: stop updating (the
        # fixed-step loop would otherwise probe index == pad, reading the
        # next level and overcounting)
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def level_ranks_bsearch(
    levels, keys, vals, qk, qv, *, side: str, num_levels: int, level_pad,
    level_offsets,
):
    """level_ranks by per-level vectorized binary search: the same
    [num_levels, m] level-local ranks."""
    del levels
    return torch.stack([
        _level_bsearch_one(
            keys, vals, qk, qv,
            off=level_offsets[lv], pad=level_pad[lv], strict_less=side == "left",
        )
        for lv in range(num_levels)
    ])


def _bounds_bsearch(
    levels, keys, starts, ends, qk, qs, qe, *, num_levels: int, level_pad, level_offsets
):
    """Rank strategy of the IntervalTree/ArrayIntervalTree algorithms."""
    lbs, ubs = [], []
    for lv in range(num_levels):
        off = level_offsets[lv]
        pad = level_pad[lv]
        ubs.append(
            _level_bsearch_one(keys, starts, qk, qe, off=off, pad=pad, strict_less=False)
        )
        lbs.append(
            _level_bsearch_one(keys, ends, qk, qs, off=off, pad=pad, strict_less=True)
        )
    return torch.stack(lbs), torch.stack(ubs)


def overlap_bounds(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Per-level contiguous match runs [lb, ub) for each probe row.

    Returns (lb, ub), each int32 of shape [num_levels, m], level-local.
    Every method but 'bsearch' (including Lapper's 'window') ranks by
    the 'sort' strategy, as in the JAX package.
    """
    if method == "bsearch":
        return _bounds_bsearch(
            index.levels, index.keys, index.starts, index.ends, qk, qs, qe,
            num_levels=index.num_levels,
            level_pad=index.level_pad,
            level_offsets=index.level_offsets,
        )
    return _bounds_sort(
        index.levels, index.keys, index.starts, index.ends, qk, qs, qe,
        num_levels=index.num_levels,
        level_offsets=index.level_offsets,
    )


def counts_from_bounds(lb, ub):
    """Exact per-probe-row match counts; degenerate (qe < qs-1) rows clip to 0."""
    return torch.clamp(ub - lb, min=0).sum(dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


def _sum_ranks(bk, bv, qk, qv, side: str) -> torch.Tensor:
    """int64 sum over all queries of their rank among the build tuples —
    count(*) needs no per-query attribution.  Replaces the JAX package's
    _sum_rank_partials (64 int32 bucket partials of a co-sort)."""
    b = torch.sort(composite(bk, bv)).values
    return torch.searchsorted(b, composite(qk, qv), right=side == "right").sum()


def counts_bits_fused(lk, ls, le, rk, rs, re, remap_l, remap_r):
    """Whole count(*) interval join in one pass over resident columns:
    remap per-table dictionary codes into the shared key space (tiny
    gathers), two lexicographic ranks, reduce.

    Returns an int64 tensor [total, num_degenerate].  The total sums
    #{start <= qe} - #{end < qs} over every probe row, exact when
    num_degenerate == 0; degenerate (qs > qe) probe rows can still match
    (stabbing), so a non-zero second entry tells the caller to re-run via
    the exact level path.  The JAX package pads both sides to bucket sizes
    (pad probes cancel in the two sums); the port needs no padding.
    """
    bk = remap_l[lk.to(torch.int64)]
    qk = remap_r[rk.to(torch.int64)]
    pu = _sum_ranks(bk, ls, qk, re, side="right")
    pl = _sum_ranks(bk, le, qk, rs, side="left")
    n_deg = (rs > re).sum()
    return torch.stack([pu - pl, n_deg])


def total_count_i64(counts) -> int:
    """Host-side exact int64 total of a device counts vector (the JAX
    package's int32 bucket sums and their build-size guard are gone)."""
    return int(counts.sum(dtype=torch.int64))


def _counts_bits(bs_keys, bs_starts, be_keys, be_ends, qk, qs, qe):
    """BITS count: `#start<=qe - #end<qs` per key segment (Layer & Quinlan
    2012) over two independently ranked arrays — no level structure, two
    rank ops total.  EXACT only for qs <= qe; degenerate rows are zeroed
    here and must be routed to the level-based path by the caller."""
    ub = rank_lex_sort((bs_keys, bs_starts), (qk, qe), side="right")
    lb = rank_lex_sort((be_keys, be_ends), (qk, qs), side="left")
    return torch.where(qs <= qe, ub - lb, 0).to(torch.int32)


def count_matches(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Exact per-probe-row match counts (int32).

    method='bits' uses the 2-rank BITS count; it silently zeroes
    degenerate (qs > qe) rows, so callers must pre-check (the join
    operator does).  Other methods go through the level decomposition and
    are exact for every input.
    """
    if method == "bits":
        return _counts_bits(
            index.bs_keys, index.bs_starts, index.be_keys, index.be_ends,
            qk, qs, qe,
        )
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return counts_from_bounds(lb, ub)
