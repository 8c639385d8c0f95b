"""Interval-join counts, pair emission and nearest over the level index
(port of sequila_tpu/ops/interval_join.py).

1. ``overlap_bounds`` — for every probe row and every index level, the
   contiguous match run ``[lb, ub)`` via two level-local lexicographic
   ranks.  End-inclusive i32 semantics, exactly as the reference
   (`start <= qe AND end >= qs`).
2. ``count_matches`` — exact per-probe-row overlap counts (the BITS count,
   or its generalization over levels).
3. ``counts_bits_fused`` — the whole count(*) of a resident table pair in
   one pass: remap, two ranks, reduce, plus the number of degenerate probe
   rows that force the caller onto the level path.
4. ``materialize_pairs`` / ``materialize_pairs_from_bounds`` — exact
   (build row, probe row) pairs of a probe chunk, probe-major and
   level-minor, with one of three representations crossing to the host
   (compacted runs, whole bounds, or emitted rows); Lapper's window
   strategy emits from candidate windows of the (key, start)-sorted view.
5. ``nearest_match`` / ``nearest_from_bounds`` — one build row a probe
   row (CoitreesNearest): the first overlap, else the nearer of the
   upstream and downstream neighbours, else -1, read off the per-level
   bounds with canonical tie-breaking.

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

import sys

import numpy as np
import torch

from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.native.loader import expand_runs, repeat_counts
from sequila_tpu_torch.ops.interval_index import IntervalIndex
from sequila_tpu_torch.ops.ranks import composite, rank_lex_sort
from sequila_tpu_torch.utils.metrics import count, span, to_host

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

# Materialization guard: one probe chunk may not emit >= 2^31 pairs (int32
# row indices).  Module constant so regression tests can lower it.
_EMIT_LIMIT = 2**31

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
    return int(to_host(counts.sum(dtype=torch.int64)))


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


# ---------------------------------------------------------------------------
# Pair emission (exact materializing join)
# ---------------------------------------------------------------------------


def pair_offsets(lb, ub):
    """Probe-major exclusive-scan offsets over per-(probe,level) counts.

    Returns (offsets[m*L + 1] int32, lb_pm[m*L]): output slots of probe row i
    occupy [offsets[i*L], offsets[(i+1)*L]) ordered by level then start.
    int32 offsets are exact because callers guard totals by _EMIT_LIMIT.
    """
    counts_pm = torch.clamp(ub - lb, min=0).T.reshape(-1)
    offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=lb.device),
        torch.cumsum(counts_pm, 0, dtype=torch.int32),
    ])
    return offsets, lb.T.reshape(-1)


def emit_pairs(
    offsets, lb_pm, pos, base=0, *, capacity: int, num_levels: int, level_offsets
):
    """Materialize (build_row, probe_row) index pairs into a buffer of
    ``capacity`` slots starting at slot ``base``.

    For output slot j: locate its (probe, level) cell by ranking j in the
    offsets array, then the match is the (j - cell_offset)-th element of the
    cell's contiguous run.  Returns (build_rows, probe_rows, valid) of
    length ``capacity``; slots >= total are masked invalid (-1).
    """
    L = num_levels
    dev = offsets.device
    total = offsets[-1]
    slots = torch.arange(capacity, dtype=torch.int32, device=dev) + base
    flat = torch.searchsorted(offsets, slots, right=True).to(torch.int32) - 1
    flat_c = torch.clamp(flat, 0, lb_pm.numel() - 1).long()
    probe_row = (flat_c // L).to(torch.int32)
    lvl = flat_c % L
    r = slots - offsets[flat_c]
    offs = torch.tensor(level_offsets, dtype=torch.int32, device=dev)
    g = offs[lvl] + lb_pm[flat_c] + r
    build_row = pos[torch.clamp(g, 0, pos.numel() - 1).long()]
    valid = slots < total
    return (
        torch.where(valid, build_row, -1),
        torch.where(valid, probe_row, -1),
        valid,
    )


def sat_sub_i32(qs, max_len):
    """``qs - max(max_len, 0)`` saturated at INT32_MIN, as int32.

    The JAX package saturates a wrapped int32 difference (x64 is off
    there); torch subtracts in int64 and clamps, which gives the same
    values."""
    ml = torch.clamp(torch.as_tensor(max_len, dtype=torch.int64, device=qs.device), min=0)
    return torch.clamp(qs.to(torch.int64) - ml, min=INT32_MIN).to(torch.int32)


def _window_ranks(keys, starts, qk, lo_q, qe):
    """[lb, ub) candidate runs of each query in the (key, start)-sorted
    window view: starts in [lo_q, qe] within the query's key segment."""
    b = composite(keys, starts)
    lb = torch.searchsorted(b, composite(qk, lo_q)).to(torch.int32)
    ub = torch.searchsorted(b, composite(qk, qe), right=True).to(torch.int32)
    return lb, ub


def _emit_window(keys, starts, ends, pos, lo_q, qk, qs, qe, *, capacity: int):
    """Lapper-style max-extension window emission: candidates are the
    contiguous run of starts in [qs - max_len, qe] within the key segment
    (rust-lapper's layered scan idea); an end mask filters the true
    matches — exact for every query shape, including degenerate stabbing.
    ``lo_q`` is the saturated window floor (``sat_sub_i32``).  Returns
    (build_rows, probe_rows, valid) of ``capacity`` slots."""
    lb, ub = _window_ranks(keys, starts, qk, lo_q, qe)
    widths = torch.clamp(ub - lb, min=0)
    dev = keys.device
    offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(widths, 0, dtype=torch.int32),
    ])
    total = offsets[-1]
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    cell = torch.searchsorted(offsets, slots, right=True) - 1
    cell = torch.clamp(cell, 0, qk.numel() - 1)
    r = slots - offsets[cell]
    g = torch.clamp(lb[cell] + r, 0, pos.numel() - 1).long()
    match = (slots < total) & (ends[g] >= qs[cell])
    return (
        torch.where(match, pos[g], -1),
        torch.where(match, cell.to(torch.int32), -1),
        match,
    )


def materialize_pairs_window(index: IntervalIndex, qk, qs, qe):
    """Exact pair materialization via the candidate-window strategy:
    (build_rows, probe_rows) host int32 arrays and their count."""
    keys, starts, ends, pos, max_len = index.window_view
    lo_q = sat_sub_i32(qs, max_len)
    lb, ub = _window_ranks(keys, starts, qk, lo_q, qe)
    # int64: a dense whole-genome window can exceed int32
    total_cand = int(to_host(torch.clamp(ub.to(torch.int64) - lb, min=0).sum()))
    if total_cand == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), 0
    if total_cand >= _EMIT_LIMIT:
        raise ExecutionError(
            f"window emission would scan {total_cand} candidates (>= 2^31); "
            "enable sequila.interval_join_low_memory or reduce the batch"
        )
    b_rows, p_rows, valid = _emit_window(
        keys, starts, ends, pos, lo_q, qk, qs, qe, capacity=total_cand
    )
    b = to_host(b_rows[valid])
    p = to_host(p_rows[valid])
    return b, p, len(b)


def _expand_runs_host(pos_host, g0, cnts, total: int):
    """Expand contiguous runs (global start, length) into build rows.

    Runs arrive probe-major, level-minor; elements ascend within each run —
    the exact order ``emit_pairs`` produces — so the emission strategies
    are interchangeable bit-for-bit.  The C path is one linear pass of
    memcpys; the NumPy fallback stays all-int32 (total < 2^31 by the
    caller guard)."""
    out = expand_runs(g0, cnts, pos_host, total)
    if out is not None:
        return out
    run_end = np.cumsum(cnts, dtype=np.int32)
    g = np.repeat(g0 - run_end + cnts, cnts)
    g += np.arange(total, dtype=np.int32)
    return pos_host[g]


def _expand_bounds_host(index: IntervalIndex, lbh, ubh, total: int):
    """Expand per-(probe,level) [L, m] host bounds into build rows.

    Empty (probe,level) cells — most of them — are filtered before the
    repeats."""
    offs = np.asarray(index.level_offsets, dtype=np.int32)
    cnts_flat = np.maximum(ubh - lbh, 0).T.ravel()
    nz = cnts_flat.nonzero()[0]
    g0 = (lbh + offs[:, None]).T.ravel()[nz]  # global run start per cell
    return _expand_runs_host(index.pos_host, g0, cnts_flat[nz], total)


def _counts_and_nnz(lb, ub):
    """Per-probe counts with the nonzero-cell count and the max run length
    appended — one packed int32 array, so the sizing and packing decisions
    cost a single fetch."""
    c = torch.clamp(ub - lb, min=0)
    counts = c.sum(0, dtype=torch.int32)
    nnz = (c > 0).sum().to(torch.int32)
    maxrun = c.max() if c.numel() else torch.zeros((), dtype=torch.int32, device=c.device)
    return torch.cat([counts, nnz[None], maxrun[None].to(torch.int32)])


def _compact_runs(lb, ub, *, capacity: int, level_offsets, pack16: bool):
    """Compact the nonzero (probe,level) cells of [L, m] bounds into ONE
    array — ``capacity`` run starts followed by the run lengths —
    probe-major order preserved.  With ``pack16`` (every run shorter than
    2^16; ``capacity`` even) two lengths share an int32 lane, lo | hi << 16.

    Empty cells, and cells past ``capacity``, scatter into one extra slot
    that is cut off: torch has no dropping scatter, and an out-of-range
    index would fault the device."""
    offs = torch.tensor(level_offsets, dtype=torch.int32, device=lb.device)[:, None]
    cnts_pm = torch.clamp(ub - lb, min=0).T.reshape(-1)
    g0_pm = (lb + offs).T.reshape(-1)
    nz = cnts_pm > 0
    pos = torch.cumsum(nz, 0, dtype=torch.int32) - 1
    idx = torch.where(nz & (pos < capacity), pos, capacity).long()

    def scatter(vals):
        out = torch.zeros(capacity + 1, dtype=torch.int32, device=lb.device)
        return out.scatter_(0, idx, vals)[:capacity]

    out_g = scatter(g0_pm)
    out_c = scatter(cnts_pm)
    if pack16:
        out_c = out_c[0::2] | (out_c[1::2] << 16)
    return torch.cat([out_g, out_c])


def _unpack16(packed: np.ndarray, nnz: int) -> np.ndarray:
    """First ``nnz`` uint16 lanes of an int32 array packed as lo | hi<<16.

    The uint16 view is a zero-copy unpack on a little-endian host; a
    big-endian host takes the explicit mask-and-interleave path."""
    if sys.byteorder == "little":
        return packed.view(np.uint16)[:nnz]
    out = np.empty(2 * len(packed), np.int32)
    out[0::2] = packed & 0xFFFF
    out[1::2] = (packed >> 16) & 0xFFFF
    return out[:nnz]


def _probe_ids(counts, total: int):
    """RLE-expand per-probe match counts into probe row ids (the reference
    expands the probe side host-side too, interval_join.rs:1593-1617)."""
    p = repeat_counts(counts, total)
    if p is None:
        p = np.repeat(np.arange(len(counts), dtype=np.int32), counts.astype(np.int64))
    return p


def _to_host_async(t: torch.Tensor):
    """Start a copy of ``t`` to the host and return a function that waits
    for it and gives the copy as a numpy array: the pinned buffer may be
    read only after the copy's event."""
    if t.device.type == "cpu":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))

    def wait() -> np.ndarray:
        with span("device_wait", bytes=host.numel() * host.element_size()):
            event.synchronize()
        count("d2h_bytes", host.numel() * host.element_size())
        return host.numpy()

    return wait


def emission_strategy(total: int, nnz: int, num_levels: int, m: int) -> str:
    """Which representation of the pairs crosses to the host: 'runs' (the
    compacted nonzero cells) when they are fewer than half the pairs and
    the cells, 'bounds' (the whole [L, m] lb/ub) when the cells are fewer
    than half the pairs, else 'emit' (the build rows themselves)."""
    cells = 2 * num_levels * m
    if 2 * nnz < min(total, cells):
        return "runs"
    if cells < total:
        return "bounds"
    return "emit"


def materialize_pairs(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Full exact join of one probe chunk: host int32 (build_rows,
    probe_rows) and their count, by the algorithm's rank strategy."""
    if method == "window":
        return materialize_pairs_window(index, qk, qs, qe)
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return materialize_pairs_from_bounds(index, lb, ub)


def materialize_pairs_from_bounds(index: IntervalIndex, lb, ub):
    """Exact join from per-(probe,level) device bounds [L, m].

    One fetch brings the per-probe counts (plus nnz and the longest run);
    the probe side is RLE-expanded on the host, overlapping the transfer of
    the build side's representation, which ``emission_strategy`` picks
    ('runs', 'bounds' or 'emit').  Every strategy yields the same rows in
    the same order: probe-major, level-minor, ascending within a run.  The
    JAX package sizes buffers to XLA buckets; the port sizes them exactly."""
    packed = to_host(_counts_and_nnz(lb, ub))
    counts, nnz, maxrun = packed[:-2], int(packed[-2]), int(packed[-1])
    total = int(counts.astype(np.int64).sum())
    if total >= _EMIT_LIMIT:
        raise ExecutionError(
            f"probe chunk would materialize {total} pairs (>= 2^31); "
            "enable sequila.interval_join_low_memory or reduce the batch"
        )
    if total == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32), 0
    L, m = lb.shape
    strategy = emission_strategy(total, nnz, L, m)
    if strategy == "runs":
        cap = nnz + (nnz & 1)  # pack16 pairs lanes
        pack16 = maxrun < (1 << 16)
        wait = _to_host_async(_compact_runs(
            lb, ub, capacity=cap, level_offsets=index.level_offsets, pack16=pack16,
        ))
        p = _probe_ids(counts, total)  # overlaps the transfer
        runs = wait()
        cnt = _unpack16(runs[cap:], nnz) if pack16 else runs[cap : cap + nnz]
        return _expand_runs_host(index.pos_host, runs[:nnz], cnt, total), p, total
    if strategy == "bounds":
        wait = _to_host_async(torch.cat([lb, ub]))
        p = _probe_ids(counts, total)
        bounds = wait()
        return _expand_bounds_host(index, bounds[:L], bounds[L:], total), p, total
    offsets, lb_pm = pair_offsets(lb, ub)
    build_rows, _, _ = emit_pairs(
        offsets, lb_pm, index.pos, capacity=total,
        num_levels=index.num_levels, level_offsets=index.level_offsets,
    )
    return to_host(build_rows), _probe_ids(counts, total), total


# ---------------------------------------------------------------------------
# Nearest (CoitreesNearest semantics)
# ---------------------------------------------------------------------------


def _lexmin3(mask, a, b, c):
    """Masked lexicographic (a, b, c) minimum over axis 0.

    Returns (m_a, m_c): the winning a-value and the winner's c-value (the
    row payload).  Empty columns yield (INT32_MAX, INT32_MAX)."""
    m_a = torch.where(mask, a, INT32_MAX).amin(0)
    m2 = mask & (a == m_a)
    m_b = torch.where(m2, b, INT32_MAX).amin(0)
    m3 = m2 & (b == m_b)
    return m_a, torch.where(m3, c, INT32_MAX).amin(0)


def _lexmax3(mask, a, b, c):
    """Masked lexicographic (a, b, c) maximum over axis 0 (see _lexmin3);
    empty columns yield (INT32_MIN, INT32_MIN)."""
    m_a = torch.where(mask, a, INT32_MIN).amax(0)
    m2 = mask & (a == m_a)
    m_b = torch.where(m2, b, INT32_MIN).amax(0)
    m3 = m2 & (b == m_b)
    return m_a, torch.where(m3, c, INT32_MIN).amax(0)


def _distance(any_cand, raw):
    """The JAX package's int32 distance: its subtraction wraps, and a
    wrapped (non-positive) distance becomes INT32_MAX, which makes it
    min(true distance, INT32_MAX).  ``raw`` is the true int64 distance,
    positive wherever ``any_cand`` holds."""
    return torch.where(any_cand, raw.clamp(max=INT32_MAX), INT32_MAX)


def nearest_from_bounds(lb, ub, levels, keys, starts, ends, pos, qk, qs, qe, *,
                        level_offsets, level_pad):
    """One build row per probe row: first overlap, else true nearest, else -1.

    Distance convention of the reference (interval_join.rs:909-956):
    ``candidate.start - qe`` downstream, ``qs - candidate.end`` upstream;
    ties prefer the upstream candidate.  Tie-breaking is canonical, shared
    with the host indexes:

    - overlap pick: the overlapping row minimizing (start, end, row)
    - upstream tie (equal max end < qs): maximize (end, start, row)
    - downstream tie (equal min start > qe): minimize (start, end, row)

    Within a level (start-sorted, monotone ends) the run boundary entry is
    the level's lexicographic extreme, so a masked min or max over the
    level axis gives the global pick.  Distances saturate at INT32_MAX as
    in the JAX package (see _distance), so two candidates both at least
    2^31 - 1 away tie and the upstream one wins; where only a downstream
    candidate that far exists, the upstream payload INT32_MIN wins the tie
    and the row reads as no match, also as in the JAX package.  Port of
    sequila_tpu/ops/interval_join.py:654 (an XLA program, not Pallas):
    gathers over the level view and masked reductions, plain torch ops."""
    L, m = lb.shape
    dev = lb.device
    offs = torch.tensor(level_offsets, dtype=torch.int64, device=dev)[:, None]
    pads = torch.tensor(level_pad, dtype=torch.int64, device=dev)[:, None]
    lvl_ids = torch.arange(L, dtype=torch.int32, device=dev)[:, None]
    last = pos.numel() - 1
    lb64, ub64 = lb.to(torch.int64), ub.to(torch.int64)
    counts = (ub - lb).clamp(min=0)
    ov_ok = counts > 0

    # overlap pick: each level's first overlapping entry (at lb) is the
    # level's (start, end, row) minimum
    g = (offs + lb64).clamp(0, last)
    _, overlap_pos = _lexmin3(ov_ok, starts[g], ends[g], pos[g])

    # upstream: the last entry of the level's key run with end < qs is the
    # level's (end, start, row) maximum among upstream entries
    g = (offs + lb64 - 1).clamp(0, last)
    left_ok = (lb > 0) & (keys[g] == qk) & (levels[g] == lvl_ids)
    left_end, left_pos = _lexmax3(left_ok, ends[g], starts[g], pos[g])
    left_any = left_ok.any(0)
    left_dist = _distance(left_any, qs.to(torch.int64) - left_end)

    # downstream: the first entry with start > qe is the level's (start,
    # end, row) minimum among downstream entries.  ub equals the level's
    # padded size when the level is bucket-full; the read would land on
    # the next level, so the pad mask drops it
    g = (offs + ub64).clamp(0, last)
    right_ok = (ub64 < pads) & (keys[g] == qk) & (levels[g] == lvl_ids)
    right_start, right_pos = _lexmin3(right_ok, starts[g], ends[g], pos[g])
    right_any = right_ok.any(0)
    right_dist = _distance(right_any, right_start.to(torch.int64) - qe)

    best_pos = torch.where(left_dist <= right_dist, left_pos, right_pos)
    return torch.where(
        ov_ok.any(0), overlap_pos, torch.where(left_any | right_any, best_pos, -1)
    ).to(torch.int32)


def nearest_match(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Nearest build row (or -1) of each probe row: ``overlap_bounds`` by
    the algorithm's rank strategy, then ``nearest_from_bounds``."""
    lb, ub = overlap_bounds(index, qk, qs, qe, method)
    return nearest_from_bounds(
        lb, ub, index.levels, index.keys, index.starts, index.ends, index.pos,
        qk, qs, qe, level_offsets=index.level_offsets, level_pad=index.level_pad,
    )
