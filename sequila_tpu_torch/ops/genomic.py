"""Genomic interval operators beyond the join: coverage, depth, merge,
complement, closest-k.

These cover the reference's vendored superintervals API surface
(reference superintervals/src/superintervals.rs: `count`, `coverage`
:802-822, `search_*`) and the operators its sandbox planned but never
landed (`sandbox/closest.md`, `sandbox/complement.md` are zero-byte
placeholders — SURVEY.md §2 item 23).

Coordinate convention: end-inclusive i32 intervals, matching the join.
`coverage` reproduces the superintervals formula exactly:
``(count, sum(min(end_i, qe) - max(start_i, qs)))``.

Execution model: `coverage` runs its rank batches as torch ops on the
index's device through the same BITS/level machinery as the join (four
``rank_lex_sort`` ranks and the int64 finish where the ranks are, or four
``level_ranks`` for degenerate probes and inverted builds); the
event-scan and windowed operators in this module (depth, merge,
complement, subtract, closest_k) are vectorized host pipelines —
sort/searchsorted/scan with no per-row Python loops — because their
outputs are host-consumed tables.  The two hot primitives route through
the threaded native kernels when available (`si_argsort64`: parallel LSD
radix over order-preserving int64 composites, ~3.5x numpy's lexsort;
`si_searchsorted64`: threaded binary searches, ~2-5x), with numpy
fallbacks preserving identical results.

Port of sequila_tpu/ops/genomic.py: the NumPy verbs are its copies; its
device programs (XLA in the JAX package, not Pallas) are torch ops here.
"""

from __future__ import annotations

import numpy as np
import torch

from sequila_tpu_torch.ops.interval_index import IntervalIndex, build_interval_index

_B31 = np.int64(2**31)


def _comp_kv(keys, vals):
    """Order-preserving (key, value) int64 composite for int32 inputs."""
    return (keys.astype(np.int64) << 32) | (vals.astype(np.int64) + _B31)


def _argsort_comp(comp: np.ndarray) -> np.ndarray:
    """Stable argsort of an int64 composite: threaded native radix when
    available (10x numpy at 1M rows), else numpy stable sort."""
    from sequila_tpu_torch.native.loader import argsort64

    order = argsort64(comp)
    if order is not None:
        return order
    return np.argsort(comp, kind="stable")


def _searchsorted_comp(sorted_comp, q, side="left") -> np.ndarray:
    """searchsorted over int64 composites: threaded native when available."""
    from sequila_tpu_torch.native.loader import searchsorted64

    out = searchsorted64(sorted_comp, q, side)
    if out is not None:
        return out
    return np.searchsorted(sorted_comp, q, side=side)


# ---------------------------------------------------------------------------
# Depth (pileup) — event diff + scan
# ---------------------------------------------------------------------------


def depth_events(keys: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Per-base depth as run-length segments.

    Returns (keys, pos_start, pos_end, depth) arrays of runs where the
    depth is constant; runs cover [min start, max end] per key.  Classic
    event-list pipeline: +1 at start, -1 at end+1, sort, prefix-sum —
    the depth between consecutive event positions.  Cross-key carry is
    naturally zero because each key's deltas cancel.
    """
    n = len(keys)
    if n == 0:
        z = np.empty(0, np.int32)
        return z, z, z, z
    ev_key = np.concatenate([keys, keys])
    ev_pos = np.concatenate([starts, ends.astype(np.int64) + 1]).astype(np.int64)
    ev_delta = np.concatenate(
        [np.ones(n, np.int32), -np.ones(n, np.int32)]
    )
    if int(ev_pos.max()) < 2**31:
        # intra-(key,pos) order is immaterial: depth is read at the LAST
        # event of each (key,pos) group, where the running sum is the
        # same whichever way the group's deltas were ordered — so the
        # delta tiebreak can be dropped and the sort runs on one
        # composite via the threaded native radix
        order = _argsort_comp(_comp_kv(ev_key, ev_pos))
    else:
        # end+1 == 2^31 would overflow the composite's value field
        order = np.lexsort((ev_delta, ev_pos, ev_key))
    k, p, d = ev_key[order], ev_pos[order], ev_delta[order]
    depth = np.cumsum(d)
    # run boundaries: last event at each (key, pos)
    last = np.ones(len(k), bool)
    last[:-1] = (k[:-1] != k[1:]) | (p[:-1] != p[1:])
    rk, rp, rd = k[last], p[last], depth[last]
    # each run spans [pos_i, pos_{i+1}-1] within its key
    same_key = np.zeros(len(rk), bool)
    same_key[:-1] = rk[:-1] == rk[1:]
    out_k = rk[same_key]
    out_s = rp[same_key]
    nxt = np.roll(rp, -1)
    out_e = (nxt[same_key] - 1).astype(np.int64)
    out_d = rd[same_key]
    return (
        out_k.astype(np.int32),
        out_s.astype(np.int32),
        out_e.astype(np.int32),
        out_d.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Merge / complement — cummax scan
# ---------------------------------------------------------------------------


def merge_intervals(keys, starts, ends, min_dist: int = 0):
    """Union of intervals per key (intervals closer than ``min_dist`` are
    joined).  Returns (keys, starts, ends) of the merged runs."""
    n = len(keys)
    if n == 0:
        z = np.empty(0, np.int32)
        return z, z, z
    order = _argsort_comp(_comp_kv(keys, starts))
    k, s, e = keys[order], starts[order], ends[order]
    # running max end per key via int64 composite (key dominates)
    comp = (k.astype(np.int64) << 32) | (e.astype(np.int64) + 2**31)
    cummax = np.maximum.accumulate(comp)
    prev_end = (np.roll(cummax, 1) & 0xFFFFFFFF).astype(np.int64) - 2**31
    prev_key = (np.roll(cummax, 1) >> 32).astype(np.int64)
    new_run = np.ones(n, bool)
    # end-inclusive adjacency: [1,5] and [6,10] are one contiguous run
    new_run[1:] = (k[1:].astype(np.int64) != prev_key[1:]) | (
        s[1:].astype(np.int64) > prev_end[1:] + 1 + min_dist
    )
    run_starts = np.nonzero(new_run)[0]
    out_k = k[new_run]
    out_s = s[new_run]
    out_e = np.maximum.reduceat(e.astype(np.int64), run_starts)
    return out_k.astype(np.int32), out_s.astype(np.int32), out_e.astype(np.int32)


def cluster_intervals(keys, starts, ends, min_dist: int = 0):
    """Cluster id per input row (bedtools cluster): rows whose intervals
    chain into one merged run (gaps <= min_dist) share an id; ids are
    dense, ordered by (key, run start).  Returns int64 [n] aligned with
    the INPUT row order — one vectorized pass over the merge machinery."""
    keys = np.asarray(keys)
    starts = np.asarray(starts)
    ends = np.asarray(ends)
    n = len(keys)
    if n == 0:
        return np.empty(0, np.int64)
    order = _argsort_comp(_comp_kv(keys, starts))
    k, s, e = keys[order], starts[order], ends[order]
    comp = (k.astype(np.int64) << 32) | (e.astype(np.int64) + 2**31)
    cummax = np.maximum.accumulate(comp)
    prev_end = (np.roll(cummax, 1) & 0xFFFFFFFF).astype(np.int64) - 2**31
    prev_key = (np.roll(cummax, 1) >> 32).astype(np.int64)
    new_run = np.ones(n, bool)
    new_run[1:] = (k[1:].astype(np.int64) != prev_key[1:]) | (
        s[1:].astype(np.int64) > prev_end[1:] + 1 + min_dist
    )
    cid_sorted = np.cumsum(new_run) - 1
    out = np.empty(n, np.int64)
    out[order] = cid_sorted
    return out


def complement_intervals(keys, starts, ends, key_sizes: dict[int, tuple[int, int]], merged=None):
    """Gaps of the merged intervals per key within [lo, hi] bounds.

    ``key_sizes[k] = (lo, hi)`` gives each key's domain (chromosome span,
    end-inclusive); ``merged`` optionally passes precomputed
    merge_intervals(keys, starts, ends) runs (the dataframe verb caches
    them per table — chrom_sizes change between calls, the merge does
    not).  Keys present in key_sizes but absent from the data
    yield their full span.  Direct gap scan over the merged runs (they
    are disjoint and (key, start)-sorted): each gap is the stretch
    between consecutive same-key runs, plus the head/tail pieces against
    the domain bounds — one vectorized pass, no per-key loop."""
    items = sorted(key_sizes.items())
    dk = np.asarray([k for k, _ in items], np.int64)
    dlo = np.asarray([lo for _, (lo, _) in items], np.int64)
    dhi = np.asarray([hi for _, (_, hi) in items], np.int64)
    keep = dhi >= dlo
    dk, dlo, dhi = dk[keep], dlo[keep], dhi[keep]
    if len(dk) == 0:
        z = np.empty(0, np.int32)
        return z, z, z
    if merged is not None:
        mk, ms, me = merged
    else:
        mk, ms, me = merge_intervals(
            np.asarray(keys), np.asarray(starts), np.asarray(ends)
        )
    # restrict runs to keys with a domain, clipped to the domain span
    pos = np.searchsorted(dk, mk.astype(np.int64))
    in_dom = (pos < len(dk)) & (dk[np.minimum(pos, len(dk) - 1)] == mk)
    mk, ms64, me64, pos = (
        mk[in_dom],
        ms[in_dom].astype(np.int64),
        me[in_dom].astype(np.int64),
        pos[in_dom],
    )
    ms64 = np.maximum(ms64, dlo[pos])
    me64 = np.minimum(me64, dhi[pos])
    live = ms64 <= me64
    mk, ms64, me64, pos = mk[live], ms64[live], me64[live], pos[live]

    out_k, out_s, out_e = [], [], []
    # head piece per domain: [lo, first_start-1]; tail: [last_end+1, hi];
    # inner gaps between consecutive same-key runs
    first = np.ones(len(mk), bool)
    first[1:] = mk[1:] != mk[:-1]
    lastm = np.ones(len(mk), bool)
    lastm[:-1] = mk[:-1] != mk[1:]
    # inner gaps
    gap_ok = np.zeros(len(mk), bool)
    gap_ok[:-1] = ~lastm[:-1] & (ms64[1:] > me64[:-1] + 1)
    gi = np.nonzero(gap_ok)[0]
    out_k.append(mk[gi])
    out_s.append(me64[gi] + 1)
    out_e.append(ms64[gi + 1] - 1)
    # head pieces
    hi_ = np.nonzero(first & (ms64 > dlo[pos]))[0]
    out_k.append(mk[hi_])
    out_s.append(dlo[pos[hi_]])
    out_e.append(ms64[hi_] - 1)
    # tail pieces
    ti = np.nonzero(lastm & (me64 < dhi[pos]))[0]
    out_k.append(mk[ti])
    out_s.append(me64[ti] + 1)
    out_e.append(dhi[pos[ti]])
    # domains with no runs at all: full span
    covered = np.zeros(len(dk), bool)
    covered[pos] = True
    ei = np.nonzero(~covered)[0]
    out_k.append(dk[ei].astype(np.int32))
    out_s.append(dlo[ei])
    out_e.append(dhi[ei])

    ok = np.concatenate(out_k).astype(np.int64)
    os_ = np.concatenate(out_s)
    oe = np.concatenate(out_e)
    order = np.lexsort((os_, ok))
    return (
        ok[order].astype(np.int32),
        os_[order].astype(np.int32),
        oe[order].astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Coverage (superintervals semantics) and closest-k
# ---------------------------------------------------------------------------


def merged_subtrahend(bk, bs, be):
    """(key,start)-sorted merged runs of the b side + their composites —
    the b-only half of ``subtract_intervals``, split out so repeated
    subtracts against the same b table (the dataframe pair cache) skip
    the merge + sort + composite construction."""
    mk, ms, me = merge_intervals(np.asarray(bk), np.asarray(bs), np.asarray(be))
    if len(mk) == 0:
        return mk, ms, me, None, None
    order = _argsort_comp(_comp_kv(mk, ms))
    mk, ms, me = mk[order], ms[order], me[order]
    B = np.int64(2**31)
    comp_ms = (mk.astype(np.int64) << 32) | (ms.astype(np.int64) + B)
    comp_me = (mk.astype(np.int64) << 32) | (me.astype(np.int64) + B)
    return mk, ms, me, comp_ms, comp_me


def subtract_intervals(ak, as_, ae, bk, bs, be, merged=None):
    """Per a-interval: the sub-ranges not covered by any b interval
    (bedtools subtract).  Merge b, then cut each a against the merged
    runs overlapping it.

    Fully vectorized: merged runs are disjoint and per-key sorted, so
    per key both starts AND ends ascend and the runs overlapping
    ``[as, ae]`` are one contiguous window found with two composite
    searches; every gap is then one of (a) the stretch before each
    window run, computed pairwise over the expanded (a-row, run) pairs,
    or (b) the tail after a row's last run — no per-row Python.
    ``merged`` optionally passes a precomputed ``merged_subtrahend``."""
    ak = np.asarray(ak, np.int32)
    as_ = np.asarray(as_, np.int32)
    ae = np.asarray(ae, np.int32)
    mk, ms, me, comp_ms, comp_me = (
        merged if merged is not None else merged_subtrahend(bk, bs, be)
    )
    if len(mk) == 0:  # nothing to subtract: every a row survives whole
        return ak.copy(), as_.copy(), ae.copy()
    if comp_ms is not None:
        # threaded native gap emission — no pair expansion, no final sort
        # (bit-identical values and order vs the NumPy path below)
        from sequila_tpu_torch.native.loader import subtract_runs

        res = subtract_runs(comp_ms, comp_me, ms, me, ak, as_, ae)
        if res is not None:
            return res
    B = np.int64(2**31)
    ak64 = ak.astype(np.int64)
    lo_all = _searchsorted_comp(comp_me, (ak64 << 32) | (as_.astype(np.int64) + B), side="left")
    hi_all = _searchsorted_comp(comp_ms, (ak64 << 32) | (ae.astype(np.int64) + B), side="right")
    widths = np.maximum(hi_all - lo_all, 0)
    total = int(widths.sum())
    m = len(ak)
    # (a-row, run) pair expansion — the native threaded RLE/run kernels
    # when available (same kernels as the join's emit path)
    from sequila_tpu_torch.native.loader import expand_runs, repeat_counts

    pair_i = pair_j = None
    if total >= (1 << 15) and total < 2**31 and len(mk) < 2**31:
        w32 = widths.astype(np.int32)
        pair_i = repeat_counts(w32, total)
        pair_j = expand_runs(
            lo_all.astype(np.int32), w32,
            np.arange(len(mk), dtype=np.int32), total,
        )
    if pair_i is None or pair_j is None:
        pair_i = np.repeat(np.arange(m, dtype=np.int64), widths)
        offs = np.concatenate([[0], np.cumsum(widths)])
        pair_j = (
            np.arange(total, dtype=np.int64)
            - np.repeat(offs[:-1], widths)
            + np.repeat(lo_all, widths)
        )
    # gap before run j: [prev_end+1, ms[j]-1] where prev_end is the
    # previous window run's end (or as_-1 for the first); window runs all
    # have me >= as_, so gap starts never fall below as_
    first = pair_j == lo_all[pair_i]
    prev_end = np.where(
        first,
        as_[pair_i].astype(np.int64) - 1,
        me[np.maximum(pair_j - 1, 0)].astype(np.int64),
    )
    gap_s = prev_end + 1
    gap_e = ms[pair_j].astype(np.int64) - 1
    keep = gap_e >= gap_s
    # tail gap after the last window run: [me[last]+1, ae]
    has = widths > 0
    last_j = hi_all - 1
    tail_s = np.where(
        has, me[np.maximum(last_j, 0)].astype(np.int64) + 1, as_.astype(np.int64)
    )
    tail_e = ae.astype(np.int64)
    tail_keep = tail_s <= tail_e
    out_k = np.concatenate([ak[pair_i[keep]], ak[tail_keep]])
    out_s = np.concatenate([gap_s[keep], tail_s[tail_keep]])
    out_e = np.concatenate([gap_e[keep], tail_e[tail_keep]])
    # restore per-a-row emission order (gaps ascending within each a row)
    out_row = np.concatenate(
        [pair_i[keep].astype(np.int64), np.nonzero(tail_keep)[0]]
    )
    final = _argsort_comp((out_row << 32) | (out_s + _B31))
    return (
        out_k[final].astype(np.int32),
        out_s[final].astype(np.int32),
        out_e[final].astype(np.int32),
    )


def jaccard(ak, as_, ae, bk, bs, be, *, device) -> dict:
    """Jaccard statistic of two interval sets (bedtools jaccard):
    |intersection bases| / |union bases| over the merged sets; the
    coverage of one merged set by the other runs on ``device``."""
    amk, ams, ame = merge_intervals(ak, as_, ae)
    bmk, bms, bme = merge_intervals(bk, bs, be)
    idx = build_interval_index(bmk, bms, bme, device=device)
    counts, inter = coverage(idx, amk, ams, ame)
    # coverage() returns sum(min(end,qe) - max(start,qs)) (superintervals
    # convention, no +1); add one base per overlapping merged pair to get
    # end-inclusive widths.
    intersection = int(inter.sum()) + int(counts.sum())
    a_bases = int((ame.astype(np.int64) - ams + 1).sum())
    b_bases = int((bme.astype(np.int64) - bms + 1).sum())
    union = a_bases + b_bases - intersection
    return {
        "intersection": intersection,
        "union": union,
        "jaccard": intersection / union if union else 0.0,
        "n_intersections": int(counts.sum()),
    }


def reldist(ak, as_, ae, bk, bs, be) -> np.ndarray:
    """bedtools reldist: per a-row relative distance of its midpoint to
    the closest flanking b midpoints on the same key:
    ``min(m - left, right - m) / (right - left)`` for the b midpoints
    left <= m <= right.  NaN where the a midpoint has no b midpoint on
    both sides (bedtools skips those rows).

    Fully vectorized: one composite-key sort of the b midpoints + one
    searchsorted over the a midpoints.  The composite packs
    (key, mid + 2^31) into int64 — mids span the full int32 range, keys
    are dense dictionary codes (< 2^30)."""
    ak = np.asarray(ak, np.int64)
    bk = np.asarray(bk, np.int64)
    ma = (np.asarray(as_, np.int64) + np.asarray(ae, np.int64)) // 2
    mb = (np.asarray(bs, np.int64) + np.asarray(be, np.int64)) // 2
    out = np.full(len(ak), np.nan)
    n = len(bk)
    if n == 0 or len(ak) == 0:
        return out
    kb = (bk << 33) + (mb + (1 << 31))
    kb.sort()
    kq = (ak << 33) + (ma + (1 << 31))
    ri = _searchsorted_comp(kb, kq, side="right")
    li = ri - 1
    li_c = np.clip(li, 0, n - 1)
    ri_c = np.clip(ri, 0, n - 1)
    mask_mid = (1 << 33) - 1
    same_l = (li >= 0) & ((kb[li_c] >> 33) == ak)
    same_r = (ri < n) & ((kb[ri_c] >> 33) == ak)
    lmid = (kb[li_c] & mask_mid) - (1 << 31)
    rmid = (kb[ri_c] & mask_mid) - (1 << 31)
    ok = same_l & same_r
    denom = rmid - lmid
    d = np.minimum(ma - lmid, rmid - ma).astype(np.float64)
    nz = ok & (denom > 0)
    out[nz] = d[nz] / denom[nz]
    out[ok & (denom == 0)] = 0.0
    return out


def tile_genome(key_sizes: dict[int, tuple[int, int]], window: int, step: int | None = None):
    """Fixed-size windows per contig (bedtools makewindows): windows of
    ``window`` bases every ``step`` (default: non-overlapping), the last
    window clipped to the contig end.  End-inclusive coordinates."""
    if window <= 0:
        raise ValueError("window must be positive")
    step = step or window
    if step <= 0:
        raise ValueError("step must be positive")
    ks, ss, es = [], [], []
    for k, (lo, hi) in sorted(key_sizes.items()):
        if hi < lo:
            continue
        if lo < -(2**31) or hi + window > 2**31 - 1:
            # i32 overflow is a hard error everywhere in this engine
            # (the engine's int32 rule; mirrors evaluate_as_i32)
            raise ValueError(
                f"tile coordinates for key {k} exceed the int32 range"
            )
        starts = np.arange(lo, hi + 1, step, dtype=np.int64)
        ends = np.minimum(starts + window - 1, hi)
        ks.append(np.full(len(starts), k, np.int32))
        ss.append(starts.astype(np.int32))
        es.append(ends.astype(np.int32))
    if not ks:
        z = np.empty(0, np.int32)
        return z, z, z
    return np.concatenate(ks), np.concatenate(ss), np.concatenate(es)


def flank(keys, starts, ends, left: int, right: int, key_sizes=None):
    """Flanking intervals of each input (bedtools flank): a ``left``-base
    window immediately upstream and/or a ``right``-base window immediately
    downstream, clamped to the contig span; zero-width sides omitted."""
    out_k, out_s, out_e = [], [], []
    k64 = np.asarray(keys)
    s64 = np.asarray(starts).astype(np.int64)
    e64 = np.asarray(ends).astype(np.int64)
    lo = np.full(len(k64), -(2**31), np.int64)
    hi = np.full(len(k64), 2**31 - 1, np.int64)
    if key_sizes:
        for k, (klo, khi) in key_sizes.items():
            mask = k64 == k
            lo[mask] = klo
            hi[mask] = khi
    if left > 0:
        ls = np.maximum(s64 - left, lo)
        le_ = s64 - 1
        keep = le_ >= ls
        out_k.append(k64[keep]); out_s.append(ls[keep]); out_e.append(le_[keep])
    if right > 0:
        rs = e64 + 1
        re_ = np.minimum(e64 + right, hi)
        keep = re_ >= rs
        out_k.append(k64[keep]); out_s.append(rs[keep]); out_e.append(re_[keep])
    if not out_k:
        z = np.empty(0, np.int32)
        return z, z, z
    k = np.concatenate(out_k).astype(np.int32)
    s_ = np.concatenate(out_s).astype(np.int32)
    e_ = np.concatenate(out_e).astype(np.int32)
    order = np.lexsort((s_, k))
    return k[order], s_[order], e_[order]


def slop(keys, starts, ends, left: int, right: int, key_sizes=None):
    """Extend intervals by `left`/`right` bases, clamped to the contig
    span when given (bedtools slop)."""
    s = starts.astype(np.int64) - left
    e = ends.astype(np.int64) + right
    if key_sizes:
        lo = np.full(len(keys), -(2**31), np.int64)
        hi = np.full(len(keys), 2**31 - 1, np.int64)
        for k, (klo, khi) in key_sizes.items():
            mask = keys == k
            lo[mask] = klo
            hi[mask] = khi
        s = np.maximum(s, lo)
        e = np.minimum(e, hi)
    else:
        s = np.maximum(s, -(2**31))
        e = np.minimum(e, 2**31 - 1)
    return keys, s.astype(np.int32), np.maximum(e, s).astype(np.int32)


def _coverage_ranks4(ks, ss, ke, ee, qk_d, qs_d, qe_d):
    """The four coverage ranks, int32 on the columns' device:
    [#{(k, start) <= (qk, qe)}, #{(k, end) < (qk, qs)},
    #{(k, end) <= (qk, qe)}, #{(k, start) < (qk, qs)}].  The JAX package
    dispatches them as four programs (one fused program ran slower on its
    TPU); here they are four ``rank_lex_sort`` calls."""
    from sequila_tpu_torch.ops.ranks import rank_lex_sort

    return (
        rank_lex_sort((ks, ss), (qk_d, qe_d), side="right"),
        rank_lex_sort((ke, ee), (qk_d, qs_d), side="left"),
        rank_lex_sort((ke, ee), (qk_d, qe_d), side="right"),
        rank_lex_sort((ks, ss), (qk_d, qs_d), side="left"),
    )


def _query_tensors(index: IntervalIndex, *cols):
    """Host int32 query columns as tensors on the index's device."""
    return tuple(torch.tensor(np.asarray(c, np.int32), device=index.device) for c in cols)


def coverage(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Per query: (count, sum(min(end_i,qe) - max(start_i,qs))) over all
    overlapping build intervals — superintervals.rs:802-822 exactly.

    Level-free decomposition (4 rank batches total, no per-level work):
    with A = {end in [qs,qe]} and B = {start in [qs,qe]} — both subsets of
    the match set, since start <= end —

        sum(min(end, qe))   = sum_A end   + qe * (total - |A|)
        sum(max(start, qs)) = sum_B start + qs * (total - |B|)

    where |A|,|B| are interval ranks on the (key,end)- and (key,start)-
    sorted arrays and the sums come from int64 prefix sums over the same
    orders, all on the index's device; only the two int64 result columns
    come to the host (numpy).  Exact for qs <= qe; degenerate stabbing rows
    fall back to the per-level path.
    """
    qs_np = np.asarray(qs)
    qe_np = np.asarray(qe)
    build_inverted = bool((index._he < index._hs).any())
    # the A/B subset decomposition requires start <= end on the BUILD side
    # too (every count entry point checks both sides); inverted
    # builds and degenerate probes take the exact per-level path
    if not bool((qs_np > qe_np).any()) and not build_inverted:
        cv = index.coverage_view
        qk_d, qs_d, qe_d = _query_tensors(index, qk, qs, qe)

        # total matches (BITS) and the two in-range splits
        ub, lb, a_hi, b_lo = (
            r.to(torch.int64)
            for r in _coverage_ranks4(cv.ks, cv.ss, cv.ke, cv.ee, qk_d, qs_d, qe_d)
        )
        total = (ub - lb).clamp(min=0)
        nA = (a_hi - lb).clamp(min=0)   # ends in [qs, qe]
        nB = (ub - b_lo).clamp(min=0)   # starts in [qs, qe]
        sumA_end = cv.esum[a_hi] - cv.esum[lb]
        sumB_start = cv.psum[ub] - cv.psum[b_lo]
        sum_min_end = sumA_end + qe_d.to(torch.int64) * (total - nA)
        sum_max_start = sumB_start + qs_d.to(torch.int64) * (total - nB)
        return total.cpu().numpy(), (sum_min_end - sum_max_start).cpu().numpy()
    return _coverage_levels(index, qk, qs, qe, method)


def _coverage_levels(index: IntervalIndex, qk, qs, qe, method: str = "sort"):
    """Per-level exact coverage (handles degenerate stabbing queries): four
    ``level_ranks`` on the index's device, then the host int64 finish."""
    from sequila_tpu_torch.ops.interval_join import level_ranks

    qk_d, qs_d, qe_d = _query_tensors(index, qk, qs, qe)
    kw = dict(
        num_levels=index.num_levels,
        level_offsets=index.level_offsets,
    )
    lv, ky, st, en = index.levels, index.keys, index.starts, index.ends
    lb = level_ranks(lv, ky, en, qk_d, qs_d, side="left", **kw).cpu().numpy()
    ub = level_ranks(lv, ky, st, qk_d, qe_d, side="right", **kw).cpu().numpy()
    t = level_ranks(lv, ky, en, qk_d, qe_d, side="right", **kw).cpu().numpy()
    r = level_ranks(lv, ky, st, qk_d, qs_d, side="left", **kw).cpu().numpy()

    if not hasattr(index, "_cov_prefix"):
        S = index.starts_host.astype(np.int64)
        E = index.ends_host.astype(np.int64)
        index._cov_prefix = (
            np.concatenate([[0], np.cumsum(S)]),
            np.concatenate([[0], np.cumsum(E)]),
        )
    ps, pe = index._cov_prefix

    qs_h = np.asarray(qs).astype(np.int64)
    qe_h = np.asarray(qe).astype(np.int64)
    return coverage_finish(lb, ub, t, r, index.level_offsets, ps, pe, qs_h, qe_h)


def coverage_finish(lb, ub, t, r, level_offsets, ps, pe, qs_h, qe_h):
    """int64 host finish of the rank-window coverage arithmetic — shared
    by the single-chip (_coverage_levels) and mesh (partitioned_coverage)
    paths so the subtle clipping/prefix algebra exists exactly once.

    Per level: the matches are ranks [lb, ub); of those, ends beyond qe
    start at rank t and starts before qs end at rank r, so
    sum(min(end_i, qe)) = (pe[t] - pe[l]) + qe*(u - t) and
    sum(max(start_i, qs)) = qs*(r - l) + (ps[u] - ps[r])."""
    offs = np.asarray(level_offsets, np.int64)[:, None]
    gl = offs + lb
    gu = offs + np.maximum(ub, lb)
    gt = np.clip(offs + t, gl, gu)
    gr = np.clip(offs + r, gl, gu)
    counts = (gu - gl).sum(0)
    total = np.zeros(gl.shape[1], np.int64)
    for lvl in range(len(offs)):
        l, u, tt, rr = gl[lvl], gu[lvl], gt[lvl], gr[lvl]
        sum_min_end = (pe[tt] - pe[l]) + qe_h * (u - tt)
        sum_max_start = qs_h * (rr - l) + (ps[u] - ps[rr])
        total += sum_min_end - sum_max_start
    return counts.astype(np.int64), total


_MAP_OPS = ("count", "sum", "mean", "min", "max", "median", "collapse", "distinct")


def map_aggregate(p_rows, vals, m, ops):
    """Per-probe-row aggregation of matched values (the reduction half of
    bedtools map).  ``p_rows`` must be sorted ascending (probe-major pair
    emission order); ``vals`` are the matched b-side values aligned with
    it.  Returns {op: array of length m}; empty groups yield NaN (numeric
    ops), 0 (count) or None (collapse/distinct) — bedtools' "." analog.

    All numeric ops are vectorized (bincount / reduceat / one lexsort for
    median); only the string ops build per-group Python lists, and only
    over the matched rows."""
    for op in ops:
        if op not in _MAP_OPS:
            raise ValueError(f"unsupported map op '{op}' (use {_MAP_OPS})")
    p_rows = np.asarray(p_rows, np.int64)
    counts = np.bincount(p_rows, minlength=m).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    nonempty = counts > 0
    out = {}
    numeric = [op for op in ops if op in ("sum", "mean", "min", "max", "median")]
    if numeric:
        v = np.asarray(vals, np.float64)
    for op in ops:
        if op == "count":
            out[op] = counts
            continue
        if op in ("collapse", "distinct"):
            groups = np.split(np.asarray(vals), np.cumsum(counts)[:-1])
            if op == "collapse":
                out[op] = np.array(
                    [",".join(str(x) for x in g) if len(g) else None for g in groups],
                    dtype=object,
                )
            else:
                out[op] = np.array(
                    [",".join(sorted({str(x) for x in g})) if len(g) else None
                     for g in groups],
                    dtype=object,
                )
            continue
        res = np.full(m, np.nan)
        if not nonempty.any():
            out[op] = res
            continue
        if op in ("sum", "mean"):
            sums = np.bincount(p_rows, weights=v, minlength=m)
            res[nonempty] = (
                sums[nonempty] / counts[nonempty] if op == "mean" else sums[nonempty]
            )
        elif op in ("min", "max"):
            fn = np.minimum if op == "min" else np.maximum
            red = fn.reduceat(v, offs[nonempty]) if nonempty.any() else v
            res[nonempty] = red
        else:  # median: one co-sort puts each group's values in order
            order = np.lexsort((v, p_rows))
            vs = v[order]
            c = counts[nonempty]
            o = offs[nonempty]
            lo = vs[o + (c - 1) // 2]
            hi = vs[o + c // 2]
            res[nonempty] = (lo + hi) / 2.0
        out[op] = res
    return out


_D_INVALID = np.int64(1) << 62  # sentinel distance for missing candidates


def closest_k(index: IntervalIndex, qk, qs, qe, k: int = 1, method: str = "sort"):
    """k nearest build rows per probe row (overlaps first, then by genomic
    distance; ties upstream-first, then smallest build row).  Returns
    (rows [m,k], dists [m,k]); -1 rows pad when fewer than k exist.

    Vectorized k-ring candidate gathers — no per-probe Python:

    - upstream ring: the k predecessors of the probe start in the
      (key,end)-sorted order (the k largest ends < qs = the k nearest
      upstream intervals);
    - downstream ring: the k successors of the probe end in the
      (key,start)-sorted order (the k smallest starts > qe);
    - overlap ring: the first k entries of each level's contiguous match
      run (>= min(#overlaps, k) distance-0 candidates by construction).

    One lexsort over the [m, (L+2)k] candidate matrix selects each row's
    top k.  When several overlaps tie at distance 0, the returned subset
    is deterministic (level-major, start order) but not contractual.
    Degenerate probes (qs > qe) and inverted build intervals fall back to
    the exact per-row scan.  Host NumPy throughout: it reads the index's
    numpy twins (``_hk``/``_hs``/``_he`` and the level view's ``*_host``),
    never its device tensors."""
    qk = np.asarray(qk)
    qs = np.asarray(qs)
    qe = np.asarray(qe)
    m = len(qk)
    rows = np.full((m, k), -1, np.int64)
    dists = np.full((m, k), -1, np.int64)
    hk, hs, he = index._hk, index._hs, index._he
    n = len(hk)
    if n == 0 or m == 0:
        return rows, dists

    clean = ~(np.asarray(qs > qe))
    if bool((he < hs).any()):
        clean = np.zeros(m, bool)  # inverted builds: rings don't partition
    if not clean.all():
        dirty = np.nonzero(~clean)[0]
        r_d, d_d = _closest_k_scan(index, qk[dirty], qs[dirty], qe[dirty], k)
        rows[dirty] = r_d
        dists[dirty] = d_d
        if not clean.any():
            return rows, dists
    sel = np.nonzero(clean)[0]
    cqk, cqs, cqe = qk[sel], qs[sel], qe[sel]
    mc = len(sel)

    B = np.int64(2**31)

    def comp(kc, v):
        return (kc.astype(np.int64) << 32) | (v.astype(np.int64) + B)

    s_ord = np.lexsort((hs, hk))
    # Equal (key,end) runs are ordered by DESCENDING build row so the
    # backward predecessor walk surfaces the smallest rows first — the
    # documented "then smallest build row" tie-break needs those rows IN
    # the k-ring candidate set, not just preferred by the final lexsort.
    # (The downstream ring reads forward, where the stable ascending
    # order already yields smallest rows first.)
    e_ord = np.lexsort((-np.arange(n, dtype=np.int64), he, hk))
    comp_s = comp(hk[s_ord], hs[s_ord])
    comp_e = comp(hk[e_ord], he[e_ord])
    ring = np.arange(k, dtype=np.int64)

    # Candidate matrix: one composite int64 key ``dist * W + column`` per
    # slot.  The composite reproduces the (distance, upstream-first,
    # smallest build row) order exactly: at equal distance ties can only
    # arise within one ring (downstream and overlap distances never match
    # upstream's, and overlaps are the only dist-0 source), and inside
    # each ring a lower column index is provably the smaller build row;
    # upstream columns precede downstream columns, giving upstream-first
    # across rings.  Keys are written ring-by-ring into two preallocated
    # matrices (no [m, W] temporaries beyond these), and top-k runs as an
    # O(W) argpartition instead of a 3-key lexsort.
    W = (2 + index.num_levels) * k
    INVALID = (np.int64(1) << 40) * W  # any key >= this marks a missing slot
    ckey = np.empty((mc, W), np.int64)
    crows = np.empty((mc, W), np.int32)

    def put(col0, valid, rows_i32, dist64):
        cols = np.arange(col0, col0 + k, dtype=np.int64)
        # one fused where per matrix beats three masked passes
        ckey[:, col0:col0 + k] = np.where(
            valid, dist64 * np.int64(W) + cols, INVALID
        )
        crows[:, col0:col0 + k] = np.where(valid, rows_i32, -1)

    # per-key segment offsets in O(n) (hk[e_ord] / hk[s_ord] are
    # key-sorted, so one bincount+cumsum replaces binary searches);
    # negative build keys (NULL sentinels) can't be bincounted — they
    # route through the searchsorted fallback
    use_offs = n > 0 and int(hk.min()) >= 0
    if use_offs:
        nkeys = int(hk.max()) + 1
        key_offs = np.concatenate(
            [[0], np.cumsum(np.bincount(hk, minlength=nkeys))]
        )
        cq_in = (cqk >= 0) & (cqk < nkeys)
        cqk_c = np.clip(cqk, 0, nkeys - 1)

    # upstream ring: k predecessors by end within the key segment
    lb_e = np.searchsorted(comp_e, comp(cqk, cqs), side="left")
    if use_offs:
        # out-of-range probe keys fall back to lb_e, which makes every
        # ring slot invalid (empty segment)
        seg_lo = np.where(cq_in, key_offs[cqk_c], lb_e)
    else:
        seg_lo = np.searchsorted(comp_e, cqk.astype(np.int64) << 32, side="left")
    li = lb_e[:, None] - 1 - ring[None, :]
    lv = li >= seg_lo[:, None]
    lrow = e_ord[np.clip(li, 0, n - 1)].astype(np.int32)
    put(0, lv, lrow, cqs[:, None].astype(np.int64) - he[lrow])

    # downstream ring: k successors by start within the key segment
    ub_s = np.searchsorted(comp_s, comp(cqk, cqe), side="right")
    if use_offs:
        seg_hi = np.where(cq_in, key_offs[cqk_c + 1], ub_s)
    else:
        seg_hi = np.searchsorted(
            comp_s, (cqk.astype(np.int64) + 1) << 32, side="left"
        )
    ri = ub_s[:, None] + ring[None, :]
    rv = ri < seg_hi[:, None]
    rrow = s_ord[np.clip(ri, 0, n - 1)].astype(np.int32)
    put(k, rv, rrow, hs[rrow].astype(np.int64) - cqe[:, None])

    # overlap rings: first k of each level's contiguous run (distance 0)
    K = index.keys_host
    S = index.starts_host
    E = index.ends_host
    P = index.pos_host
    zero = np.int64(0)
    q_e = comp(cqk, cqe)
    q_s = comp(cqk, cqs)
    for lvl in range(index.num_levels):
        off = index.level_offsets[lvl]
        pad = index.level_pad[lvl]
        sl = slice(off, off + pad)
        comp_lS = comp(K[sl], S[sl])
        comp_lE = comp(K[sl], E[sl])
        ub = np.searchsorted(comp_lS, q_e, side="right")
        lb = np.searchsorted(comp_lE, q_s, side="left")
        oi = lb[:, None] + ring[None, :]
        ov = oi < ub[:, None]
        orow = P[off + np.clip(oi, 0, pad - 1)].astype(np.int32)
        put((2 + lvl) * k, ov, orow, zero)

    # Top-k by k argmin sweeps: per-row introselect (argpartition) costs
    # ~8 µs/row on tiny W-wide rows, while k full-matrix argmin passes
    # are pure C column scans (~20x faster at 500k x 27).  Keys embed the
    # column index, so ties are impossible and each sweep's winner is
    # unique; masking it to INT64_MAX keeps later sweeps sorted ascending.
    ii = np.arange(mc)
    picked_key = np.empty((mc, k), np.int64)
    picked_r = np.empty((mc, k), np.int32)
    for j in range(k):
        c = np.argmin(ckey, axis=1)
        picked_key[:, j] = ckey[ii, c]
        picked_r[:, j] = crows[ii, c]
        if j + 1 < k:
            ckey[ii, c] = np.iinfo(np.int64).max
    ok = picked_key < INVALID
    rows[sel] = np.where(ok, picked_r, -1)
    # recover distances: key // W strips the column tie-break term
    dists[sel] = np.where(ok, picked_key // W, -1)
    return rows, dists


def _closest_k_scan(index: IntervalIndex, qk, qs, qe, k: int):
    """Exact per-row scan fallback (degenerate probes, inverted builds)."""
    K = index.keys_host
    S = index.starts_host
    E = index.ends_host
    P = index.pos_host
    m = len(qk)
    rows = np.full((m, k), -1, np.int64)
    dists = np.full((m, k), -1, np.int64)
    real = P >= 0
    for i in range(m):
        seg = np.nonzero(real & (K == qk[i]))[0]
        if not len(seg):
            continue
        s, e, p = S[seg].astype(np.int64), E[seg].astype(np.int64), P[seg]
        d = np.where(
            e < qs[i], qs[i] - e, np.where(s > qe[i], s - qe[i], 0)
        )
        upstream = (e < qs[i]).astype(np.int64)
        order = np.lexsort((p, -upstream, d))[:k]
        rows[i, : len(order)] = p[order]
        dists[i, : len(order)] = d[order]
    return rows, dists
