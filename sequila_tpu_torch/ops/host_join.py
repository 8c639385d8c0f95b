"""Host (NumPy) interval-join execution path for small inputs.

The TPU kernels pay a one-time XLA compile per shape bucket — tens of
seconds against a remote TPU — which dwarfs tiny interactive queries (the
reference's 12-row fixtures answer in microseconds on a CPU).  Below a row
threshold the operator routes here: exact same semantics (end-inclusive
i32, degenerate-query stabbing matches, nearest/NULL rules), vectorized
NumPy on int64 composites.  The native C++ library (sequila_tpu_torch/native)
replaces the inner loops of this path when built.

This mirrors the reference's own layering: its per-chromosome indexes are
CPU-side; our CPU path is the small-query fallback while the TPU path is
the scale path.
"""

from __future__ import annotations

import numpy as np

_B = 2**31  # bias to make i32 values non-negative in composites


def _comp(keys, vals):
    return (keys.astype(np.int64) << 32) | (vals.astype(np.int64) + _B)


def make_host_index(keys, starts, ends):
    """Native C++ index when available (sequila_tpu_torch/native), else NumPy."""
    try:
        from sequila_tpu_torch.native.loader import NativeIntervalIndex, available

        if available():
            return NativeIntervalIndex(keys, starts, ends)
    except Exception:
        pass
    return HostIntervalIndex(keys, starts, ends)


class HostIntervalIndex:
    """BITS arrays + (key,start)-sorted view with per-segment end cummax."""

    def __init__(self, keys, starts, ends):
        self.keys = np.ascontiguousarray(keys, np.int32)
        self.starts = np.ascontiguousarray(starts, np.int32)
        self.ends = np.ascontiguousarray(ends, np.int32)
        n = len(self.keys)
        self.n = n
        # (key, start, END) — matching the device level view and the
        # native C++ index so nearest tie-breaks identically on all paths
        order = np.lexsort((self.ends, self.starts, self.keys))
        self.order = order
        self.k_s = self.keys[order]
        self.s_s = self.starts[order]
        self.e_s = self.ends[order]
        self.comp_start = _comp(self.k_s, self.s_s)
        self.comp_end_sorted = np.sort(_comp(self.keys, self.ends))
        # segment-reset cummax of ends in (key,start) order, via composite
        ce = _comp(self.k_s, self.e_s)
        self.cummax_end = np.maximum.accumulate(ce) if n else ce
        # inverted intervals (end < start) break the BITS count identity:
        # an entry with end < qs AND start > qe is subtracted but never
        # added.  counts() routes to the exact pairs scan in that case.
        self.has_inverted = bool(n) and bool((self.e_s < self.s_s).any())

    def counts(self, qk, qs, qe):
        """Exact overlap counts incl. degenerate (qs > qe) stabbing rows."""
        qk = np.asarray(qk, np.int32)
        qs = np.asarray(qs, np.int32)
        qe = np.asarray(qe, np.int32)
        if self.has_inverted:
            _, p_rows = self.pairs(qk, qs, qe)
            return np.bincount(p_rows, minlength=len(qk)).astype(np.int64)
        ub = np.searchsorted(self.comp_start, _comp(qk, qe), side="right")
        lb = np.searchsorted(self.comp_end_sorted, _comp(qk, qs), side="left")
        out = np.where(qs <= qe, ub - lb, 0).astype(np.int64)
        deg = np.nonzero(qs > qe)[0]
        for i in deg:
            seg = (self.keys == qk[i]) & (self.starts <= qe[i]) & (self.ends >= qs[i])
            out[i] = int(seg.sum())
        return out

    def pairs(self, qk, qs, qe):
        """All (build_row, probe_row) pairs, probe-major order.

        Candidate window per probe = [first index whose segment cummax end
        reaches qs, first start > qe) in (key,start) order, then an end
        mask — O(candidates), which is fine at host-path sizes."""
        qk = np.asarray(qk, np.int32)
        qs = np.asarray(qs, np.int32)
        qe = np.asarray(qe, np.int32)
        m = len(qk)
        ub = np.searchsorted(self.comp_start, _comp(qk, qe), side="right")
        lo = np.searchsorted(self.cummax_end, _comp(qk, qs), side="left")
        seg_lo = np.searchsorted(self.comp_start, _comp(qk, np.full(m, -_B, np.int64).astype(np.int32)), side="left") if m else lo
        lo = np.maximum(lo, seg_lo)
        widths = np.maximum(ub - lo, 0)
        total_cand = int(widths.sum())
        probe = np.repeat(np.arange(m, dtype=np.int64), widths)
        offs = np.concatenate([[0], np.cumsum(widths)])
        within = np.arange(total_cand, dtype=np.int64) - np.repeat(offs[:-1], widths)
        cand = np.repeat(lo, widths) + within
        keep = self.e_s[cand] >= qs[probe]
        # key check: window is within the key segment by construction of
        # comp bounds (key dominates), but cummax lo can fall in an earlier
        # key's run — mask it.
        keep &= self.k_s[cand] == qk[probe]
        return self.order[cand[keep]], probe[keep]

    def nearest(self, qk, qs, qe):
        """First overlap else nearest (ties upstream); -1 for absent keys.

        Canonical tie-breaking, shared bit-for-bit with the device kernel
        (ops/interval_join.py nearest_from_bounds) and the native index:
        overlap pick = min (start, end, row); upstream tie = max
        (end, start, row); downstream tie = min (start, end, row)."""
        qk = np.asarray(qk, np.int32)
        qs = np.asarray(qs, np.int32)
        qe = np.asarray(qe, np.int32)
        m = len(qk)
        out = np.full(m, -1, np.int64)
        b_rows, p_rows = self.pairs(qk, qs, qe)
        # first overlap per probe row
        if len(p_rows):
            first = np.unique(p_rows, return_index=True)
            out[first[0]] = b_rows[first[1]]
        # nearest for the rest
        seg_lo = np.searchsorted(self.comp_start, _comp(qk, np.full(m, -(2**31), np.int32)), side="left")
        seg_hi = np.searchsorted(self.comp_start, _comp(qk, np.full(m, 2**31 - 1, np.int32)), side="right")
        for i in np.nonzero(out < 0)[0]:
            lo, hi = seg_lo[i], seg_hi[i]
            if lo >= hi:
                continue
            e = self.e_s[lo:hi].astype(np.int64)
            s = self.s_s[lo:hi].astype(np.int64)
            left = np.nonzero(e < qs[i])[0]
            right = np.nonzero(s > qe[i])[0]
            best_d, best_j = None, -1
            if len(left):
                # segment is (start, end, row)-sorted, so the LAST index
                # among max-end entries is the (end, start, row) maximum
                cand = left[e[left] == e[left].max()]
                j = cand[-1]
                best_d, best_j = qs[i] - e[j], j
            if len(right):
                j = right[np.argmin(s[right])]
                d = s[j] - qe[i]
                if best_d is None or d < best_d:
                    best_d, best_j = d, j
            if best_j >= 0:
                out[i] = self.order[lo + best_j]
        return out
