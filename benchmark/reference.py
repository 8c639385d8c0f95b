"""Plain NumPy reference of the overlap join's count and its coverage.

Two intervals overlap when they share a contig and ``a.start <= b.end``
and ``b.start <= a.end`` (end-inclusive, the databio query).  Everything
here is worked out from the generated inputs alone: it imports nothing of
the program, and the contig codes are the generator's own.  Positions are
keyed as (contig code << 32) | position, so one sorted array holds every
contig in order.

- ``per_row_counts``: for each row of ``a``, how many rows of ``b``
  overlap it, as #(b.start <= a.end) - #(b.end < a.start) (a b row that
  ends before a.start also starts before a.end, since start <= end).
- ``coverage``: per row of ``a``, that count and the bases covered,
  sum(min(a.end, b.end) - max(a.start, b.start)) over the overlapping b
  rows.  An overlapping row's end lies below a.end exactly when it lies
  in [a.start, a.end), and its start above a.start exactly when it lies
  in (a.start, a.end]; so both sums are ranges of prefix sums over the
  sorted ends and starts, and no pair is visited.
"""

from __future__ import annotations

import numpy as np


def _check(t) -> None:
    if t.rows and (int(t.start.min()) < 0 or int(t.end.max()) >= 2**31
                   or bool((t.start > t.end).any())):
        raise ValueError("reference expects 0 <= start <= end < 2**31")


def _keys(code, pos) -> np.ndarray:
    return (code.astype(np.int64) << 32) | pos.astype(np.int64)


def _rank(sorted_v: np.ndarray, q: np.ndarray, side: str) -> np.ndarray:
    """np.searchsorted(sorted_v, q, side), with the needles searched in
    sorted order (NumPy's search then starts where the last one ended)."""
    order = np.argsort(q, kind="stable")
    out = np.empty(len(q), np.int64)
    out[order] = np.searchsorted(sorted_v, q[order], side)
    return out


class _Sorted:
    """One side's positions of b, keyed and sorted, with prefix sums of
    the positions (exact in int64: at most 2**31 a row)."""

    def __init__(self, code, pos):
        self.keys = np.sort(_keys(code, pos))
        self.prefix = np.concatenate([[0], np.cumsum(self.keys & 0xFFFFFFFF)])

    def rank(self, code, pos, side):
        return _rank(self.keys, _keys(code, pos), side)


def _counts(a, b):
    _check(a)
    _check(b)
    bs, be = _Sorted(b.code, b.start), _Sorted(b.code, b.end)
    started = bs.rank(a.code, a.end, "right")  # b rows keyed up to (a.code, a.end)
    ended = be.rank(a.code, a.start, "left")  # b rows that end before a.start
    # both ranks count every b row of the earlier contigs alike, so they cancel
    return started - ended, bs, be, started, ended


def per_row_counts(a, b) -> np.ndarray:
    """int64 number of b rows overlapping each a row."""
    return _counts(a, b)[0]


def coverage(a, b) -> tuple:
    """(counts, bases), int64 per a row, over the overlapping b rows."""
    counts, bs, be, started, ended = _counts(a, b)
    # ends in [a.start, a.end): they bound the overlap instead of a.end
    inner_end = be.rank(a.code, a.end, "left")
    n_end = inner_end - ended
    sum_end = be.prefix[inner_end] - be.prefix[ended]
    # starts in (a.start, a.end]: they bound the overlap instead of a.start
    after_start = bs.rank(a.code, a.start, "right")
    n_start = started - after_start
    sum_start = bs.prefix[started] - bs.prefix[after_start]
    bases = (sum_end + a.end * (counts - n_end)) - (sum_start + a.start * (counts - n_start))
    return counts, bases


def rounded(t, dtype=np.float32):
    """The same rows with every position rounded through ``dtype``: the
    control, a reference that keeps coordinates in float32, which holds
    integers exactly only below 2**24."""
    def r(v):
        return np.minimum(v.astype(dtype).astype(np.int64), 2**31 - 1)

    return type(t)(t.names, t.code, r(t.start), r(t.end))
