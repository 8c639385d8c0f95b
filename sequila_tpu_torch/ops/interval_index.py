"""Level-decomposed columnar interval index (port of
sequila_tpu/ops/interval_index.py).

Two flat-array views are built lazily, each on first use, as int32 torch
tensors on the device the index was built for:

**BITS view** (counting): the build's keys, starts and ends as padded
columns.  ``count = #start<=qe - #end<qs`` per key segment (Layer & Quinlan
2012), exact for every qs <= qe query.

**Level view** (degenerate queries, inverted builds): key, start, end and
original row position sorted by (level, key, start), where *level* is an
AIList-style decomposition with the invariant

    within one (level, key) segment sorted by start, the ends are
    NON-DECREASING,

so the intervals overlapping ``[qs, qe]`` form a contiguous run ``[lb, ub)``
in each level:

    ub = #{ start <= qe }   (starts ascending  -> prefix)
    lb = #{ end   <  qs }   (ends ascending    -> prefix of non-matches)

Levels are peeled on the host with a running-max pass (``assign_levels``,
numpy, copied); their number is the maximum containment depth of the data.

**Window view** (Lapper's max-extension emission): keys, starts, ends and
original row positions sorted by (key, start), plus the largest interval
length.

The padding (``_bucket``) and the field layout are the JAX package's, so
both packages build identical arrays from one input.  The level view keeps
numpy host twins of its keys, starts, ends and positions (emission expands
device bounds into build rows on the host through ``pos_host``) and each
level's maximum length.

**Coverage view** (the level-free coverage decomposition of
ops/genomic.coverage): the (key, start)- and (key, end)-sorted columns and
the int64 exclusive prefix sums of their starts and ends, pad rows counted
as 0.

A partitioned build (parallel/partitioned_join.build_partitioned_index)
re-pads each part's level view to one level layout shared by every part,
as the JAX package's ``layout`` argument does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sequila_tpu_torch.utils.metrics import to_device

# Reserved key code for padding rows: sorts after every real key and never
# equals a probe key.
PAD_KEY = np.int32(2**31 - 1)
PAD_VAL = np.int32(2**31 - 1)


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to a size bucket: powers of two up to 64k, then multiples
    of 64k.  The JAX package buckets to bound XLA recompiles; the port
    keeps the same sizes so that both indexes hold identical arrays."""
    b = minimum
    while b < n and b < 65536:
        b *= 2
    if n <= b:
        return b
    return -(-n // 65536) * 65536


class CoverageView(NamedTuple):
    """The index's sorted columns for ops/genomic.coverage: int32 tensors on
    the index's device, padded to ``_bucket(n)`` with (PAD_KEY, PAD_VAL),
    and int64 exclusive prefix sums (length + 1) of ``ss`` and ``ee`` with
    pad rows counted as 0, on the device and as numpy twins."""

    ks: torch.Tensor  # keys sorted by (key, start)
    ss: torch.Tensor  # starts sorted by (key, start)
    ke: torch.Tensor  # keys sorted by (key, end)
    ee: torch.Tensor  # ends sorted by (key, end)
    psum: torch.Tensor
    esum: torch.Tensor
    psum_host: np.ndarray
    esum_host: np.ndarray


def assign_levels(keys: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Peel (key,start)-sorted intervals into monotone-end levels.

    Returns (order, levels): ``order`` sorts the input by (key,start,end);
    ``levels[i]`` is the level of input row ``order[i]`` AFTER applying the
    order (i.e. aligned with the sorted view).
    """
    n = len(keys)
    order = np.lexsort((ends, starts, keys)).astype(np.int64)
    k = keys[order].astype(np.int64)
    e = ends[order].astype(np.int64)
    # Composite (key, end): key dominates, so a running max resets naturally
    # at key-segment boundaries.
    comp_e = (k << 32) | (e + 2**31)
    levels = np.zeros(n, dtype=np.int32)
    remaining = np.arange(n, dtype=np.int64)
    lvl = 0
    while remaining.size:
        ce = comp_e[remaining]
        keep = ce >= np.maximum.accumulate(ce)
        levels[remaining[keep]] = lvl
        remaining = remaining[~keep]
        lvl += 1
    return order, levels


class IntervalIndex:
    """Build-side index with lazily materialized device views.

    Static metadata (python ints/tuples):
      level_sizes:   real rows per level
      level_pad:     padded rows per level (bucketed)
      level_offsets: start offset of each level in the padded arrays
      n_rows:        total real build rows
    Device tensors (int32 on ``device``):
      levels/keys/starts/ends/pos — the level view, length sum(level_pad),
      sorted by (level, key, start); padding rows carry
      (level, PAD_KEY, PAD_VAL, PAD_VAL, -1).
      bs_keys/bs_starts/be_keys/be_ends — the BITS view, length bucket(n).
    """

    def __init__(self, keys, starts, ends, *, device):
        self._hk = np.ascontiguousarray(keys, dtype=np.int32)
        self._hs = np.ascontiguousarray(starts, dtype=np.int32)
        self._he = np.ascontiguousarray(ends, dtype=np.int32)
        self.device = torch.device(device)
        self.n_rows = len(self._hk)
        self._bits = None
        self._lvl = None
        self._win = None
        self._cov = None

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    # -- BITS view ----------------------------------------------------------
    def _build_bits(self):
        if self._bits is not None:
            return
        # unsorted padded columns: the rank (ops/ranks.rank_lex_sort) sorts
        # its composites itself
        n = self.n_rows
        n0 = _bucket(max(n, 1))
        bs_k = np.full(n0, PAD_KEY, np.int32)
        bs_s = np.full(n0, PAD_VAL, np.int32)
        be_e = np.full(n0, PAD_VAL, np.int32)
        if n:
            bs_k[:n] = self._hk
            bs_s[:n] = self._hs
            be_e[:n] = self._he
        k = self._to_device(bs_k)
        self._bits = (k, self._to_device(bs_s), k, self._to_device(be_e))

    @property
    def bs_keys(self):
        self._build_bits()
        return self._bits[0]

    @property
    def bs_starts(self):
        self._build_bits()
        return self._bits[1]

    @property
    def be_keys(self):
        self._build_bits()
        return self._bits[2]

    @property
    def be_ends(self):
        self._build_bits()
        return self._bits[3]

    # -- level view ---------------------------------------------------------
    def _build_levels(self):
        if self._lvl is not None:
            return
        n = self.n_rows
        if n == 0:
            level_pad = (_bucket(1),)
            total = level_pad[0]
            K0 = np.full(total, PAD_KEY, np.int32)
            V0 = np.full(total, PAD_VAL, np.int32)
            P0 = np.full(total, -1, np.int32)
            self._lvl = dict(
                level_sizes=(0,), level_pad=level_pad, level_offsets=(0,),
                max_lens=(0,),
                levels=self._to_device(np.zeros(total, np.int32)),
                keys=self._to_device(K0), starts=self._to_device(V0),
                ends=self._to_device(V0), pos=self._to_device(P0),
                pos_host=P0, keys_host=K0, starts_host=V0, ends_host=V0,
            )
            return

        order, levels = assign_levels(self._hk, self._hs, self._he)
        k, s, e = self._hk[order], self._hs[order], self._he[order]
        pos = order.astype(np.int32)

        # Final layout: level-major, then (key, start) (stable sort keeps it).
        final = np.argsort(levels, kind="stable")
        k, s, e, pos, levels = k[final], s[final], e[final], pos[final], levels[final]

        num_levels = int(levels[-1]) + 1
        sizes = np.bincount(levels, minlength=num_levels)
        level_sizes = tuple(int(x) for x in sizes)
        level_pad = tuple(_bucket(max(int(x), 1)) for x in sizes)
        level_offsets = tuple(
            int(x) for x in np.concatenate([[0], np.cumsum(level_pad)[:-1]])
        )

        total = int(sum(level_pad))
        K = np.full(total, PAD_KEY, np.int32)
        S = np.full(total, PAD_VAL, np.int32)
        E = np.full(total, PAD_VAL, np.int32)
        P = np.full(total, -1, np.int32)
        L = np.zeros(total, np.int32)
        max_lens = []
        row = 0
        for lv in range(num_levels):
            sz = level_sizes[lv]
            off = level_offsets[lv]
            K[off : off + sz] = k[row : row + sz]
            S[off : off + sz] = s[row : row + sz]
            E[off : off + sz] = e[row : row + sz]
            P[off : off + sz] = pos[row : row + sz]
            L[off : off + level_pad[lv]] = lv
            max_lens.append(
                int(np.max(e[row : row + sz] - s[row : row + sz])) if sz else 0
            )
            row += sz

        d = self._to_device
        self._lvl = dict(
            level_sizes=level_sizes,
            level_pad=level_pad,
            level_offsets=level_offsets,
            max_lens=tuple(max_lens),
            levels=d(L), keys=d(K), starts=d(S), ends=d(E), pos=d(P),
            pos_host=P, keys_host=K, starts_host=S, ends_host=E,
        )

    def _lvl_get(self, name):
        self._build_levels()
        return self._lvl[name]

    level_sizes = property(lambda self: self._lvl_get("level_sizes"))
    level_pad = property(lambda self: self._lvl_get("level_pad"))
    level_offsets = property(lambda self: self._lvl_get("level_offsets"))
    levels = property(lambda self: self._lvl_get("levels"))
    keys = property(lambda self: self._lvl_get("keys"))
    starts = property(lambda self: self._lvl_get("starts"))
    ends = property(lambda self: self._lvl_get("ends"))
    pos = property(lambda self: self._lvl_get("pos"))
    max_lens = property(lambda self: self._lvl_get("max_lens"))
    # numpy twins of the level view: pos_host expands device bounds into
    # build rows on the host; keys/starts/ends are the JAX index's fields,
    # from which its merge-bounds plan packs level slices (the port's plan
    # slices the device arrays instead)
    pos_host = property(lambda self: self._lvl_get("pos_host"))
    keys_host = property(lambda self: self._lvl_get("keys_host"))
    starts_host = property(lambda self: self._lvl_get("starts_host"))
    ends_host = property(lambda self: self._lvl_get("ends_host"))

    @property
    def num_levels(self) -> int:
        return len(self.level_sizes)

    @property
    def padded_size(self) -> int:
        return int(sum(self.level_pad))

    # -- window view (Lapper-style max-extension emission) -----------------
    @property
    def window_view(self):
        """((key, start)-sorted keys, starts, ends, pos tensors, max_len):
        padded to ``_bucket(n)`` with (PAD_KEY, PAD_VAL, PAD_VAL, -1)."""
        if self._win is None:
            n = self.n_rows
            n0 = _bucket(max(n, 1))
            k = np.full(n0, PAD_KEY, np.int32)
            s = np.full(n0, PAD_VAL, np.int32)
            e = np.full(n0, PAD_VAL, np.int32)
            p = np.full(n0, -1, np.int32)
            max_len = 0
            if n:
                order = np.lexsort((self._hs, self._hk))
                k[:n] = self._hk[order]
                s[:n] = self._hs[order]
                e[:n] = self._he[order]
                p[:n] = order.astype(np.int32)
                max_len = int(np.max(self._he.astype(np.int64) - self._hs))
            d = self._to_device
            self._win = (d(k), d(s), d(e), d(p), max_len)
        return self._win

    # -- coverage view (level-free coverage decomposition) -----------------
    @property
    def coverage_view(self) -> CoverageView:
        """The (key, start)- and (key, end)-sorted columns with the prefix
        sums of their starts and ends (see CoverageView)."""
        if self._cov is None:
            n = self.n_rows
            n0 = _bucket(max(n, 1))
            ks = np.full(n0, PAD_KEY, np.int32)
            ss = np.full(n0, PAD_VAL, np.int32)
            ke = np.full(n0, PAD_KEY, np.int32)
            ee = np.full(n0, PAD_VAL, np.int32)
            if n:
                o1 = np.lexsort((self._hs, self._hk))
                ks[:n] = self._hk[o1]
                ss[:n] = self._hs[o1]
                o2 = np.lexsort((self._he, self._hk))
                ke[:n] = self._hk[o2]
                ee[:n] = self._he[o2]
            ps = np.concatenate([[0], np.cumsum(np.where(ks == PAD_KEY, 0, ss).astype(np.int64))])
            pe = np.concatenate([[0], np.cumsum(np.where(ke == PAD_KEY, 0, ee).astype(np.int64))])
            d = self._to_device
            self._cov = CoverageView(d(ks), d(ss), d(ke), d(ee), d(ps), d(pe), ps, pe)
        return self._cov


def build_interval_index(
    keys: np.ndarray, starts: np.ndarray, ends: np.ndarray, *, device
) -> IntervalIndex:
    """Build the (lazy) index from host arrays (int32 keys and i32 bounds),
    its views to live on the torch ``device``."""
    return IntervalIndex(keys, starts, ends, device=device)
