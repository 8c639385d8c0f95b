"""Host columnar table model (the engine's RecordBatch analog).

The reference flows Arrow RecordBatches through DataFusion's pull-based
streams (reference interval_join.rs: concat_batches/compute::take).  This
engine's unit of exchange is a whole columnar ``Table`` backed by pyarrow
(zero-copy to NumPy for the device path); operators consume and produce
Tables, chunking internally where memory demands it (low-memory mode).

Includes a DataFusion-compatible pretty printer so expected-output tables
from the reference test-suite can be asserted verbatim.
"""

from __future__ import annotations

import os as _os

import numpy as np
import pyarrow as pa
import torch

from sequila_tpu_torch.errors import CastOverflowError, ExecutionError

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _device_key(device) -> str:
    """Cache key of a torch device ("cuda" and "cuda:0" stay distinct)."""
    return str(torch.device(device))

# Arrow compute kernels release the GIL, so a small shared pool lets big
# gathers run one take per column across host cores (lazy — most queries
# never hit the large-gather path).
_TAKE_POOL = None
_TAKE_POOL_LOCK = __import__("threading").Lock()
_TAKE_PARALLEL_MIN = 1 << 20  # rows; below this, pool overhead dominates


def _take_pool():
    global _TAKE_POOL
    if _TAKE_POOL is None:
        with _TAKE_POOL_LOCK:
            if _TAKE_POOL is None:
                import os
                from concurrent.futures import ThreadPoolExecutor

                _TAKE_POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 4))
    return _TAKE_POOL


_TAKE_NATIVE_MIN = 1 << 16  # rows; below this arrow take overhead is fine
# string columns with at most this many distinct values gather as
# dictionary codes (see Table._take_source)
_DICT_TAKE_MAX_CARD = 4096


def _rows32(idx: np.ndarray) -> np.ndarray | None:
    """Indices as non-negative int32 for the native gather, or None."""
    if idx.dtype == np.int32:
        return np.ascontiguousarray(idx)
    if not np.issubdtype(idx.dtype, np.integer):
        return None
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= 2**31):
        return None
    return idx.astype(np.int32)


def _native_take_array(lib, arr: pa.Array, rows32: np.ndarray, validity):
    """arr[rows32] via the threaded native kernels; None when the column
    shape doesn't qualify (nullable source, sliced buffers, nested or
    boolean types)."""
    if arr.null_count or arr.offset != 0:
        return None
    t = arr.type
    n = len(rows32)
    bufs = arr.buffers()
    if pa.types.is_string(t):
        if len(arr) == 0:
            return None
        offsets = np.frombuffer(bufs[1], np.int32, count=len(arr) + 1)
        data = (
            np.frombuffer(bufs[2], np.uint8, count=int(offsets[-1]))
            if bufs[2] is not None
            else np.zeros(1, np.uint8)
        )
        out_off = np.empty(n + 1, np.int32)
        total = int(lib.si_take_str_offsets(offsets, rows32, n, out_off))
        if total < 0:
            return None  # int32 offsets would overflow; arrow take handles
        # 16-byte slack: the fill's short-string fast path may overrun the
        # last row by up to 16 bytes (see si_take_str_fill)
        out_data = np.empty(max(total, 1) + 16, np.uint8)
        lib.si_take_str_fill(
            offsets, data, len(data), rows32, n, out_off, out_data
        )
        return pa.Array.from_buffers(
            pa.string(), n,
            [validity, pa.py_buffer(out_off), pa.py_buffer(out_data[:total])],
        )
    try:
        width = t.bit_width
    except ValueError:
        return None
    if width not in (32, 64) or pa.types.is_dictionary(t):
        return None
    if width == 64:
        src = np.frombuffer(bufs[1], np.int64, count=len(arr))
        out = np.empty(n, np.int64)
        if len(arr):
            lib.si_gather64(src, rows32, n, out)
        return pa.Array.from_buffers(t, n, [validity, pa.py_buffer(out)])
    src = np.frombuffer(bufs[1], np.int32, count=len(arr))
    out = np.empty(n, np.int32)
    if len(arr):
        lib.si_gather32(src, rows32, n, out)
    return pa.Array.from_buffers(t, n, [validity, pa.py_buffer(out)])


def _native_take_table(t: pa.Table, idx: np.ndarray, null_mask) -> pa.Table | None:
    """Whole-table gather, native kernels first, pooled arrow for the rest.

    Returns None when the native library is unavailable or the index
    array can't be expressed as non-negative int32 (the caller then runs
    the plain arrow path)."""
    from sequila_tpu_torch.native.loader import load

    lib = load()
    if lib is None:
        return None
    masked = null_mask is not None and bool(np.asarray(null_mask).any())
    rows = np.where(null_mask, 0, idx) if masked else idx
    rows32 = _rows32(np.asarray(rows))
    if rows32 is None:
        return None
    validity = (
        pa.py_buffer(np.packbits(~np.asarray(null_mask), bitorder="little"))
        if masked
        else None
    )
    cols: list = [None] * t.num_columns
    misses: list[int] = []
    for i, col in enumerate(t.columns):
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0) if arr.num_chunks == 1 else None
        a = (
            _native_take_array(lib, arr, rows32, validity)
            if arr is not None
            else None
        )
        if a is None:
            misses.append(i)
        else:
            cols[i] = a
    if misses:
        pa_idx = (
            pa.array(rows32, mask=np.asarray(null_mask)) if masked
            else pa.array(rows32)
        )
        if len(misses) > 1 and len(rows32) >= _TAKE_PARALLEL_MIN:
            taken = list(
                _take_pool().map(lambda i: t.column(i).take(pa_idx), misses)
            )
        else:
            taken = [t.column(i).take(pa_idx) for i in misses]
        for i, a in zip(misses, taken):
            cols[i] = a
    return pa.Table.from_arrays(cols, schema=t.schema)


def concat_tables_unify(pieces: list[pa.Table]) -> pa.Table:
    """pa.concat_tables with permissive promotion, pre-unifying
    dictionary<string> vs plain string fields.

    Join outputs gather low-cardinality string columns as dictionary
    codes (Table._take_source); a set operation or recursive CTE may
    concat such a piece with a plain-string piece, which arrow's
    permissive promotion refuses to merge — decode the dictionary side
    (only in the mixed case; equal schemas concat zero-copy)."""
    if len(pieces) > 1 and any(
        p.schema != pieces[0].schema for p in pieces[1:]
    ):
        mixed = set()
        for i in range(pieces[0].num_columns):
            types = {p.schema.types[i] for p in pieces}
            if len(types) > 1 and any(pa.types.is_dictionary(t) for t in types):
                mixed.add(i)
        if mixed:
            fixed = []
            for p in pieces:
                cols = list(p.columns)
                for i in mixed:
                    if pa.types.is_dictionary(cols[i].type):
                        cols[i] = cols[i].cast(cols[i].type.value_type)
                fixed.append(pa.Table.from_arrays(cols, names=p.column_names))
            pieces = fixed
    return pa.concat_tables(pieces, promote_options="permissive")


def _rewrap_dict_columns(t: pa.Table, plans: dict) -> pa.Table:
    """Wrap gathered int32 code columns back into DictionaryArrays.

    ``plans`` maps column index -> dictionary values (Table._take_source);
    code-level validity (outer-join NULL rows) carries through unchanged.
    """
    cols = []
    for i, col in enumerate(t.columns):
        if i in plans:
            chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
            col = pa.chunked_array(
                [pa.DictionaryArray.from_arrays(c, plans[i], safe=False) for c in chunks]
                or [pa.DictionaryArray.from_arrays(pa.array([], pa.int32()), plans[i])]
            )
        cols.append(col)
    return pa.Table.from_arrays(cols, names=t.column_names)


class Table:
    """Immutable named-column table backed by a pyarrow.Table.

    Interval/key columns used by the join kernels are cached as torch
    tensors on the device the caller names, after first use — the engine's
    analog of replacing the reference's per-query Arrow RecordBatch streams
    with device-resident columnar batches.  Caches are per-Table-instance
    (keyed by device) and the table is immutable, so they never go stale.
    """

    def __init__(self, arrow: pa.Table):
        self._t = arrow.combine_chunks()
        self._dev_i32: dict = {}
        self._codes: dict = {}
        self._i32: dict = {}
        self._stats = None

    def statistics(self):
        """Table + per-column statistics (reference joins/utils.rs:136-370
        consumes these for join-cardinality estimation; the operator
        surfaces them via statistics(), interval_join.rs:586-593).

        Computed lazily on first use and cached (the table is immutable):
        exact row/byte counts and per-column null_count / min / max /
        distinct_count (+ mean for numerics — the engine's interval-
        selectivity estimate needs E[length], which min/max cannot give).
        """
        if self._stats is not None:
            return self._stats
        import pyarrow.compute as pc

        from sequila_tpu_torch.exec.statistics import (
            ColumnStatistics,
            Precision,
            Statistics,
        )

        cols = []
        for col in self._t.columns:
            null_count = Precision.exact(col.null_count)
            mn = mx = dv = mean = Precision.absent()
            t = col.type
            try:
                if (
                    pa.types.is_integer(t) or pa.types.is_floating(t)
                    or pa.types.is_string(t) or pa.types.is_large_string(t)
                    or pa.types.is_temporal(t)
                ):
                    if len(col) and col.null_count < len(col):
                        s = pc.min_max(col).as_py()
                        mn = Precision.exact(s["min"])
                        mx = Precision.exact(s["max"])
                    dv = Precision.exact(pc.count_distinct(col).as_py())
                if pa.types.is_integer(t) or pa.types.is_floating(t):
                    if len(col) and col.null_count < len(col):
                        mean = Precision.exact(pc.mean(col).as_py())
            except pa.ArrowNotImplementedError:
                pass
            cols.append(ColumnStatistics(null_count, mn, mx, dv, mean))
        self._stats = Statistics(
            Precision.exact(self._t.num_rows),
            Precision.exact(self._t.nbytes),
            tuple(cols),
        )
        return self._stats

    def device_i32(self, name_or_idx, device):
        """Column as an int32 tensor on ``device`` (overflow-checked once)."""
        key = (name_or_idx, _device_key(device))
        if key not in self._dev_i32:
            self._dev_i32[key] = torch.tensor(
                self.column_as_i32(name_or_idx), device=device
            )
        return self._dev_i32[key]

    def dict_codes(self, name_or_idx, device=None):
        """(codes int32 np, dictionary values np, device codes), cached.

        The device codes are an int32 tensor on ``device``, or None when
        no device is named.  Codes are ORDER-PRESERVING (dictionary sorted,
        codes = value ranks): merging two sorted dictionaries then yields
        monotone remaps, so cached (code, value)-sorted views stay sorted
        in the joint key space — the basis of the sort-free count path."""
        key = name_or_idx
        if key not in self._codes:
            col = self._t.column(name_or_idx).combine_chunks()
            enc = col.dictionary_encode()
            codes = enc.indices.to_numpy(zero_copy_only=False).astype(np.int32)
            values = enc.dictionary.to_numpy(zero_copy_only=False)
            order = np.argsort(values, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            codes = rank.astype(np.int32)[codes]
            values = values[order]
            self._codes[key] = (codes, values)
        codes, values = self._codes[key]
        if device is None:
            return codes, values, None
        dkey = ("codes", key, _device_key(device))
        if dkey not in self._dev_i32:
            self._dev_i32[dkey] = torch.tensor(codes, device=device)
        return codes, values, self._dev_i32[dkey]

    def _sorted_view_host(self, key_col, val_col):
        """(keys, values, n, order) numpy arrays of the sorted view, cached."""
        key = ("sivh", key_col, val_col)
        if key not in self._i32:
            codes, _, _ = self.dict_codes(key_col)
            vals = self.column_as_i32(val_col)
            order = np.lexsort((vals, codes))
            n = len(order)
            pad = -(-max(n, 1) // 2048) * 2048
            PADV = np.int32(2**31 - 1)
            K = np.full(pad, PADV, np.int32)
            V = np.full(pad, PADV, np.int32)
            K[:n] = codes[order]
            V[:n] = vals[order]
            order = order.astype(np.int32)
            for a in (K, V, order):
                a.flags.writeable = False
            self._i32[key] = (K, V, n, order)
        return self._i32[key]

    def sorted_interval_view(self, key_col, val_col, device):
        """(device keys, device values, host keys, host values, n): the
        (key code, i32 value) pairs sorted by (code, value), padded to a
        2048 multiple with PAD sentinels (2^31 - 1) — int32 tensors on
        ``device`` beside their numpy twins.  Cached — the engine's sorted
        columnar view for the merge kernels."""
        cache_key = ("siv", key_col, val_col, _device_key(device))
        if cache_key not in self._dev_i32:
            K, V, n, _ = self._sorted_view_host(key_col, val_col)
            self._dev_i32[cache_key] = (
                torch.tensor(K, device=device), torch.tensor(V, device=device), K, V, n
            )
        return self._dev_i32[cache_key]

    def sorted_interval_order(self, key_col, val_col) -> np.ndarray:
        """Permutation behind ``sorted_interval_view``: slot i of the sorted
        view holds original row ``order[i]`` (real rows only, length
        num_rows)."""
        return self._sorted_view_host(key_col, val_col)[3]

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_arrow(cls, t: pa.Table) -> "Table":
        return cls(t)

    @classmethod
    def from_pydict(cls, d: dict) -> "Table":
        return cls(pa.table(d))

    @classmethod
    def from_arrays(cls, names, arrays) -> "Table":
        return cls(pa.table({n: a for n, a in zip(names, arrays)}))

    # -- basics -------------------------------------------------------------
    @property
    def arrow(self) -> pa.Table:
        return self._t

    @property
    def num_rows(self) -> int:
        return self._t.num_rows

    @property
    def column_names(self) -> list[str]:
        return list(self._t.column_names)

    @property
    def schema(self) -> pa.Schema:
        return self._t.schema

    def column(self, name_or_idx) -> pa.ChunkedArray:
        return self._t.column(name_or_idx)

    def column_np(self, name_or_idx) -> np.ndarray:
        """Column as numpy (strings come back as object arrays)."""
        col = self._t.column(name_or_idx)
        if pa.types.is_dictionary(col.type):
            # decode first: ChunkedArray.to_numpy on a dictionary column
            # silently maps NULL slots to dictionary[0] (pyarrow quirk)
            col = col.cast(col.type.value_type)
        try:
            return col.to_numpy(zero_copy_only=False)
        except pa.ArrowInvalid:
            return np.asarray(col.to_pylist(), dtype=object)

    def rename(self, names: list[str]) -> "Table":
        return Table(self._t.rename_columns(names))

    def select(self, names_or_idxs) -> "Table":
        """Column-pruned zero-copy view; cached per id-tuple so chunked
        emission reuses one wrapper (and therefore its dict-take /
        sorted-view caches) across output batches.  Iterator arguments
        are materialized FIRST — tuple() would otherwise exhaust a
        generator before pa.Table.select saw it."""
        if not isinstance(names_or_idxs, (list, tuple)):
            names_or_idxs = list(names_or_idxs)
        try:
            key = ("select", tuple(names_or_idxs))
        except TypeError:
            return Table(self._t.select(names_or_idxs))
        hit = self._codes.get(key)
        if hit is None:
            hit = self._codes[key] = Table(self._t.select(names_or_idxs))
        return hit

    def slice(self, offset: int, length: int | None = None) -> "Table":
        return Table(self._t.slice(offset, length))

    def _take_index(self, indices: np.ndarray, null_mask: np.ndarray | None):
        idx = np.asarray(indices)
        if not np.issubdtype(idx.dtype, np.integer):
            idx = idx.astype(np.int64)
        if null_mask is not None and null_mask.any():
            return pa.array(np.where(null_mask, 0, idx), mask=np.asarray(null_mask))
        return pa.array(idx)

    # pair-scoped memos: at most this many live entries per (table, tag)
    _PAIRED_MEMO_MAX = 4

    def paired_memo(self, key: tuple, other: "Table", build, valid=None):
        """Memo scoped to (this table, ``key``, the identity of ``other``).

        The shared pattern behind the merge-count/probe-count plans, the
        device index, and the merge-bounds plan: ``key`` must already
        embed ``id(other)``; the entry stores a weakref to ``other`` so a
        recycled id can never alias, and per (table, key-tag) at most
        _PAIRED_MEMO_MAX entries are kept (oldest evicted) so a stream of
        transient probe tables cannot pin dead indexes/plans forever.
        ``build()`` computes the value on miss (None results are cached
        too — a disqualified plan shouldn't be re-planned every call);
        ``valid(value)`` optionally re-checks a hit (e.g. a plan whose
        underlying index identity must still match)."""
        import weakref

        hit = self._codes.get(key)
        if hit is not None and hit[0]() is other and (
            valid is None or valid(hit[1])
        ):
            return hit[1]
        value = build()
        tag = key[0]
        live = [
            k for k in self._codes
            if isinstance(k, tuple) and k and k[0] == tag
        ]
        if len(live) >= self._PAIRED_MEMO_MAX:
            # evict entries whose partner died first, else the oldest
            dead = [k for k in live if self._codes[k][0]() is None]
            for k in (dead or live[: len(live) - self._PAIRED_MEMO_MAX + 1]):
                del self._codes[k]
        self._codes[key] = (weakref.ref(other), value)
        return value

    def fused_take_sources(self):
        """[(arrow type, contiguous src np array)] per take-source column
        plus the dict rewrap plans, or None when any column doesn't
        qualify for the fused width-4/8 gather (si_emit_gather): nulls,
        strings that didn't dict-swap, bools, nested types, multi-chunk
        or sliced buffers all fall back to the pair + take path.

        Memoized: the result is buffer views over the (immutable) take
        source, and streamed emission asks once per output batch —
        without the memo each call would copy every source column."""
        hit = self._codes.get("_fused_srcs")
        if hit is not None:
            return hit if hit != "disqualified" else None
        out = self._fused_take_sources_build()
        self._codes["_fused_srcs"] = out if out is not None else "disqualified"
        return out

    def _fused_take_sources_build(self):
        t, plans = self._take_source()
        if t.num_rows == 0:
            return None
        srcs = []
        for col in t.columns:
            if isinstance(col, pa.ChunkedArray):
                if col.num_chunks != 1:
                    return None  # multi-chunk: pair + take path
                arr = col.chunk(0)  # zero-copy, unlike combine_chunks()
            else:
                arr = col
            if arr.null_count or arr.offset != 0 or len(arr) == 0:
                return None
            ty = arr.type
            if (
                pa.types.is_boolean(ty)
                or pa.types.is_string(ty)
                or pa.types.is_large_string(ty)
                or pa.types.is_dictionary(ty)
            ):
                return None
            try:
                width = ty.bit_width
            except ValueError:
                return None
            if width not in (32, 64):
                return None
            buf = arr.buffers()[1]
            np_dtype = np.int32 if width == 32 else np.int64
            srcs.append((ty, np.frombuffer(buf, np_dtype, count=len(arr))))
        return srcs, plans

    def _dict_take_plan(self, i: int):
        """(int32 code np array, dictionary pa.Array) for a low-cardinality
        non-null string column, or None.  Cached per column — the encode
        is O(source rows), paid once per Table, while each join-output
        gather it accelerates is typically 10-1000x the source size."""
        key = ("dicttake", i)
        if key not in self._codes:
            plan = None
            col = self._t.column(i)
            if (
                pa.types.is_string(col.type)
                and self._t.num_rows
                and col.null_count == 0
            ):
                enc = col.combine_chunks().dictionary_encode()
                if len(enc.dictionary) <= _DICT_TAKE_MAX_CARD:
                    codes = enc.indices.to_numpy(zero_copy_only=False)
                    plan = (codes.astype(np.int32, copy=False), enc.dictionary)
            self._codes[key] = plan
        return self._codes[key]

    def _take_source(self):
        """(gather-source pa.Table, {col_idx: dictionary pa.Array}).

        Low-cardinality string columns (genomic contigs, strands) are
        swapped for their int32 dictionary codes before the gather: the
        output then carries dictionary<string> columns whose gather cost
        is one int32 per row instead of offsets + bytes.  The
        decision depends only on the SOURCE column (never the gather
        size), so every output batch of a query has the same schema.
        """
        src = getattr(self, "_take_src", None)
        if src is None:
            plans = {}
            if _os.environ.get("SEQUILA_DICT_TAKE", "1") != "0":
                for i, f in enumerate(self._t.schema):
                    if pa.types.is_string(f.type):
                        p = self._dict_take_plan(i)
                        if p is not None:
                            plans[i] = p[1]
            if plans:
                cols = [
                    pa.array(self._dict_take_plan(i)[0])
                    if i in plans
                    else col
                    for i, col in enumerate(self._t.columns)
                ]
                t = pa.Table.from_arrays(cols, names=self._t.column_names)
            else:
                t = self._t
            src = self._take_src = (t, plans)
        return src

    def take(self, indices: np.ndarray, null_mask: np.ndarray | None = None) -> "Table":
        """Row gather; rows where null_mask is True become all-NULL.

        Mirrors the reference's emit path: UInt32 index arrays with a
        NullBuffer gathered via arrow compute::take
        (interval_join.rs:1363-1419) — but large gathers of primitive and
        string columns route through the native threaded gather kernels
        (si_gather32/64, si_take_str_fill), which run at memory bandwidth
        where arrow's take is single-threaded; low-cardinality string
        columns gather as dictionary codes (_take_source); leftovers
        (nested types, nullable sources) fall back to pooled arrow takes
        per column.
        """
        idx = np.asarray(indices)
        t, plans = self._take_source()
        out = None
        if len(idx) >= _TAKE_NATIVE_MIN:
            out = _native_take_table(t, idx, null_mask)
        if out is None:
            pa_idx = self._take_index(idx, null_mask)
            if len(pa_idx) >= _TAKE_PARALLEL_MIN and t.num_columns > 1:
                cols = list(
                    _take_pool().map(lambda c: c.take(pa_idx), t.columns)
                )
                out = pa.Table.from_arrays(cols, schema=t.schema)
            else:
                out = t.take(pa_idx)
        if plans:
            out = _rewrap_dict_columns(out, plans)
        return Table(out)

    def append_columns(self, other: "Table") -> "Table":
        t = self._t
        for name, col in zip(other.column_names, other.arrow.columns):
            t = t.append_column(pa.field(name, col.type), col)
        return Table(t)

    def __repr__(self) -> str:
        return f"Table({self.num_rows} rows: {self.column_names})"

    def to_pylist(self):
        return self._t.to_pylist()

    def to_pylist_column(self, name_or_idx):
        """Single column as a Python list (None for NULLs)."""
        return self._t.column(name_or_idx).to_pylist()

    # -- interval-specific helpers -----------------------------------------
    def column_as_i32(self, name_or_idx) -> np.ndarray:
        """Cast a coordinate column to i32, hard-erroring on overflow.

        Same contract as the reference's ``evaluate_as_i32``
        (interval_join.rs:1661-1672, tested at :1927-1968): any value
        outside i32 is an execution error, never a silent wrap.

        Cached per column (the table is immutable): repeated queries over
        a registered table skip the 64-bit widen + range check entirely.
        """
        cached = self._i32.get(name_or_idx)
        if cached is not None:
            return cached
        out = self._column_as_i32_uncached(name_or_idx)
        out.flags.writeable = False
        self._i32[name_or_idx] = out
        return out

    def min_i32_diff(self, hi_col, lo_col) -> int:
        """min(i32[hi_col] - i32[lo_col]) over all rows, cached.

        The BITS-count eligibility checks (no inverted build intervals,
        no degenerate probes) reduce to this statistic shifted by the
        strict-op deltas; caching it makes the checks free on repeated
        queries.  Returns 0 for an empty table (nothing is inverted)."""
        key = ("mindiff", hi_col, lo_col)
        cached = self._i32.get(key)
        if cached is None:
            hi = self.column_as_i32(hi_col).astype(np.int64)
            lo = self.column_as_i32(lo_col).astype(np.int64)
            cached = int((hi - lo).min()) if len(hi) else 0
            self._i32[key] = cached
        return cached

    def per_key_minmax(self, key_col, val_col):
        """Per-dictionary-code (min, max) int64 arrays of an i32 value
        column, cached.

        The packed-uint32 count kernel compacts each key segment's value
        range into a shared 32-bit domain; the per-key extrema (merged
        with the other side's, shifted by the planner's ±lit deltas) size
        the segment bases.  Computed once per (key, value) column pair
        via the native radix argsort over (code << 32 | biased value)
        composites — O(n) boundary reads after the sort."""
        key = ("pkmm", key_col, val_col)
        cached = self._i32.get(key)
        if cached is not None:
            return cached
        codes, values, _ = self.dict_codes(key_col)
        vals = self.column_as_i32(val_col)
        k = len(values)
        n = len(codes)
        mins = np.full(k, np.iinfo(np.int64).max, np.int64)
        maxs = np.full(k, np.iinfo(np.int64).min, np.int64)
        if n:
            comp = (codes.astype(np.int64) << 32) | (
                vals.astype(np.int64) + (1 << 31)
            )
            comp.sort()
            scodes = (comp >> 32).astype(np.int32)
            svals = (comp & 0xFFFFFFFF) - (1 << 31)
            # first/last occurrence of each present code
            firsts = np.searchsorted(scodes, np.arange(k, dtype=np.int32), "left")
            lasts = np.searchsorted(scodes, np.arange(k, dtype=np.int32), "right")
            present = lasts > firsts
            mins[present] = svals[firsts[present]]
            maxs[present] = svals[lasts[present] - 1]
        mins.flags.writeable = False
        maxs.flags.writeable = False
        self._i32[key] = (mins, maxs)
        return self._i32[key]

    def _column_as_i32_uncached(self, name_or_idx) -> np.ndarray:
        col = self._t.column(name_or_idx)
        if col.null_count:
            raise ExecutionError(
                "interval bound column contains NULLs (bounds must be "
                "non-null; filter them out first)"
            )
        arr = self.column_np(name_or_idx)
        if arr.dtype == np.int32:
            return arr
        if not np.issubdtype(arr.dtype, np.integer) and not np.issubdtype(
            arr.dtype, np.floating
        ):
            raise ExecutionError(
                f"interval bound column has non-numeric type {arr.dtype}"
            )
        a64 = arr.astype(np.int64)
        if ((a64 < I32_MIN) | (a64 > I32_MAX)).any():
            bad = a64[(a64 < I32_MIN) | (a64 > I32_MAX)][0]
            raise CastOverflowError(
                f"Can't cast value {bad} to type Int32"
            )
        return a64.astype(np.int32)


def encode_join_keys(left, right) -> tuple[np.ndarray, np.ndarray, int]:
    """Shared dictionary encoding of (possibly multi-column) equi-join keys.

    The reference hashes key columns with a fixed-seed ahash into u64 buckets
    (interval_join.rs:136, create_hashes) and tolerates collisions via the
    interval predicate only.  Dictionary codes are exact (collision-free) and
    give the small dense int32 key space the join kernels want.

    Columns may be numpy arrays or pyarrow Arrays/ChunkedArrays (the fast
    path — arrow's native C++ dictionary encoder avoids materializing
    python strings).

    Returns (left_codes, right_codes, num_codes); codes are int32 >= 0.
    """
    ncols = len(left)
    assert ncols == len(right) and ncols >= 1

    def to_pa(col) -> pa.Array:
        if isinstance(col, pa.ChunkedArray):
            return col.combine_chunks()
        if isinstance(col, pa.Array):
            return col
        return pa.array(np.asarray(col))

    def combine(cols_l, cols_r):
        al, ar = to_pa(cols_l), to_pa(cols_r)
        if al.type != ar.type:
            target = pa.string() if pa.types.is_string(al.type) or pa.types.is_string(ar.type) else al.type
            al, ar = al.cast(target), ar.cast(target)
        both = pa.chunked_array([al, ar]).combine_chunks()
        enc = both.dictionary_encode()
        idx = enc.indices
        if idx.null_count:
            # SQL: NULL never equals NULL.  Null keys get side-specific
            # sentinel codes (-1 left, -2 right) that match nothing.
            codes = idx.fill_null(0).to_numpy(zero_copy_only=False).astype(np.int32)
            null_mask = idx.is_null().to_numpy(zero_copy_only=False)
            nl_ = len(al)
            codes[:nl_][null_mask[:nl_]] = -1
            codes[nl_:][null_mask[nl_:]] = -2
        else:
            codes = idx.to_numpy(zero_copy_only=False).astype(np.int32)
        return codes, len(enc.dictionary), len(al)

    if ncols == 1:
        codes, num, nl = combine(left[0], right[0])
        return codes[:nl], codes[nl:], num

    # Multi-column: encode each column against the union, then mix the
    # (small dense) per-column codes into one row code.  Null sentinels
    # (-1 left / -2 right) shift to 1 / 0 so they stay side-distinct and
    # disjoint from real codes (>= 2) in the mix.
    per_col = []
    widths = []
    nl = None
    for l, r in zip(left, right):
        codes, num, nl = combine(l, r)
        per_col.append(codes.astype(np.int64) + 2)
        widths.append(max(num, 1) + 2)
    mixed = per_col[0]
    for c, w in zip(per_col[1:], widths[1:]):
        mixed = mixed * w + c
    _, codes = np.unique(mixed, return_inverse=True)
    codes = codes.astype(np.int32)
    num = int(codes.max()) + 1 if len(codes) else 0
    return codes[:nl], codes[nl:], num


def merge_dictionaries(lvals: np.ndarray, rvals: np.ndarray):
    """Joint code space for two dictionary value arrays.

    Returns (remap_l, remap_r) int32 arrays mapping each side's local
    codes into the shared space.  Mismatched dtypes compare as strings
    (same coercion encode_join_keys applies at the column level)."""
    lv = np.asarray(lvals, dtype=object)
    rv = np.asarray(rvals, dtype=object)
    if len(lv) and len(rv):
        lt, rt = type(lv[0]), type(rv[0])
        if lt is not rt:
            lv = np.array([str(x) for x in lv], dtype=object)
            rv = np.array([str(x) for x in rv], dtype=object)
    both = np.concatenate([lv, rv])
    _, inv = np.unique(both, return_inverse=True)
    return inv[: len(lv)].astype(np.int32), inv[len(lv):].astype(np.int32)


def device_remaps(left: "Table", l_col, right: "Table", r_col):
    """Device-resident (remap_l, remap_r) for the co-sort count fallback."""
    raise NotImplementedError(
        "device_remaps feeds the co-sort count fallback, not ported yet "
        "(ROADMAP.md A5)"
    )


def pretty_format(table: Table) -> str:
    """DataFusion-style ASCII table, so reference expected outputs match.

    Format (see reference tests/integration_test.rs:44-63):
    +----+----+ borders, left-aligned cells, NULLs rendered empty.
    """
    names = table.column_names
    cols = []
    for i in range(len(names)):
        col = table.column(i)
        vals = []
        for v in col.to_pylist():
            if v is None:
                vals.append("")
            elif isinstance(v, bool):
                vals.append("true" if v else "false")
            elif isinstance(v, float) and v == int(v):
                vals.append(f"{v:.1f}")
            else:
                vals.append(str(v))
        cols.append(vals)
    widths = [
        max(len(names[i]), max((len(v) for v in cols[i]), default=0))
        for i in range(len(names))
    ]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep]
    lines.append(
        "|" + "|".join(f" {names[i]:<{widths[i]}} " for i in range(len(names))) + "|"
    )
    lines.append(sep)
    for r in range(table.num_rows):
        lines.append(
            "|"
            + "|".join(f" {cols[i][r]:<{widths[i]}} " for i in range(len(names)))
            + "|"
        )
    lines.append(sep)
    return "\n".join(lines)
