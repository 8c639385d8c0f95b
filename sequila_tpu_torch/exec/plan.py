"""Physical plan node base + simple operators (scan/filter/project/sort/...).

The engine's execution model is vectorized whole-table operators (each
``execute`` consumes child Tables and produces a Table), with chunking
inside the operators that need bounded memory — versus the reference's
pull-based async RecordBatch streams over tokio.  Display strings follow
DataFusion's `OpExec: k=v` convention so plan assertions written against
the reference port over directly.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.exec.context import ExecContext
from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.planner.expr import PhysicalExpr


class ExecPlan:
    children: list["ExecPlan"] = []

    def schema(self) -> list[tuple[str | None, str]]:
        """Qualified output column names [(qualifier, name), ...]."""
        raise NotImplementedError

    def execute(self, ctx: ExecContext) -> Table:
        raise NotImplementedError

    def execute_batches(self, ctx: ExecContext):
        """Batch-at-a-time execution: yield output Tables whose
        concatenation equals ``execute``'s result, without ever holding
        the full result (the engine's analog of the reference's pull-based
        RecordBatch streams + capped emission, interval_join.rs:1338-1420).

        Operators that can stream override this; the default materializes
        (one batch).  Row-wise operators (filter/project) forward their
        child's batching; barriers (sort/aggregate/window) materialize by
        construction."""
        yield self.execute(ctx)

    def statistics(self):
        """Estimated output statistics (reference ExecutionPlan::statistics,
        interval_join.rs:586-593).  Default: unknown; scans return exact
        table stats, joins return cardinality estimates."""
        from sequila_tpu_torch.exec.statistics import Statistics

        return Statistics.unknown()

    def display_line(self) -> str:
        raise NotImplementedError

    def explain(self, indent: int = 0, metrics=None, show_stats: bool = False) -> str:
        pad = "  " * indent
        line = pad + self.display_line()
        if show_stats:
            line += f", statistics=[{self.statistics().display()}]"
        if metrics is not None:
            m = metrics.format_op(self.op_id())
            if m:
                line += f", metrics=[{m}]"
        lines = [line]
        for c in self.children:
            lines.append(c.explain(indent + 1, metrics, show_stats))
        return "\n".join(lines)

    def op_id(self) -> str:
        return f"{type(self).__name__}@{id(self):x}"

    def transform_up(self, fn) -> "ExecPlan":
        """Bottom-up plan rewrite (the reference rule uses transform_up)."""
        new_children = [c.transform_up(fn) for c in self.children]
        node = self.with_children(new_children)
        return fn(node)

    def with_children(self, children: list["ExecPlan"]) -> "ExecPlan":
        if not children:
            return self
        raise NotImplementedError


def _object_codes_arrow(arr: np.ndarray):
    """(codes, width) for an object STRING column via arrow's C++
    dictionary encoder — ~20x faster than np.unique's object argsort at
    500k rows.  Codes keep _row_group_codes' contract (numbered in
    sorted value order, NULLs one own group sorting last); None when the
    column isn't all-strings (mixed cells fall back to np.unique)."""
    if len(arr) == 0:
        return None
    try:
        pa_arr = pa.array(arr, from_pandas=True)
    except (pa.ArrowInvalid, pa.ArrowTypeError):
        return None
    if not pa.types.is_string(pa_arr.type) and not pa.types.is_large_string(
        pa_arr.type
    ):
        return None
    enc = pa_arr.dictionary_encode()
    idx = enc.indices
    dictionary = enc.dictionary.to_numpy(zero_copy_only=False)
    # remap first-occurrence dictionary codes onto sorted-value ranks
    rank = np.empty(len(dictionary), np.int64)
    rank[np.argsort(dictionary)] = np.arange(len(dictionary))
    null = np.asarray(idx.is_null())
    raw = idx.fill_null(0).to_numpy(zero_copy_only=False).astype(np.int64)
    codes = rank[raw]
    width = len(dictionary) + 1
    codes[null] = width - 1  # NULLs form their own (last) group
    return codes, width


def _stable_argsort_int(v: np.ndarray) -> np.ndarray:
    """Stable argsort for integer/bool arrays via the threaded native
    radix when available; numpy stable sort otherwise."""
    from sequila_tpu_torch.native.loader import argsort64

    if len(v) >= (1 << 15) and _int64_safe(v):
        order = argsort64(v.astype(np.int64, copy=False))
        if order is not None:
            return order
    return np.argsort(v, kind="stable")


def _int64_safe(k: np.ndarray) -> bool:
    """True when casting to int64 preserves ordering: any signed
    integer/bool, or an unsigned array whose max fits in int64."""
    if k.dtype == np.bool_:
        return True
    if not np.issubdtype(k.dtype, np.integer):
        return False
    if np.issubdtype(k.dtype, np.unsignedinteger) and k.dtype.itemsize == 8:
        return len(k) == 0 or int(k.max()) <= np.iinfo(np.int64).max
    return True


def _unique_int64(v: np.ndarray, want_index: bool = False):
    """np.unique(v, return_index=want_index, return_inverse=True) for
    int64 arrays through the native radix argsort: (uniques, [first_idx,]
    inverse) with identical results (both stable)."""
    order = _stable_argsort_int(v)
    sv = v[order]
    first = np.ones(len(sv), bool)
    first[1:] = sv[1:] != sv[:-1]
    codes_sorted = np.cumsum(first) - 1
    inverse = np.empty(len(v), np.int64)
    inverse[order] = codes_sorted
    uniques = sv[first]
    if want_index:
        return uniques, order[first], inverse
    return uniques, inverse


def _row_group_codes(cols: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Dense row-group codes over possibly-string columns.

    Returns (codes[n], first_idx[ngroups]); groups are numbered in sorted
    order of their (lexicographic) column values, ``first_idx`` points at
    the first occurrence of each group.
    """
    combined = None
    for c in cols:
        arr = np.asarray(c)
        if arr.dtype == object:
            fast = _object_codes_arrow(arr)
            if fast is not None:
                col_codes, width = fast
                combined = (
                    col_codes if combined is None
                    else combined * width + col_codes
                )
                continue
            null = np.array([v is None or v != v for v in arr], dtype=bool) if len(arr) else np.zeros(0, bool)
        elif np.issubdtype(arr.dtype, np.floating):
            null = np.isnan(arr)
        elif np.issubdtype(arr.dtype, np.datetime64):
            # NaT != NaT, so np.unique would split NULLs into singleton
            # groups; view as int64 (NaT = INT64_MIN) and mask explicitly
            null = np.isnat(arr)
            arr = arr.view(np.int64)
        else:
            null = np.zeros(len(arr), bool)
        col_codes = np.zeros(len(arr), np.int64)
        nn = ~null
        if nn.any():
            vals = arr[nn]
            if len(vals) >= (1 << 15) and _int64_safe(np.asarray(vals)):
                _, nn_codes = _unique_int64(np.asarray(vals, np.int64))
            else:
                _, nn_codes = np.unique(vals, return_inverse=True)
            col_codes[nn] = nn_codes
            width = int(nn_codes.max()) + 2
        else:
            width = 2
        col_codes[null] = width - 1  # NULLs form their own group
        combined = col_codes if combined is None else combined * width + col_codes
    if len(combined) >= (1 << 15):
        _, first_idx, codes = _unique_int64(
            np.asarray(combined, np.int64), want_index=True
        )
    else:
        _, first_idx, codes = np.unique(
            combined, return_index=True, return_inverse=True
        )
    return codes, first_idx


class _LazyCols:
    """Column accessor that materializes only the referenced columns —
    expressions index `cols[i]`, so most operators never pay for
    converting unrelated (often string) columns to numpy."""

    def __init__(self, table: Table):
        self._t = table
        self._cache: dict = {}

    def __getitem__(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = self._t.column_np(i)
        return self._cache[i]


def _eval_on_table(expr: PhysicalExpr, table: Table) -> np.ndarray:
    return expr.eval(_LazyCols(table), table.num_rows)


class ScanExec(ExecPlan):
    def __init__(self, name: str, table: Table, qualifier: str | None = None):
        self.name = name
        self.table = table
        self.qualifier = qualifier or name
        self.children = []

    def schema(self):
        return [(self.qualifier, n) for n in self.table.column_names]

    def execute(self, ctx):
        ctx.metrics.add(self.op_id(), "output_rows", self.table.num_rows)
        return self.table

    def statistics(self):
        return self.table.statistics()

    def display_line(self):
        return f"ScanExec: table={self.name}, rows={self.table.num_rows}"


class FilterExec(ExecPlan):
    def __init__(self, child: ExecPlan, predicate: PhysicalExpr):
        self.children = [child]
        self.predicate = predicate

    def schema(self):
        return self.children[0].schema()

    def _apply(self, ctx, t: Table) -> Table:
        from sequila_tpu_torch.planner.expr import truth

        mask = truth(_eval_on_table(self.predicate, t))
        out = Table(t.arrow.filter(pa.array(mask)))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def execute(self, ctx):
        return self._apply(ctx, self.children[0].execute(ctx))

    def execute_batches(self, ctx):
        # row-wise: forwards the child's batching
        for t in self.children[0].execute_batches(ctx):
            yield self._apply(ctx, t)

    def statistics(self):
        # unknown filter selectivity: the child's stats demoted to inexact
        return self.children[0].statistics().to_inexact()

    def display_line(self):
        return f"FilterExec: {self.predicate.display()}"

    def with_children(self, children):
        return FilterExec(children[0], self.predicate)


class ProjectExec(ExecPlan):
    def __init__(
        self,
        child: ExecPlan,
        exprs: list[PhysicalExpr],
        names: list[str],
        qualifiers: list[str | None] | None = None,
    ):
        self.children = [child]
        self.exprs = exprs
        self.names = names
        self.qualifiers = qualifiers or [None] * len(names)

    def schema(self):
        return list(zip(self.qualifiers, self.names))

    def _apply(self, ctx, t: Table) -> Table:
        from sequila_tpu_torch.planner.expr import Column, to_output_array

        cols = _LazyCols(t)
        arrays = []
        for e in self.exprs:
            if isinstance(e, Column):
                # zero-copy passthrough: no numpy round trip
                arrays.append(t.arrow.column(e.index))
            else:
                arrays.append(to_output_array(e, cols, e.eval(cols, t.num_rows)))
        out = Table(pa.Table.from_arrays(arrays, names=self.names))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def execute(self, ctx):
        return self._apply(ctx, self.children[0].execute(ctx))

    def execute_batches(self, ctx):
        # row-wise: forwards the child's batching
        for t in self.children[0].execute_batches(ctx):
            yield self._apply(ctx, t)

    def statistics(self):
        from sequila_tpu_torch.exec.statistics import Precision, Statistics

        child = self.children[0].statistics()
        # row count survives projection; byte size / column stats do not
        return Statistics(child.num_rows, Precision.absent(), ())

    def display_line(self):
        items = ", ".join(
            f"{e.display()} as {n}" for e, n in zip(self.exprs, self.names)
        )
        return f"ProjectionExec: expr=[{items}]"

    def with_children(self, children):
        return ProjectExec(children[0], self.exprs, self.names, self.qualifiers)


class UnnestExec(ExecPlan):
    """Expand one list-typed output column into rows (DataFusion's
    projection-level unnest): each element produces a row with the other
    columns repeated; NULL and empty arrays produce no row.  Scalar
    (non-list) columns pass through unchanged."""

    def __init__(self, child: ExecPlan, col: int):
        self.children = [child]
        self.col = col

    def schema(self):
        return self.children[0].schema()

    def execute(self, ctx):
        import pyarrow.compute as pc

        t = self.children[0].execute(ctx)
        arr = t.arrow.column(self.col)
        if not (
            pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type)
        ):
            return t
        arr = arr.combine_chunks()
        parent = pc.list_parent_indices(arr)
        flat = arr.flatten()
        arrays = [
            flat if i == self.col else c.take(parent)
            for i, c in enumerate(t.arrow.columns)
        ]
        out = Table(pa.Table.from_arrays(arrays, names=t.column_names))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def display_line(self):
        return f"UnnestExec: column={self.col}"

    def with_children(self, children):
        return UnnestExec(children[0], self.col)


class SortExec(ExecPlan):
    def __init__(
        self,
        child: ExecPlan,
        sort_exprs: list[PhysicalExpr],
        ascending: list[bool],
        nulls_first: list[bool | None] | None = None,
    ):
        self.children = [child]
        self.sort_exprs = sort_exprs
        self.ascending = ascending
        # None = dialect default (NULLS LAST, matching DataFusion's
        # default of last for ASC)
        self.nulls_first = nulls_first or [None] * len(sort_exprs)

    def schema(self):
        return self.children[0].schema()

    def execute(self, ctx):
        t = self.children[0].execute(ctx)
        if t.num_rows == 0:
            return t
        cols = _LazyCols(t)
        keys = []
        # np.lexsort: last key is primary -> reverse order, invert descending.
        for e, asc, nf in zip(
            reversed(self.sort_exprs),
            reversed(self.ascending),
            reversed(self.nulls_first),
        ):
            k = np.asarray(e.eval(cols, t.num_rows))
            keys.extend(_sort_key_arrays(k, asc, nf))
        order = _fast_lexsort(keys)
        out = t.take(order)
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def statistics(self):
        return self.children[0].statistics()  # sorting preserves rows/bytes

    def display_line(self):
        items = ", ".join(
            f"{e.display()} {'ASC' if a else 'DESC'}"
            for e, a in zip(self.sort_exprs, self.ascending)
        )
        return f"SortExec: expr=[{items}]"

    def with_children(self, children):
        return SortExec(
            children[0], self.sort_exprs, self.ascending, self.nulls_first
        )


class LimitExec(ExecPlan):
    def __init__(self, child: ExecPlan, limit: int | None, offset: int = 0):
        self.children = [child]
        self.limit = limit
        self.offset = offset

    def schema(self):
        return self.children[0].schema()

    def execute(self, ctx):
        return self.children[0].execute(ctx).slice(self.offset, self.limit)

    def execute_batches(self, ctx):
        """Streaming LIMIT: stops pulling child batches once satisfied
        (a streaming child then never materializes its tail)."""
        skip = self.offset
        remaining = self.limit
        for t in self.children[0].execute_batches(ctx):
            if skip:
                if t.num_rows <= skip:
                    skip -= t.num_rows
                    continue
                t = t.slice(skip)
                skip = 0
            if remaining is not None:
                if remaining <= 0:
                    return
                if t.num_rows >= remaining:
                    yield t.slice(0, remaining)
                    return
                remaining -= t.num_rows
            yield t

    def statistics(self):
        from sequila_tpu_torch.exec.statistics import Precision, Statistics

        child = self.children[0].statistics()
        if child.num_rows.is_absent:
            if self.limit is None:
                return Statistics.unknown()
            return Statistics(Precision.inexact(self.limit), Precision.absent(), ())
        avail = max(int(child.num_rows.value) - self.offset, 0)
        rows = avail if self.limit is None else min(self.limit, avail)
        return Statistics(
            Precision(rows, child.num_rows.kind), Precision.absent(), ()
        )

    def display_line(self):
        s = f"LimitExec: fetch={self.limit}"
        if self.offset:
            s += f", skip={self.offset}"
        return s

    def with_children(self, children):
        return LimitExec(children[0], self.limit, self.offset)


def _unbox(x):
    """numpy scalar -> Python scalar (pa.array-friendly)."""
    return x.item() if hasattr(x, "item") else x


def _sql_text(x) -> str:
    """SQL text rendering for string_agg/group_concat elements."""
    if isinstance(x, str):
        return x
    if isinstance(x, (bool, np.bool_)):
        return "true" if x else "false"
    if isinstance(x, (float, np.floating)):
        f = float(x)
        return str(int(f)) if f.is_integer() and abs(f) < 2**53 else str(f)
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    return str(x)


def _dedupe_group_values(codes, a):
    """Unique (group, value) pairs — the DISTINCT pre-step for
    sum/avg/count/median/stddev (NULLs must already be removed)."""
    if len(codes) == 0:
        return codes, a
    if a.dtype == object:
        uniq, inv = np.unique(a, return_inverse=True)
        key = codes.astype(np.int64) * max(len(uniq), 1) + inv
        _, ui = np.unique(key, return_index=True)
        return codes[ui], a[ui]
    order = np.lexsort((a, codes))
    cs, vs = codes[order], a[order]
    first = np.ones(len(cs), bool)
    first[1:] = (cs[1:] != cs[:-1]) | (vs[1:] != vs[:-1])
    return cs[first], vs[first]


def _group_segments(codes, ngroups):
    """(stable order, per-group segment starts, per-group counts)."""
    order = _stable_argsort_int(np.asarray(codes))
    counts = np.bincount(codes, minlength=ngroups).astype(np.int64)
    seg_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    return order, seg_starts, counts


def _fast_lexsort(keys) -> np.ndarray:
    """np.lexsort with a native fast path (least-significant key first).

    When every key is integer/bool and the combined value ranges bit-pack
    into one 63-bit composite (the overwhelmingly common case: dictionary
    ranks, i32 coordinates, 1-bit null-placement keys), the sort runs
    through the threaded native radix argsort (si_argsort64, ~3.5x numpy
    lexsort at 500k rows); a single int64 key skips packing entirely.
    Results are identical to np.lexsort (both stable)."""
    from sequila_tpu_torch.native.loader import argsort64

    keys = [np.asarray(k) for k in keys]
    if len(keys) == 0:
        return np.empty(0, np.intp)
    n = len(keys[0])
    if n < (1 << 15):  # pool/packing overhead beats numpy only at scale
        return np.lexsort(tuple(keys))
    ints = all(_int64_safe(k) for k in keys)
    if ints:
        if len(keys) == 1:
            k = keys[0].astype(np.int64, copy=False)
            order = argsort64(k)
            if order is not None:
                return order
            return np.lexsort(tuple(keys))
        comp = None
        bits = 0
        ok = True
        # most-significant key first: np.lexsort's LAST key is primary
        for k in reversed(keys):
            k = k.astype(np.int64, copy=False)
            lo, hi = int(k.min()), int(k.max())
            span = hi - lo + 1
            width = max(int(span - 1).bit_length(), 1)
            if bits + width > 63:
                ok = False
                break
            comp = (k - lo) if comp is None else ((comp << width) | (k - lo))
            bits += width
        if ok:
            order = argsort64(comp)
            if order is not None:
                return order
    return np.lexsort(tuple(keys))


def _sort_key_arrays(k: np.ndarray, asc: bool, nulls_first) -> list:
    """np.lexsort keys for ONE sort column: the value key plus (when
    NULLs are present) a dominating null-placement key.  Default NULL
    placement is LAST for ASC, FIRST for DESC (DataFusion/Postgres).
    Shared by SortExec and aggregate-internal ORDER BY so the two can
    never drift."""
    from sequila_tpu_torch.planner.expr import _null_mask

    k = np.asarray(k)
    nulls = _null_mask(k)
    if np.issubdtype(k.dtype, np.datetime64) or np.issubdtype(
        k.dtype, np.timedelta64
    ):
        # int64 view: NaT (INT64_MIN) is dominated by the null key below,
        # and DESC negation needs a number
        k = k.view(np.int64)
    if k.dtype == object:
        # string columns: arrow dictionary ranks instead of object
        # compares (object lexsort/argsort is ~20x slower at 500k rows);
        # null rows get the last rank, dominated by the null key below
        enc = _object_codes_arrow(k)
        if enc is not None:
            k = enc[0]
    if k.dtype == object and nulls.any():
        # np.unique can't mix None with values; rank non-nulls
        ranks = np.zeros(len(k), np.int64)
        nn = ~nulls
        if nn.any():
            _, inv = np.unique(k[nn], return_inverse=True)
            ranks[nn] = inv
        k = ranks
    if not asc:
        if np.issubdtype(np.asarray(k).dtype, np.number):
            k = -np.asarray(k)
        else:
            # lexsort on object arrays cannot negate; rank-invert
            _, inv = np.unique(k, return_inverse=True)
            k = -inv
    out = [np.asarray(k)]
    if nulls.any():
        # appended after the value key -> more significant in lexsort
        first = bool(nulls_first) if nulls_first is not None else (not asc)
        out.append(np.where(nulls, 0 if first else 1, 1 if first else 0))
    return out


def _agg_order_perm(ord_spec, cols, n, mask):
    """Stable row permutation realizing aggregate-internal ORDER BY
    (array_agg(x ORDER BY y)) — same key construction as SortExec via
    _sort_key_arrays; ties keep input order (lexsort is stable)."""
    keys = []
    for oe, asc, nulls_first in reversed(ord_spec):
        a = np.asarray(oe.eval(cols, n))
        if mask is not None:
            a = a[mask]
        keys.extend(_sort_key_arrays(a, asc, nulls_first))
    return _fast_lexsort(keys)


class AggregateExec(ExecPlan):
    """Hash/group aggregate: group-by codes via np.unique + segmented
    reduce.  ``grouping_sets`` (ROLLUP/CUBE/GROUPING SETS expansion from
    the binder) runs the same segmented aggregation once per index set
    over one evaluation of the child, NULL-filling excluded group
    columns.  Each spec is (func, arg, distinct, out_name, filter):
    ``arg`` is None for count(*), a PhysicalExpr, or a tuple of two for
    the two-argument aggregates; ``filter`` is the bound
    FILTER (WHERE ...) predicate or None."""

    def __init__(
        self,
        child: ExecPlan,
        group_exprs: list[PhysicalExpr],
        group_names: list[str],
        agg_specs: list[tuple],
        grouping_sets: list[tuple] | None = None,
    ):
        self.children = [child]
        self.group_exprs = group_exprs
        self.group_names = group_names
        self.agg_specs = agg_specs
        self.grouping_sets = grouping_sets

    def schema(self):
        return [(None, n) for n in self.group_names] + [
            (None, s[3]) for s in self.agg_specs
        ]

    def execute(self, ctx):
        t = self.children[0].execute(ctx)
        n = t.num_rows
        cols = _LazyCols(t)
        gvals = [np.asarray(e.eval(cols, n)) for e in self.group_exprs]
        sets = self.grouping_sets
        if sets is None:
            sets = [tuple(range(len(gvals)))]
        pieces = [self._agg_one_set(cols, n, gvals, gset) for gset in sets]
        if len(pieces) == 1:
            out = Table(pieces[0])
        else:
            # NULL-filled group columns are typed null; permissive
            # promotion unifies them with the typed pieces
            from sequila_tpu_torch.models.table import concat_tables_unify

            out = Table(concat_tables_unify(pieces))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def _agg_one_set(self, cols, n, gvals, gset) -> pa.Table:
        sel_vals = [gvals[i] for i in gset]
        if sel_vals:
            codes, first_idx = _row_group_codes(sel_vals)
            ngroups = len(first_idx)
        else:
            codes = np.zeros(n, dtype=np.int64)
            ngroups = 1
            first_idx = None

        arrays, names = [], []
        from sequila_tpu_torch.planner.expr import (
            _null_mask, to_output_array, truth,
        )

        for i, g in enumerate(gvals):
            if i in gset:
                # group-key expressions carry the engine NULL encodings;
                # restore real nulls and the inferred type in the output
                arrays.append(
                    to_output_array(self.group_exprs[i], cols, g[first_idx])
                )
            else:
                arrays.append(pa.nulls(ngroups))
            names.append(self.group_names[i])

        # shared (unfiltered) segment layout, computed lazily once
        base_seg = None

        for spec in self.agg_specs:
            func, arg, distinct, out_name, *rest = spec
            filt = rest[0] if rest else None
            ord_spec = rest[1] if len(rest) > 1 else None
            if func == "grouping":
                flag = self._grouping_flag(arg, gset)
                arrays.append(pa.array(np.full(ngroups, flag, np.int64)))
                names.append(out_name)
                continue
            if filt is not None:
                mask = truth(np.asarray(filt.eval(cols, n)))
                codes_e = codes[mask]
                seg = _group_segments(codes_e, ngroups)
            else:
                mask = None
                codes_e = codes
                if base_seg is None:
                    base_seg = _group_segments(codes, ngroups)
                seg = base_seg
            vals = self._compute_agg(
                func, arg, distinct, cols, n, mask, codes_e, ngroups, seg,
                ord_spec,
            )
            # integer-typed sum/min/max/... keep Int64 in the output (the
            # engine computes them in float to carry NULLs as NaN)
            type_expr = (
                arg
                if func in ("sum", "min", "max", "first_value", "last_value")
                and arg is not None
                and not isinstance(arg, tuple)
                else None
            )
            arrays.append(to_output_array(type_expr, cols, vals))
            names.append(out_name)
        return pa.Table.from_arrays(arrays, names=names)

    def _grouping_flag(self, arg, gset) -> int:
        """GROUPING(col): 0 when the column is part of this grouping set,
        1 when it is aggregated away."""
        for i, ge in enumerate(self.group_exprs):
            if ge == arg:
                return 0 if i in gset else 1
        raise ExecutionError(
            "GROUPING() argument must be a GROUP BY expression"
        )

    def _compute_agg(
        self, func, arg, distinct, cols, n, mask, codes, ngroups, seg,
        ord_spec=None,
    ):
        """One aggregate column over one grouping set.  ``codes`` /
        ``seg`` are already restricted to FILTER-passing rows.
        ``ord_spec`` (agg-internal ORDER BY — array_agg(x ORDER BY y))
        permutes the rows before the order-sensitive collectors run."""
        from sequila_tpu_torch.planner.expr import _null_mask

        perm = None
        if ord_spec is not None:
            perm = _agg_order_perm(ord_spec, cols, n, mask)
            codes = codes[perm]
            seg = _group_segments(codes, ngroups)
        order, seg_starts, seg_counts = seg
        nrows = len(codes)

        def eval_arg(e):
            a = np.asarray(e.eval(cols, n))
            if mask is not None:
                a = a[mask]
            if perm is not None:
                a = a[perm]
            return a

        if func == "count" and arg is None and not distinct:
            return np.bincount(codes, minlength=ngroups).astype(np.int64)

        # -- two-argument aggregates ------------------------------------
        if func.startswith("regr_"):
            # Postgres/DataFusion regr_*(Y, X): dependent variable first;
            # rows where either side is NULL are excluded
            ey, ex = arg
            ay_, ax_ = eval_arg(ey), eval_arg(ex)
            nulls = _null_mask(ax_) | _null_mask(ay_)
            nn = ~nulls
            c = codes[nn]
            x = ax_[nn].astype(np.float64)
            y = ay_[nn].astype(np.float64)
            cnt = np.bincount(c, minlength=ngroups)
            if func == "regr_count":
                return cnt.astype(np.int64)
            cnt_safe = np.maximum(cnt, 1)
            mx = np.bincount(c, weights=x, minlength=ngroups) / cnt_safe
            my = np.bincount(c, weights=y, minlength=ngroups) / cnt_safe
            if func == "regr_avgx":
                return pa.array(mx, mask=cnt == 0)
            if func == "regr_avgy":
                return pa.array(my, mask=cnt == 0)
            sxx = np.bincount(c, weights=(x - mx[c]) ** 2, minlength=ngroups)
            if func == "regr_sxx":
                return pa.array(sxx, mask=cnt == 0)
            syy = np.bincount(c, weights=(y - my[c]) ** 2, minlength=ngroups)
            if func == "regr_syy":
                return pa.array(syy, mask=cnt == 0)
            sxy = np.bincount(
                c, weights=(x - mx[c]) * (y - my[c]), minlength=ngroups
            )
            if func == "regr_sxy":
                return pa.array(sxy, mask=cnt == 0)
            bad = (cnt == 0) | (sxx == 0)  # vertical line: undefined fit
            sxx_safe = np.where(bad, 1.0, sxx)
            slope = sxy / sxx_safe
            if func == "regr_slope":
                return pa.array(slope, mask=bad)
            if func == "regr_intercept":
                return pa.array(my - slope * mx, mask=bad)
            # regr_r2: NULL when sxx = 0; 1 when syy = 0 (perfect fit)
            with np.errstate(invalid="ignore", divide="ignore"):
                r2 = np.where(
                    syy == 0, 1.0, sxy * sxy / (sxx_safe * np.where(syy == 0, 1.0, syy))
                )
            return pa.array(r2, mask=bad)

        if func in ("corr", "covar", "covar_samp", "covar_pop"):
            ax, ay = (eval_arg(e) for e in arg)
            nulls = _null_mask(ax) | _null_mask(ay)
            nn = ~nulls
            c = codes[nn]
            x = ax[nn].astype(np.float64)
            y = ay[nn].astype(np.float64)
            cnt = np.bincount(c, minlength=ngroups)
            sx = np.bincount(c, weights=x, minlength=ngroups)
            sy = np.bincount(c, weights=y, minlength=ngroups)
            cnt_safe = np.maximum(cnt, 1)
            mx, my = sx / cnt_safe, sy / cnt_safe
            dxy = np.bincount(
                c, weights=(x - mx[c]) * (y - my[c]), minlength=ngroups
            )
            if func == "covar_pop":
                return pa.array(dxy / cnt_safe, mask=cnt == 0)
            if func in ("covar", "covar_samp"):
                return pa.array(
                    dxy / np.maximum(cnt - 1, 1), mask=cnt < 2
                )
            # corr: NULL when < 2 rows or either variance is zero
            dxx = np.bincount(c, weights=(x - mx[c]) ** 2, minlength=ngroups)
            dyy = np.bincount(c, weights=(y - my[c]) ** 2, minlength=ngroups)
            denom = np.sqrt(dxx * dyy)
            bad = (cnt < 2) | (denom == 0)
            with np.errstate(invalid="ignore", divide="ignore"):
                r = dxy / np.where(bad, 1.0, denom)
            return pa.array(r, mask=bad)

        if func == "approx_percentile_cont":
            # exact linear-interpolated percentile (superset of
            # DataFusion's t-digest approximation, like approx_median)
            from sequila_tpu_torch.planner.expr import Literal as PLiteral

            val_expr, p_expr = arg
            if not isinstance(p_expr, PLiteral):
                raise ExecutionError(
                    "approx_percentile_cont fraction must be a literal"
                )
            p = float(p_expr.value)
            if not 0.0 <= p <= 1.0:
                raise ExecutionError(
                    "percentile fraction must be between 0 and 1"
                )
            a = eval_arg(val_expr)
            nulls = _null_mask(a)
            nn = ~nulls
            c = codes[nn]
            v = a[nn].astype(np.float64)
            o = np.lexsort((v, c))
            cs, vs = c[o], v[o]
            cnt = np.bincount(cs, minlength=ngroups)
            offs = np.concatenate([[0], np.cumsum(cnt)])[:-1]
            res = np.full(ngroups, np.nan)
            ne = cnt > 0
            if ne.any():
                tgt = (cnt[ne] - 1) * p
                lo_i = np.floor(tgt).astype(np.int64)
                hi_i = np.ceil(tgt).astype(np.int64)
                frac = tgt - lo_i
                lo_v = vs[offs[ne] + lo_i]
                hi_v = vs[offs[ne] + hi_i]
                res[ne] = lo_v + (hi_v - lo_v) * frac
            return pa.array(res, mask=cnt == 0)

        if func in ("string_agg", "group_concat"):
            if isinstance(arg, tuple):
                val_expr, sep_expr = arg
                from sequila_tpu_torch.planner.expr import Literal as PLiteral

                if not isinstance(sep_expr, PLiteral):
                    raise ExecutionError(
                        f"{func} separator must be a literal"
                    )
                sep = "" if sep_expr.value is None else str(sep_expr.value)
            else:
                val_expr, sep = arg, ","
            a = eval_arg(val_expr)
            nulls = _null_mask(a)
            nn = ~nulls
            c, v = codes[nn], a[nn]
            if distinct:
                c, v = _dedupe_group_values(c, v)
                o = np.argsort(c, kind="stable")
            else:
                o = np.lexsort((np.arange(len(c)), c))  # input order
            cs, vs = c[o], v[o]
            cnt = np.bincount(cs, minlength=ngroups)
            groups = np.split(vs, np.cumsum(cnt)[:-1]) if ngroups else []
            return pa.array(
                [
                    sep.join(_sql_text(x) for x in g) if len(g) else None
                    for g in groups
                ],
                type=pa.string(),
            )

        if func == "array_agg":
            a = eval_arg(arg)
            if distinct:
                nulls = _null_mask(a)
                c, v = _dedupe_group_values(codes[~nulls], a[~nulls])
                o = np.argsort(c, kind="stable")
            else:
                # array_agg keeps NULL elements (Postgres semantics)
                c, v = codes, a
                o = order
            cs, vs = c[o], v[o]
            cnt = np.bincount(cs, minlength=ngroups)
            groups = np.split(vs, np.cumsum(cnt)[:-1]) if ngroups else []
            pylists = [
                [None if x != x or x is None else _unbox(x) for x in g]
                if len(g)
                else None
                for g in groups
            ]
            return pa.array(pylists)

        if func in ("first_value", "last_value"):
            a = eval_arg(arg)
            a_s = a[order]
            res = []
            for g in range(ngroups):
                if seg_counts[g] == 0:
                    res.append(None)
                else:
                    pos = (
                        seg_starts[g]
                        if func == "first_value"
                        else seg_starts[g] + seg_counts[g] - 1
                    )
                    x = a_s[pos]
                    res.append(None if x is None or x != x else _unbox(x))
            return pa.array(res)

        # -- single-argument aggregates ---------------------------------
        a = eval_arg(arg)
        nulls = _null_mask(a)

        if func == "count" and not distinct:
            return np.bincount(codes[~nulls], minlength=ngroups).astype(
                np.int64
            )
        if func in ("count", "approx_distinct"):
            c, _ = _dedupe_group_values(codes[~nulls], a[~nulls])
            return np.bincount(c, minlength=ngroups).astype(np.int64)

        if func in ("bool_and", "bool_or"):
            nn = ~nulls
            c = codes[nn]
            v = np.asarray(a[nn], np.float64) != 0
            cnt = np.bincount(c, minlength=ngroups)
            hits = np.bincount(c[v], minlength=ngroups)
            res = hits == cnt if func == "bool_and" else hits > 0
            return pa.array(res, mask=cnt == 0)

        if func in ("bit_and", "bit_or", "bit_xor"):
            nn = ~nulls
            c = codes[nn]
            v = np.asarray(a[nn], np.float64).astype(np.int64)
            cnt = np.bincount(c, minlength=ngroups)
            ufunc, init = {
                "bit_and": (np.bitwise_and, -1),
                "bit_or": (np.bitwise_or, 0),
                "bit_xor": (np.bitwise_xor, 0),
            }[func]
            res = np.full(ngroups, init, np.int64)
            ufunc.at(res, c, v)
            return pa.array(res, mask=cnt == 0)

        if distinct and func not in ("min", "max"):
            # DISTINCT changes sum/avg/median/stddev...: reduce to unique
            # (group, value) pairs first
            c, v = _dedupe_group_values(codes[~nulls], a[~nulls])
            codes = c
            a = v
            nulls = np.zeros(len(v), bool)
            order, seg_starts, seg_counts = _group_segments(codes, ngroups)
            nrows = len(codes)

        if func in (
            "stddev", "stddev_samp", "stddev_pop",
            "var", "var_samp", "var_pop", "variance",
        ):
            nn = ~nulls
            c = codes[nn]
            v = a[nn].astype(np.float64)
            cnt = np.bincount(c, minlength=ngroups)
            s1 = np.bincount(c, weights=v, minlength=ngroups)
            mean = s1 / np.maximum(cnt, 1)
            m2 = np.bincount(c, weights=(v - mean[c]) ** 2, minlength=ngroups)
            pop = func in ("stddev_pop", "var_pop")
            denom = cnt if pop else np.maximum(cnt - 1, 1)
            bad = (cnt == 0) if pop else (cnt < 2)
            with np.errstate(invalid="ignore", divide="ignore"):
                res = m2 / np.where(bad, 1.0, denom)
            if func.startswith("stddev"):
                res = np.sqrt(res)
            return pa.array(res, mask=bad)

        if func in ("median", "approx_median"):
            nn = ~nulls
            c = codes[nn]
            v = a[nn].astype(np.float64)
            o = np.lexsort((v, c))
            cs, vs = c[o], v[o]
            cnt = np.bincount(cs, minlength=ngroups)
            offs = np.concatenate([[0], np.cumsum(cnt)])[:-1]
            res = np.full(ngroups, np.nan)
            ne = cnt > 0
            if ne.any():
                lo = vs[offs[ne] + (cnt[ne] - 1) // 2]
                hi = vs[offs[ne] + cnt[ne] // 2]
                res[ne] = (lo + hi) / 2.0
            return pa.array(res, mask=cnt == 0)

        if func in ("min", "max") and a.dtype == object:
            # strings (or mixed objects): ordinal-encode the non-null
            # values, reduce on codes, map back
            if nrows == 0:
                return pa.array([None] * ngroups, type=pa.string())
            nn = ~nulls
            uniq, inv = (
                np.unique(a[nn], return_inverse=True)
                if nn.any()
                else (np.array([], dtype=object), np.array([], np.int64))
            )
            codes_o = np.full(nrows, len(uniq) if func == "min" else -1,
                              np.int64)
            codes_o[nn] = inv
            red = np.minimum if func == "min" else np.maximum
            # FILTERed/grouping-set groups can be empty with seg_start ==
            # nrows; pad with the reduction identity so that is a valid
            # reduceat boundary (clamping it would TRUNCATE the previous
            # group's segment — the clamp-to-nrows-1 bug)
            sentinel = len(uniq) if func == "min" else -1
            padded = np.concatenate(
                [codes_o[order], np.array([sentinel], np.int64)]
            )
            agg = red.reduceat(padded, seg_starts)
            nn_cnt = np.bincount(codes[nn], minlength=ngroups)
            return pa.array(
                [
                    None if nn_cnt[g] == 0 or seg_counts[g] == 0
                    else uniq[agg[g]]
                    for g in range(ngroups)
                ]
            )

        if np.issubdtype(a.dtype, np.datetime64) and func in (
            "sum", "min", "max", "avg"
        ):
            if func in ("sum", "avg"):
                raise ExecutionError(
                    f"{func}() over date/timestamp values is not supported"
                )
            nn = ~nulls
            c = codes[nn]
            v = a.view(np.int64)[nn]
            cnt = np.bincount(c, minlength=ngroups)
            red = np.minimum if func == "min" else np.maximum
            init = (
                np.iinfo(np.int64).max if func == "min"
                else np.iinfo(np.int64).min
            )
            res = np.full(ngroups, init, np.int64)
            red.at(res, c, v)
            return pa.array(res.view(a.dtype), mask=cnt == 0)

        if func in ("sum", "min", "max", "avg"):
            red = {"sum": np.add, "min": np.minimum,
                   "max": np.maximum, "avg": np.add}[func]
            if nrows == 0:
                # SQL: sum/min/max/avg over zero rows is NULL, not 0
                return pa.array([None] * ngroups, type=pa.float64())
            a_s = a[order]
            null_s = nulls[order]
            empty = seg_counts == 0
            if nulls.any() or empty.any():
                # SQL aggregates skip NULLs; all-NULL groups are NULL.
                # Empty groups (FILTER / grouping sets) can have
                # seg_start == nrows: pad with the reduction identity so
                # that is a valid reduceat boundary — clamping instead
                # would TRUNCATE the previous group's segment
                fill = {"sum": 0.0, "avg": 0.0,
                        "min": np.inf, "max": -np.inf}[func]
                af = np.concatenate(
                    [a_s.astype(np.float64), np.array([fill])]
                )
                af[:-1][null_s] = fill
                agg = red.reduceat(af, seg_starts)
                nn_cnt = np.bincount(codes[~nulls], minlength=ngroups)
                if func == "avg":
                    agg = agg / np.maximum(nn_cnt, 1)
                return pa.array(agg, mask=(nn_cnt == 0) | empty)
            vals = red.reduceat(a_s, seg_starts)
            if func == "avg":
                vals = vals / np.maximum(seg_counts, 1)
            return vals

        raise ExecutionError(f"unsupported aggregate: {func}")

    def display_line(self):
        aggs = ", ".join(s[3] for s in self.agg_specs)
        gb = ", ".join(e.display() for e in self.group_exprs)
        line = f"AggregateExec: groupBy=[{gb}], aggr=[{aggs}]"
        if self.grouping_sets is not None:
            line += f", grouping_sets={len(self.grouping_sets)}"
        return line

    def with_children(self, children):
        return AggregateExec(
            children[0], self.group_exprs, self.group_names,
            self.agg_specs, self.grouping_sets,
        )


_WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "lag", "lead",
    "sum", "count", "avg", "min", "max", "first_value", "last_value",
    "nth_value", "ntile",
}


class WindowExec(ExecPlan):
    """Vectorized window functions over the child's output.

    Each spec is (func, args, partition_exprs, order_exprs, asc, name).
    Semantics follow DataFusion/standard SQL defaults: ranking functions
    need ORDER BY; aggregates without ORDER BY run over the whole
    partition; with ORDER BY they are running aggregates with RANGE
    peers (tied order keys share the value at the peer group's end);
    last_value with ORDER BY is the current peer group's last row (the
    standard default-frame gotcha).  The reference inherits windowing
    wholesale from DataFusion (never exercised in its tests)."""

    def __init__(self, child: ExecPlan, specs):
        self.children = [child]
        self.specs = specs

    def schema(self):
        return self.children[0].schema() + [
            (None, sp[5]) for sp in self.specs
        ]

    @staticmethod
    def _order_codes(vals, asc, nf=None):
        """Dense sortable int codes for one ORDER BY key (any dtype),
        honoring NULLS FIRST/LAST (default: LAST for ASC, FIRST for DESC
        — the DataFusion/Postgres convention)."""
        from sequila_tpu_torch.planner.expr import _null_mask

        codes, _ = _row_group_codes([vals])
        k = codes if asc else -codes
        nulls = _null_mask(np.asarray(vals))
        if not nulls.any():
            return k
        first = bool(nf) if nf is not None else (not asc)
        big = int(np.abs(k).max()) + 1 if len(k) else 1
        return np.where(nulls, -big if first else big, k)

    def execute(self, ctx):
        t = self.children[0].execute(ctx)
        n = t.num_rows
        cols = _LazyCols(t)
        arrays = list(t.arrow.columns)
        names = [n2 for _, n2 in self.children[0].schema()]
        for spec in self.specs:
            func, args, parts, orders, ascs, out_name = spec[:6]
            frame = spec[6] if len(spec) > 6 else None
            nfs = spec[7] if len(spec) > 7 else None
            fkind = spec[8] if len(spec) > 8 else "rows"
            v = self._compute(
                func, args, parts, orders, ascs, cols, n, frame, nfs, fkind
            )
            arrays.append(v if isinstance(v, pa.Array) else pa.array(v))
            names.append(out_name)
        out = Table(pa.Table.from_arrays(arrays, names=names))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def _compute(
        self, func, args, parts, orders, ascs, cols, n,
        frame=None, nfs=None, fkind="rows",
    ):
        if n == 0:
            return np.empty(0, np.int64 if func in ("row_number", "rank", "dense_rank", "count") else np.float64)
        pvals = [np.asarray(e.eval(cols, n)) for e in parts]
        seg_codes, _ = _row_group_codes(pvals) if pvals else (np.zeros(n, np.int64), [0])
        nfs = nfs or [None] * len(orders)
        ocodes = [
            self._order_codes(np.asarray(e.eval(cols, n)), asc, nf)
            for e, asc, nf in zip(orders, ascs, nfs)
        ]
        # primary: partition, then order keys; np.lexsort is stable so
        # input order breaks remaining ties deterministically
        order = _fast_lexsort(list(reversed(ocodes)) + [seg_codes])
        segs = seg_codes[order]
        new_seg = np.ones(n, bool)
        new_seg[1:] = segs[1:] != segs[:-1]
        seg_id = np.cumsum(new_seg) - 1
        seg_first = np.nonzero(new_seg)[0]
        pos = np.arange(n)
        idx_in_seg = pos - seg_first[seg_id]
        if ocodes:
            o_sorted = [oc[order] for oc in ocodes]
            new_peer = new_seg.copy()
            for oc in o_sorted:
                new_peer[1:] |= oc[1:] != oc[:-1]
        else:
            new_peer = new_seg.copy()
        peer_id = np.cumsum(new_peer) - 1
        peer_first = np.nonzero(new_peer)[0]
        peer_last = np.append(peer_first[1:], n) - 1

        if func == "row_number":
            vals = (idx_in_seg + 1).astype(np.int64)
        elif func == "rank":
            vals = (peer_first[peer_id] - seg_first[seg_id] + 1).astype(np.int64)
        elif func == "dense_rank":
            dp = np.cumsum(new_peer)
            vals = (dp - dp[seg_first[seg_id]] + 1).astype(np.int64)
        elif func == "ntile":
            k = int(args[0])
            seg_len = np.append(seg_first[1:], n) - seg_first
            sl = seg_len[seg_id]
            vals = (idx_in_seg * k // np.maximum(sl, 1) + 1).astype(np.int64)
        elif func == "percent_rank":
            # (rank - 1) / (partition rows - 1); one-row partition -> 0
            rank = (peer_first[peer_id] - seg_first[seg_id]).astype(np.float64)
            seg_len = (np.append(seg_first[1:], n) - seg_first)[seg_id]
            vals = np.where(
                seg_len > 1, rank / np.maximum(seg_len - 1, 1), 0.0
            )
        elif func == "cume_dist":
            # rows with peers <= current / partition rows
            through = (
                peer_last[peer_id] - seg_first[seg_id] + 1
            ).astype(np.float64)
            seg_len = (np.append(seg_first[1:], n) - seg_first)[seg_id]
            vals = through / np.maximum(seg_len, 1)
        elif func == "nth_value":
            a = np.asarray(args[0].eval(cols, n))[order]
            k = int(args[1])
            if frame is not None:
                w_lo, w_hi = self._explicit_bounds(
                    frame, fkind, orders, ascs, nfs, cols, n, order,
                    seg_first, seg_id, pos,
                )
                target = w_lo + (k - 1)
                ok = (k >= 1) & (target < w_hi)
            else:
                target = seg_first[seg_id] + (k - 1)
                # default frame: partition start .. current peer-group end
                limit = (
                    peer_last[peer_id]
                    if ocodes
                    else (np.append(seg_first[1:], n) - 1)[seg_id]
                )
                ok = (k >= 1) & (target <= limit)
            vals = self._pick_values(a, target, ok, n)
        elif func in ("lag", "lead"):
            a = np.asarray(args[0].eval(cols, n))[order]
            k = int(args[1]) if len(args) > 1 else 1
            default = args[2] if len(args) > 2 else None
            shifted = np.empty(n, dtype=object)
            if func == "lag":
                shifted[k:] = a[:-k] if k else a
                shifted[:k] = default
                invalid = idx_in_seg < k
            else:
                if k:
                    shifted[:-k] = a[k:]
                    shifted[-k:] = default
                else:
                    shifted[:] = a
                seg_len = np.append(seg_first[1:], n) - seg_first
                invalid = idx_in_seg >= seg_len[seg_id] - k
            shifted[invalid] = default
            vals = shifted
        elif func in ("first_value", "last_value"):
            a = np.asarray(args[0].eval(cols, n))[order]
            if frame is not None:
                w_lo, w_hi = self._explicit_bounds(
                    frame, fkind, orders, ascs, nfs, cols, n, order,
                    seg_first, seg_id, pos,
                )
                nonempty = w_hi > w_lo
                target = np.where(
                    nonempty, w_lo if func == "first_value" else w_hi - 1, 0
                )
                vals = self._pick_values(a, target, nonempty, n)
            elif func == "first_value":
                vals = a[seg_first[seg_id]]
            elif ocodes:
                vals = a[peer_last[peer_id]]  # default frame ends at peers
            else:
                seg_last = np.append(seg_first[1:], n) - 1
                vals = a[seg_last[seg_id]]
        elif func in ("sum", "count", "avg", "min", "max"):
            from sequila_tpu_torch.planner.expr import _null_mask

            # SQL window aggregates skip NULLs (like regular aggregates):
            # nn = per-row "counts toward the aggregate" indicator
            str_map = None
            if func == "count" and not args:
                a = np.ones(n)
                nn = np.ones(n, dtype=bool)
            else:
                raw = np.asarray(args[0].eval(cols, n))
                nulls = _null_mask(raw)
                if raw.dtype == object and func in ("min", "max"):
                    # strings: ordinal-encode, reduce on codes, map back
                    nn0 = ~nulls
                    uniq, inv = (
                        np.unique(raw[nn0], return_inverse=True)
                        if nn0.any()
                        else (np.array([], dtype=object), np.array([], np.int64))
                    )
                    enc = np.zeros(n)
                    enc[nn0] = inv.astype(np.float64)
                    a = enc[order]
                    str_map = uniq
                elif raw.dtype == object:
                    try:
                        a = np.where(
                            nulls, 0.0,
                            np.array([0.0 if x is None else float(x) for x in raw]),
                        )[order]
                    except (TypeError, ValueError):
                        raise ExecutionError(
                            f"window {func}() requires a numeric column"
                        )
                else:
                    a = np.where(nulls, 0.0, raw.astype(np.float64))[order]
                nn = (~nulls)[order]
                if func in ("min", "max"):
                    a = np.where(nn, a, np.inf if func == "min" else -np.inf)
            nn_f = nn.astype(np.float64)
            null_out = None
            if frame is not None:
                bounds = (
                    self._explicit_bounds(
                        frame, fkind, orders, ascs, nfs, cols, n, order,
                        seg_first, seg_id, pos,
                    )
                    if fkind == "range"
                    else None
                )
                vals, cnt = self._frame_agg(
                    func, a, nn_f, frame, seg_first, seg_id, pos, n, bounds
                )
                null_out = cnt == 0
            elif not ocodes:
                # whole-partition aggregate broadcast
                red = {"sum": np.add, "count": np.add, "avg": np.add,
                       "min": np.minimum, "max": np.maximum}[func]
                agg = red.reduceat(nn_f if func == "count" else a, seg_first)
                cnt = np.add.reduceat(nn_f, seg_first)
                if func == "avg":
                    agg = agg / np.maximum(cnt, 1)
                vals = agg[seg_id]
                null_out = (cnt == 0)[seg_id]
            else:
                # running aggregate, RANGE peers (value at peer-group end)
                ccnt = np.cumsum(nn_f)
                seg_base_c = np.where(seg_first[seg_id] > 0,
                                      ccnt[np.maximum(seg_first[seg_id] - 1, 0)], 0.0)
                run_cnt = ccnt - seg_base_c
                if func in ("sum", "avg", "count"):
                    base = nn_f if func == "count" else a
                    cs = np.cumsum(base)
                    seg_base = np.where(seg_first[seg_id] > 0,
                                        cs[np.maximum(seg_first[seg_id] - 1, 0)], 0.0)
                    run = cs - seg_base
                    if func == "avg":
                        run = run / np.maximum(run_cnt, 1)
                else:
                    # segment-reset running extreme via per-segment offset
                    fin = a[np.isfinite(a)]
                    span = (fin.max() - fin.min() + 1.0) if len(fin) else 1.0
                    off = seg_id * span * (1.0 if func == "max" else -1.0)
                    acc = {"min": np.minimum, "max": np.maximum}[func]
                    run = acc.accumulate(np.where(np.isfinite(a), a + off, a)) - off
                vals = run[peer_last[peer_id]]
                null_out = run_cnt[peer_last[peer_id]] == 0
            if func == "count":
                vals = np.asarray(vals).astype(np.int64)
                null_out = None  # count over empty/all-null window is 0
            if str_map is not None:
                dec = np.full(n, None, dtype=object)
                vf = np.asarray(vals, dtype=np.float64)
                ok = (
                    np.isfinite(vf)
                    if null_out is None
                    else np.isfinite(vf) & ~null_out
                )
                idxs = np.clip(vf[ok].astype(np.int64), 0, max(len(str_map) - 1, 0))
                dec[ok] = str_map[idxs] if len(str_map) else None
                out = np.empty(n, dtype=object)
                out[order] = dec
                return pa.array(out)
            if null_out is not None and null_out.any():
                out = np.empty(n)
                out[order] = vals
                m = np.zeros(n, dtype=bool)
                m[order] = null_out
                return pa.array(out, mask=m)
        else:
            raise ExecutionError(f"unsupported window function: {func}")

        out = np.empty(n, dtype=np.asarray(vals).dtype)
        out[order] = vals
        return out

    @staticmethod
    def _pick_values(a, target, ok, n):
        """Object-array gather: a[target] where ok, None elsewhere (NaN
        and numpy scalars normalized for arrow conversion)."""
        vals = np.empty(n, dtype=object)
        vals[:] = None
        picked = a[np.clip(target, 0, n - 1)]
        for i in np.nonzero(ok)[0]:
            v = picked[i]
            vals[i] = (
                None
                if v is None or (isinstance(v, float) and v != v)
                else (v.item() if isinstance(v, np.generic) else v)
            )
        return vals

    def _explicit_bounds(
        self, frame, fkind, orders, ascs, nfs, cols, n, order,
        seg_first, seg_id, pos,
    ):
        """Per-row [w_lo, w_hi) row windows of an explicit ROWS/RANGE
        BETWEEN frame over the sorted array, clamped to the partition."""
        if fkind == "range":
            rawk = np.asarray(orders[0].eval(cols, n))
            try:
                if rawk.dtype == object:
                    okey = np.array(
                        [np.nan if v is None else float(v) for v in rawk]
                    )[order]
                else:
                    okey = rawk.astype(np.float64)[order]
            except (TypeError, ValueError):
                raise ExecutionError(
                    "RANGE frames require a numeric ORDER BY key"
                ) from None
            nf0 = (nfs or [None])[0]
            nulls_first = bool(nf0) if nf0 is not None else (not ascs[0])
            return self._range_bounds(
                okey, frame, ascs[0], nulls_first, seg_first, seg_id, pos, n
            )
        lo, hi = frame
        seg_start = seg_first[seg_id]
        seg_end = np.append(seg_first[1:], n)[seg_id]
        w_lo = (
            seg_start if lo is None else np.clip(pos + lo, seg_start, seg_end)
        )
        w_hi = (
            seg_end
            if hi is None
            else np.clip(pos + hi + 1, seg_start, seg_end)
        )
        return w_lo, np.maximum(w_hi, w_lo)

    @staticmethod
    def _range_bounds(okey, frame, asc, nulls_first, seg_first, seg_id, pos, n):
        """RANGE BETWEEN bounds: rows whose (single, numeric) ORDER BY
        value lies within [v - lo_delta, v + hi_delta] of the current
        row's value, clamped to the partition.  Vectorized with one
        searchsorted over partition-biased keys (each partition's keys
        are shifted into a disjoint band, preserving in-partition order).

        NULL keys sort as a block at the partition edge (per nulls_first);
        their frame is that NULL peer block (SQL: NULLs are peers of each
        other in RANGE), and finite rows never see them (the block maps
        to a band-edge sentinel outside any finite query window)."""
        lo, hi = frame
        seg_start = seg_first[seg_id]
        seg_end = np.append(seg_first[1:], n)[seg_id]
        sign = 1.0 if asc else -1.0
        k = sign * okey  # ascending within each partition either way
        null_s = np.isnan(k)
        fin = k[~null_s]
        lo_f = float(fin.min()) if len(fin) else 0.0
        hi_f = float(fin.max()) if len(fin) else 0.0
        width = max(abs(x) for x in (lo or 0, hi or 0))
        margin = 2.0 * width + 2.0
        # NULL keys become a sentinel strictly beyond any finite key's
        # widest query window, at the sorted edge of the partition
        sentinel = lo_f - margin if nulls_first else hi_f + margin
        band = (hi_f - lo_f) + 2.0 * margin + 1.0
        k_f = np.where(null_s, sentinel, k)
        biased = seg_id * band + k_f
        w_lo = (
            seg_start
            if lo is None
            else np.searchsorted(biased, seg_id * band + k_f + lo, side="left")
        )
        w_hi = (
            seg_end
            if hi is None
            else np.searchsorted(biased, seg_id * band + k_f + hi, side="right")
        )
        w_lo = np.clip(w_lo, seg_start, seg_end)
        w_hi = np.clip(w_hi, seg_start, seg_end)
        if null_s.any():
            # NULL rows: the frame is exactly their partition's NULL block
            # (contiguous at the partition edge after the sort)
            blk_lo = np.minimum.reduceat(np.where(null_s, pos, n), seg_first)
            blk_hi = (
                np.maximum.reduceat(np.where(null_s, pos, -1), seg_first) + 1
            )
            w_lo = np.where(null_s, blk_lo[seg_id], w_lo)
            w_hi = np.where(null_s, blk_hi[seg_id], w_hi)
        return w_lo, np.maximum(w_hi, w_lo)

    @staticmethod
    def _frame_agg(func, a, nn_f, frame, seg_first, seg_id, pos, n, bounds=None):
        """ROWS/RANGE BETWEEN aggregate over the sorted array: window rows
        are [pos+lo, pos+hi] (or the precomputed RANGE bounds) clamped to
        the partition; computed with prefix sums (sum/count/avg) or
        sparse-table range extremes (min/max) — no per-row Python."""
        lo, hi = frame
        seg_start = seg_first[seg_id]
        seg_end = np.append(seg_first[1:], n)[seg_id]  # exclusive
        if bounds is not None:
            w_lo, w_hi = bounds
        else:
            w_lo = (
                seg_start
                if lo is None
                else np.clip(pos + lo, seg_start, seg_end)
            )
            w_hi = (
                seg_end
                if hi is None
                else np.clip(pos + hi + 1, seg_start, seg_end)
            )
            w_hi = np.maximum(w_hi, w_lo)  # empty window allowed
        width = w_hi - w_lo
        ccs = np.concatenate([[0.0], np.cumsum(nn_f)])
        cnt = ccs[w_hi] - ccs[w_lo]  # non-null rows in the window
        if func in ("sum", "count", "avg"):
            cs = np.concatenate([[0.0], np.cumsum(nn_f if func == "count" else a)])
            tot = cs[w_hi] - cs[w_lo]
            if func == "count":
                return tot.astype(np.int64), np.maximum(width, 1)
            if func == "avg":
                tot = tot / np.maximum(cnt, 1)
            return tot, cnt
        # min/max: running extremes from the left and right edges of
        # fixed-size blocks (sparse-table / two-pass trick), handling the
        # clamp by per-row block recombination.  Windows here are bounded
        # (lo/hi not None) or degenerate to running aggregates.
        acc = np.minimum if func == "min" else np.maximum
        ident = np.inf if func == "min" else -np.inf
        # answer[i] = reduce(a[w_lo[i]:w_hi[i]]) via a sparse table of
        # power-of-two reductions (O(n log n) build, O(1) per row)
        max_w = int(width.max()) if n else 0
        if max_w == 0:
            return np.full(n, np.nan), np.zeros(n)
        levels = max(1, int(np.ceil(np.log2(max_w))) + 1)
        table = [a.astype(np.float64)]
        for k in range(1, levels):
            prev = table[-1]
            half = 1 << (k - 1)
            nxt = prev.copy()
            nxt[: n - half] = acc(prev[: n - half], prev[half:])
            table.append(nxt)
        k_arr = np.zeros(n, np.int64)
        nz = width > 0
        k_arr[nz] = np.floor(np.log2(width[nz])).astype(np.int64)
        res = np.full(n, ident)
        for k in range(levels):
            sel = nz & (k_arr == k)
            if not sel.any():
                continue
            tl = table[k]
            i0 = w_lo[sel]
            i1 = w_hi[sel] - (1 << k)
            res[sel] = acc(tl[i0], tl[np.maximum(i1, 0)])
        return np.where(nz, res, np.nan), cnt

    def display_line(self):
        parts = ", ".join(sp[5] for sp in self.specs)
        return f"WindowExec: [{parts}]"

    def with_children(self, children):
        return WindowExec(children[0], self.specs)


class DistinctExec(ExecPlan):
    def __init__(self, child: ExecPlan):
        self.children = [child]

    def schema(self):
        return self.children[0].schema()

    def execute(self, ctx):
        t = self.children[0].execute(ctx)
        cols = [t.column_np(i) for i in range(len(t.column_names))]
        if not cols:
            return t
        _, idx = _row_group_codes(cols)
        return t.take(np.sort(idx))

    def display_line(self):
        return "DistinctExec"

    def with_children(self, children):
        return DistinctExec(children[0])


class DistinctOnExec(ExecPlan):
    """SELECT DISTINCT ON (keys): the first row of each key combination
    in the child's current row order — the binder sorts first, so
    Postgres's 'first row under ORDER BY per group' semantics hold."""

    def __init__(self, child: ExecPlan, key_exprs: list[PhysicalExpr]):
        self.children = [child]
        self.key_exprs = key_exprs

    def schema(self):
        return self.children[0].schema()

    def execute(self, ctx):
        t = self.children[0].execute(ctx)
        if t.num_rows == 0:
            return t
        keys = [
            np.asarray(_eval_on_table(e, t)) for e in self.key_exprs
        ]
        _, idx = _row_group_codes(keys)
        out = t.take(np.sort(idx))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def display_line(self):
        keys = ", ".join(e.display() for e in self.key_exprs)
        return f"DistinctOnExec: on=[{keys}]"

    def with_children(self, children):
        return DistinctOnExec(children[0], self.key_exprs)
