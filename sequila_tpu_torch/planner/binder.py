"""Binder: SQL AST -> physical plan.

Plays the role of DataFusion's logical planning + DefaultPhysicalPlanner as
wrapped by the reference's SeQuiLaQueryPlanner/SeQuiLaPhysicalPlanner
(reference sequila_query_planner.rs, sequila_physical_planner.rs:150-173 —
which delegate planning wholesale and do all custom work in the optimizer
rule).  Likewise here: the binder produces stock Hash/NLJ join plans and
the interval-join rewrite happens afterwards in planner/optimizer.py.

Join-condition handling mirrors DataFusion's behavior that the reference
relies on: equality conjuncts between the two sides become the `on` pairs,
all other conjuncts become the join filter over a compact filter schema
(columns ordered left-side-first by source index, displayed `name@i`), and
WHERE conjuncts over an implicit comma cross-join are pushed down the same
way (single-side conjuncts become input filters).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sequila_tpu_torch.errors import PlanError
from sequila_tpu_torch.exec.joins.hash_join import HashJoinExec
from sequila_tpu_torch.exec.joins.nl_join import NestedLoopJoinExec
from sequila_tpu_torch.exec.plan import (
    AggregateExec,
    DistinctExec,
    DistinctOnExec,
    ExecPlan,
    FilterExec,
    LimitExec,
    ProjectExec,
    ScanExec,
    SortExec,
    UnnestExec,
)
from sequila_tpu_torch.planner import expr as pe
from sequila_tpu_torch.sql import ast


def _values_scan(rows: tuple):
    """Materialize a VALUES table expression: columns named
    column1..columnN (DataFusion's convention), types inferred by arrow."""
    import pyarrow as _pa

    from sequila_tpu_torch.models.table import Table as _Table

    ncols = len(rows[0]) if rows else 0
    for i, r in enumerate(rows):
        if len(r) != ncols:
            raise PlanError(
                f"VALUES row {i + 1} has {len(r)} values, expected {ncols}"
            )
    if ncols == 0:
        raise PlanError("VALUES requires at least one column")
    return _Table(
        _pa.Table.from_arrays(
            [_pa.array([row[i] for row in rows]) for i in range(ncols)],
            names=[f"column{i + 1}" for i in range(ncols)],
        )
    )

_INTERVAL_US = {
    "microsecond": 1,
    "millisecond": 1_000,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": 86_400_000_000,
    "week": 7 * 86_400_000_000,
}


def _parse_interval(value: str, unit: str | None):
    """INTERVAL literal -> np.timedelta64[us].  Accepts a bare number
    with a unit token (INTERVAL '1' DAY) or '<n> <unit>' pairs inside
    the string (INTERVAL '1 day 2 hours').  Calendar units (month/year)
    have no fixed length and are rejected, as numpy timedeltas require
    (DataFusion stores them separately in IntervalMonthDayNano)."""
    toks = value.strip().split()
    if unit is not None:
        if len(toks) != 1:
            raise PlanError(f"malformed INTERVAL literal: {value!r}")
        pairs = [(toks[0], unit)]
    elif len(toks) == 1:
        pairs = [(toks[0], "second")]
    elif len(toks) % 2 == 0:
        pairs = list(zip(toks[::2], toks[1::2]))
    else:
        raise PlanError(f"malformed INTERVAL literal: {value!r}")
    total = 0
    for num, u in pairs:
        key = u.lower().rstrip("s")
        mult = _INTERVAL_US.get(key)
        if mult is None:
            if key in ("month", "year"):
                raise PlanError(
                    f"INTERVAL {key} is calendar-dependent and not "
                    "supported; use day/time units"
                )
            raise PlanError(f"unknown INTERVAL unit: {u!r}")
        try:
            total += int(round(float(num) * mult))
        except ValueError as exc:
            raise PlanError(
                f"malformed INTERVAL literal: {value!r}"
            ) from exc
    import numpy as _np

    return _np.timedelta64(total, "us")


_AGG_FUNCS = {
    "count", "sum", "min", "max", "avg",
    # statistical (DataFusion's aggregate library; approx_* are computed
    # exactly here — documented deviation, results are a superset)
    "stddev", "stddev_samp", "stddev_pop",
    "var", "var_samp", "var_pop", "variance",
    "median", "approx_median", "approx_distinct",
    "approx_percentile_cont",
    "corr", "covar", "covar_samp", "covar_pop",
    # linear-regression family (Postgres/DataFusion: regr_*(Y, X))
    "regr_count", "regr_avgx", "regr_avgy", "regr_slope",
    "regr_intercept", "regr_r2", "regr_sxx", "regr_syy", "regr_sxy",
    "bool_and", "bool_or",
    "bit_and", "bit_or", "bit_xor",
    # value collectors
    "string_agg", "group_concat", "array_agg",
    "first_value", "last_value",
    # grouping-sets indicator
    "grouping",
}

# aggregates taking (value, second-arg) pairs
_AGG_TWO_ARG = {
    "string_agg", "corr", "covar", "covar_samp", "covar_pop",
    "approx_percentile_cont",
    "regr_count", "regr_avgx", "regr_avgy", "regr_slope",
    "regr_intercept", "regr_r2", "regr_sxx", "regr_syy", "regr_sxy",
}


@dataclasses.dataclass
class _Bound:
    """An expression bound against a plan's combined schema."""

    expr: pe.PhysicalExpr
    # indices of referenced combined-schema columns
    col_indices: list[int]


class Binder:
    def __init__(self, catalog, runner=None, views=None, view_guard=None,
                 info_schema=None):
        self.catalog = catalog
        self.views = views or {}
        # info_schema: Callable[[str], Table | None] — resolves
        # information_schema.<name> virtual tables (session-provided)
        self.info_schema = info_schema
        # view_guard: session-shared in-flight view-name stack, so cycles
        # through set-operation views (which re-enter via the runner with
        # a NEW Binder instance) are still detected
        self._view_stack: list[str] = view_guard if view_guard is not None else []
        # runner: Callable[[ast.Select], Table] — executes an uncorrelated
        # subquery (IN/EXISTS/scalar) at bind time.  DataFusion decorrelates
        # these into joins; the reference exercises none of them, so eager
        # uncorrelated evaluation matches its observable SQL surface.
        self.runner = runner

    def _run_subquery(self, sel, what: str):
        if self.runner is None:
            raise PlanError(f"{what} subqueries are not supported in this context")
        try:
            return self.runner(sel)
        except PlanError as e:
            if "not found" in str(e):
                raise PlanError(
                    f"correlated {what} subqueries are not supported: {e}"
                ) from e
            raise

    # ------------------------------------------------------------------
    def bind_select(self, sel: ast.Select) -> ExecPlan:
        if sel.windows:
            # WINDOW w AS (spec): inline each OVER w reference, then bind
            # as if the spec had been written at the call site
            wmap = dict(sel.windows)
            sel = dataclasses.replace(
                sel,
                items=tuple(
                    dataclasses.replace(
                        it, expr=self._resolve_window_refs(it.expr, wmap)
                    )
                    for it in sel.items
                ),
                windows=(),
            )
        unnest_cols = [
            i
            for i, it in enumerate(sel.items)
            if isinstance(it.expr, ast.Func)
            and it.expr.name == "unnest"
            and not it.expr.star
        ]
        if unnest_cols:
            # SELECT unnest(arr), ... — bind the inner expression, then
            # expand the produced rows (DataFusion's projection-level
            # unnest; one unnest per select list)
            if len(unnest_cols) > 1:
                raise PlanError("only one unnest(...) per SELECT list")
            i = unnest_cols[0]
            it = sel.items[i]
            if len(it.expr.args) != 1:
                raise PlanError("unnest() takes exactly one argument")
            inner = dataclasses.replace(
                it,
                expr=it.expr.args[0],
                alias=it.alias or self._display_name(it.expr),
            )
            items = list(sel.items)
            items[i] = inner
            # ORDER BY / LIMIT apply to the EXPANDED rows (Postgres SRF
            # semantics), so both move above the UnnestExec
            sub = dataclasses.replace(
                sel, items=tuple(items), limit=None, offset=0, order_by=()
            )
            plan = UnnestExec(self.bind_select(sub), i)
            if sel.order_by:
                oschema = plan.schema()
                names = [n for _, n in oschema]
                exprs, asc, nfs = [], [], []
                for oi in sel.order_by:
                    k = self._ordinal(oi.expr)
                    if k is not None:
                        if not 1 <= k <= len(names):
                            raise PlanError(
                                f"ORDER BY position {k} is not in the select list"
                            )
                        exprs.append(pe.Column(names[k - 1], k - 1))
                    else:
                        disp = self._display_name(oi.expr)
                        if disp in names:
                            exprs.append(pe.Column(disp, names.index(disp)))
                        else:
                            exprs.append(self._bind_expr(oi.expr, oschema).expr)
                    asc.append(oi.asc)
                    nfs.append(oi.nulls_first)
                plan = SortExec(plan, exprs, asc, nfs)
            if sel.limit is not None or sel.offset:
                plan = LimitExec(plan, sel.limit, sel.offset)
            return plan
        plan, where = self._bind_from(sel)
        plan, where = self._decorrelate_where(plan, where)
        schema = plan.schema()

        has_aggs = (
            any(self._contains_agg(it.expr) for it in sel.items)
            or bool(sel.group_by)
            or sel.having is not None
        )

        if not has_aggs:
            if where is not None:
                plan = FilterExec(plan, self._bind_expr(where, schema).expr)
            # window functions evaluate after WHERE, before ORDER BY /
            # projection (standard SQL evaluation order)
            plan, items = self._extract_windows(plan, sel.items)
            if items is not sel.items:
                sel = dataclasses.replace(sel, items=items)
                schema = plan.schema()
            # ORDER BY binds against the pre-projection schema; a bare
            # column that only exists as a SELECT alias resolves to the
            # aliased expression (standard SQL).
            if sel.order_by:
                exprs, asc, nfs = [], [], []
                for oi in sel.order_by:
                    target, _ = self._resolve_item_ref(
                        oi.expr, sel, schema, alias_wins=True
                    )
                    try:
                        bound = self._bind_expr(target, schema).expr
                    except PlanError:
                        # ORDER BY abs(alias): aliases may appear INSIDE
                        # expressions too (DataFusion/sqlite resolution) —
                        # substitute unresolvable bare names with their
                        # aliased select expressions and retry
                        sub = self._substitute_aliases(target, sel, schema)
                        if sub is target:
                            raise
                        bound = self._bind_expr(sub, schema).expr
                    exprs.append(bound)
                    asc.append(oi.asc)
                    nfs.append(oi.nulls_first)
                plan = SortExec(plan, exprs, asc, nfs)
            if sel.distinct_on:
                keys = []
                for e in sel.distinct_on:
                    target, _ = self._resolve_item_ref(
                        e, sel, schema, alias_wins=True
                    )
                    keys.append(self._bind_expr(target, schema).expr)
                plan = DistinctOnExec(plan, keys)
            plan = self._bind_projection(plan, sel)
            if sel.distinct:
                plan = DistinctExec(plan)
        else:
            if any(self._contains_window(it.expr) for it in sel.items):
                raise PlanError(
                    "window functions over aggregated output are not supported"
                )
            if sel.distinct_on:
                raise PlanError(
                    "DISTINCT ON with aggregates is not supported"
                )
            if where is not None:
                plan = FilterExec(plan, self._bind_expr(where, schema).expr)
            plan = self._bind_aggregate(plan, sel)
            if sel.order_by:
                aschema = plan.schema()
                names = [n for _, n in aschema]
                n_vis = len(names) - sum(
                    1 for n in names if n.startswith("__sort_")
                )
                exprs, asc, nfs = [], [], []
                for i, oi in enumerate(sel.order_by):
                    target = oi.expr
                    k = self._ordinal(target)
                    if k is not None:
                        if not 1 <= k <= n_vis:
                            raise PlanError(
                                f"ORDER/GROUP BY position {k} is not in the select list"
                            )
                        exprs.append(pe.Column(names[k - 1], k - 1))
                        asc.append(oi.asc)
                        nfs.append(oi.nulls_first)
                        continue
                    # ORDER BY count(*) / other aggregate expressions
                    # resolve by display name in the aggregate output, or
                    # by the hidden __sort_<i> column _bind_aggregate
                    # emitted for aggregates outside the SELECT list
                    disp = self._display_name(oi.expr)
                    if self._contains_agg(oi.expr) and disp in names:
                        exprs.append(pe.Column(disp, names.index(disp)))
                    elif f"__sort_{i}" in names:
                        j = names.index(f"__sort_{i}")
                        exprs.append(pe.Column(names[j], j))
                    else:
                        exprs.append(self._bind_expr(oi.expr, aschema).expr)
                    asc.append(oi.asc)
                    nfs.append(oi.nulls_first)
                plan = SortExec(plan, exprs, asc, nfs)
                if n_vis < len(names):  # strip hidden sort columns
                    plan = ProjectExec(
                        plan,
                        [pe.Column(names[j], j) for j in range(n_vis)],
                        names[:n_vis],
                    )

        if sel.limit is not None or sel.offset:
            plan = LimitExec(plan, sel.limit, sel.offset)
        return plan

    # -- FROM / joins ---------------------------------------------------
    def _requalify(self, sub: ExecPlan, qual: str, names=None) -> ExecPlan:
        """Re-qualify a subplan's output columns under an alias (with an
        optional rename) so `alias.col` resolves (the inner plan keeps
        its own structure)."""
        schema = sub.schema()
        if names is not None and len(names) != len(schema):
            raise PlanError(
                f"alias column list has {len(names)} names for "
                f"{len(schema)} columns"
            )
        return ProjectExec(
            sub,
            [pe.Column(n, i) for i, (_, n) in enumerate(schema)],
            list(names) if names is not None else [n for _, n in schema],
            [qual] * len(schema),
        )

    def _scan(self, tref: ast.TableRef) -> ExecPlan:
        if tref.table_func is not None:
            sub = ScanExec(
                tref.alias or tref.table_func[0],
                self._table_function(tref.table_func),
                None,
            )
            return self._requalify(
                sub, tref.alias or tref.table_func[0], tref.col_aliases
            )
        if tref.subquery is not None:
            # derived table: FROM ( SELECT ... | VALUES ... ) alias
            q = tref.subquery
            if isinstance(q, ast.Select):
                sub = self.bind_select(q)
            elif isinstance(q, ast.Values):
                sub = ScanExec(
                    tref.alias or "values", _values_scan(q.rows), None
                )
            else:  # set-operation chain: materialize via the runner
                if self.runner is None:
                    raise PlanError(
                        "set-operation derived tables need a session"
                    )
                sub = ScanExec(tref.alias or tref.name, self.runner(q), None)
            return self._requalify(
                sub, tref.alias or tref.name, tref.col_aliases
            )
        key = tref.name.lower()
        if key.startswith("information_schema."):
            t = self.info_schema(key) if self.info_schema else None
            if t is None:
                raise PlanError(f"table '{tref.name}' not found")
            return ScanExec(tref.name, t, tref.alias or tref.name)
        if key in self.views:
            if key in self._view_stack:
                raise PlanError(f"view '{tref.name}' is recursive")
            self._view_stack.append(key)
            try:
                view = self.views[key]
                if isinstance(view, ast.Select):
                    sub = self.bind_select(view)
                else:
                    # set-operation view (UNION/INTERSECT/EXCEPT chain):
                    # materialize via the runner and scan the result (set
                    # ops finish on the host anyway)
                    if self.runner is None:
                        raise PlanError(
                            f"view '{tref.name}' needs a session to execute"
                        )
                    sub = ScanExec(tref.name, self.runner(view), None)
            finally:
                self._view_stack.pop()
            return self._requalify(sub, tref.alias or tref.name)
        if key not in self.catalog:
            raise PlanError(f"table '{tref.name}' not found")
        return ScanExec(tref.name, self.catalog[key], tref.alias or tref.name)

    def _tf_const(self, a, fname):
        """Evaluate a table-function argument as a constant scalar."""
        import numpy as _np

        b = self._bind_expr(a, [])
        v = _np.asarray(b.expr.eval({}, 1)).ravel()[0]
        if v is None or (isinstance(v, float) and v != v):
            raise PlanError(f"{fname} arguments must not be NULL")
        return v.item() if hasattr(v, "item") else v

    def _tf_table(self, name, fname):
        """Resolve a table-function string argument to a catalog table."""
        key = str(name).lower()
        if key in self.catalog:
            return self.catalog[key]
        if key in self.views and self.runner is not None:
            # same recursion guard as the plain view path: a view cycle
            # through merge('v') must error, not recurse unboundedly
            if key in self._view_stack:
                raise PlanError(f"view '{name}' is recursive")
            self._view_stack.append(key)
            try:
                return self.runner(self.views[key])
            finally:
                self._view_stack.pop()
        raise PlanError(f"{fname}: table '{name}' not found")

    # genomic verbs exposed as SQL table functions (name -> arity range);
    # the engine's extension beyond the reference, whose closest/
    # complement operators were never landed (SURVEY.md §2 item 23)
    _GENOMIC_TFS = {
        "merge": (1, 2), "cluster": (1, 2), "depth": (1, 1),
        "overlap": (2, 3), "count_overlaps": (2, 3), "nearest": (2, 3),
        "closest": (2, 4), "coverage": (2, 3), "subtract": (2, 3),
        "window": (3, 4), "reldist": (2, 3), "jaccard": (2, 2),
    }
    # pairwise TFs accept a trailing 'same'/'opposite' strand mode
    # (bedtools -s/-S; requires a `strand` column on both tables)
    _STRANDABLE_TFS = {
        "overlap", "count_overlaps", "nearest", "closest", "coverage",
        "subtract", "window", "reldist",
    }

    def _genomic_table_function(self, fname, args):
        """FROM merge('reads'), FROM count_overlaps('a', 'b'), ... —
        the dataframe verb layer reachable from SQL (default
        (contig, pos_start, pos_end) columns)."""
        import pyarrow as _pa

        from sequila_tpu_torch import dataframe as _df
        from sequila_tpu_torch.models.table import Table as _Table

        lo, hi = self._GENOMIC_TFS[fname]
        if not lo <= len(args) <= hi:
            raise PlanError(
                f"{fname} takes {lo}"
                + (f"-{hi}" if hi != lo else "")
                + f" arguments, got {len(args)}"
            )
        consts = [self._tf_const(a, fname) for a in args]
        strand = None
        if (
            fname in self._STRANDABLE_TFS
            and consts
            and isinstance(consts[-1], str)
            and consts[-1].lower() in ("same", "opposite")
            and len(consts) > 2
        ):
            strand = consts.pop().lower()
        t0 = self._tf_table(consts[0], fname)
        if fname in ("merge", "cluster"):
            dist = int(consts[1]) if len(consts) > 1 else 0
            return getattr(_df, fname)(t0, dist)
        if fname == "depth":
            return _df.depth(t0)
        t1 = self._tf_table(consts[1], fname)
        if fname == "closest":
            k = int(consts[2]) if len(consts) > 2 else 1
            return _df.closest(t0, t1, k=k, strand=strand)
        if fname == "window":
            if len(consts) < 3:
                raise PlanError("window takes (a, b, bp[, strand])")
            return _df.window(t0, t1, window=int(consts[2]), strand=strand)
        if fname == "jaccard":
            stats = _df.jaccard(t0, t1)
            return _Table(
                _pa.table({k: [v] for k, v in stats.items()})
            )
        return getattr(_df, fname)(t0, t1, strand=strand)

    def _table_function(self, tf):
        """FROM-clause table functions: DataFusion's ``generate_series`` /
        ``range`` (datafusion/functions-table — part of the SQL surface the
        reference inherits), plus the genomic verb layer (_GENOMIC_TFS).
        Integer series; generate_series includes the stop bound, range
        excludes it; like DataFusion, a default step that cannot reach the
        bound is an error rather than an infinite series."""
        import numpy as _np
        import pyarrow as _pa

        from sequila_tpu_torch.models.table import Table as _Table

        fname, args = tf
        if fname in self._GENOMIC_TFS:
            return self._genomic_table_function(fname, args)
        if fname == "unnest":
            # FROM unnest([...]): one row per element, column `value`
            if len(args) != 1:
                raise PlanError("unnest takes one array argument")
            b = self._bind_expr(args[0], [])
            v = b.expr.eval({}, 1)
            cell = v[0] if len(v) else None
            lst = (
                list(cell)
                if isinstance(cell, (list, tuple, _np.ndarray))
                else None
            )
            if lst is None:
                raise PlanError("unnest argument must be an array")
            try:
                arr = _pa.array(
                    [x.item() if hasattr(x, "item") else x for x in lst]
                )
            except Exception as exc:
                raise PlanError(f"unnest: {exc}") from exc
            return _Table(_pa.table({"value": arr}))
        if fname not in ("generate_series", "range"):
            raise PlanError(f"unknown table function '{fname}'")
        if not 1 <= len(args) <= 3:
            raise PlanError(f"{fname} takes 1 to 3 arguments")
        consts = [int(self._tf_const(a, fname)) for a in args]
        if len(consts) == 1:
            start, stop, step = 0, consts[0], 1
        elif len(consts) == 2:
            (start, stop), step = consts, 1
        else:
            start, stop, step = consts
        if step == 0:
            raise PlanError(f"{fname} step cannot be zero")
        if (step > 0 and start > stop) or (step < 0 and start < stop):
            raise PlanError(
                f"{fname}: start {start} cannot reach stop {stop} "
                f"with step {step}"
            )
        incl = 1 if fname == "generate_series" else 0
        bound = stop + incl if step > 0 else stop - incl
        vals = _np.arange(start, bound, step, dtype=_np.int64)
        return _Table(_pa.table({"value": _pa.array(vals, type=_pa.int64())}))

    def _bind_from(self, sel: ast.Select):
        """Returns (plan, remaining_where): a comma cross-join consumes the
        WHERE clause into pushed-down filters / join conditions."""
        if not sel.from_tables:
            # FROM-less SELECT (constant evaluation, datafusion-cli style):
            # a one-row zero-meaning scan the projection evaluates over
            if sel.joins:
                raise PlanError("JOIN requires a FROM clause")
            if any(isinstance(it.expr, ast.Star) for it in sel.items):
                raise PlanError("SELECT * requires a FROM clause")
            import pyarrow as _pa

            from sequila_tpu_torch.models.table import Table as _Table

            dummy = ScanExec(
                "__values__", _Table(_pa.table({"__dummy": [0]})), None
            )
            return dummy, sel.where
        plan: ExecPlan = self._scan(sel.from_tables[0])

        # WHERE conjuncts are consumed incrementally: each comma join takes
        # the conjuncts resolvable against its combined schema; conjuncts
        # naming later tables (a,b,c with b.x = c.x) stay pending and apply
        # at the join that first covers them, or as a post-join filter.
        pending = self._flatten_and(sel.where) if sel.where is not None else []
        for tref in sel.from_tables[1:]:
            right = self._scan(tref)
            plan, pending = self._make_join_from_where(plan, right, pending)

        for jc in sel.joins:
            right = self._scan(jc.table)
            if jc.natural:
                # NATURAL JOIN: USING(every shared bare column name), in
                # left-schema order; no shared names degrades to a cross
                # product (Postgres semantics)
                rnames = {n for _, n in right.schema()}
                shared = [
                    n for _, n in plan.schema() if n in rnames
                ]
                shared = list(dict.fromkeys(shared))
                if shared:
                    plan = self._make_using_join(
                        plan, right, tuple(shared), jc.join_type
                    )
                else:
                    # no shared names: NATURAL <type> JOIN == <type> JOIN
                    # ON TRUE (an outer type keeps its unmatched rows)
                    plan = NestedLoopJoinExec(plan, right, None, jc.join_type)
            elif jc.using:
                plan = self._make_using_join(plan, right, jc.using, jc.join_type)
            elif jc.join_type == "cross" or jc.on is None:
                plan = NestedLoopJoinExec(plan, right, None, "inner")
            else:
                plan = self._make_join(plan, right, jc.on, jc.join_type)
        where = None
        for c in pending:
            where = c if where is None else ast.Binary(where, "AND", c)
        return plan, where

    # -- window functions -----------------------------------------------
    def _resolve_window_refs(self, e, wmap):
        """Replace OVER <name> references with the WINDOW-clause spec."""
        if isinstance(e, ast.WindowFunc):
            if e.ref is not None:
                t = wmap.get(e.ref)
                if t is None:
                    raise PlanError(f"window '{e.ref}' is not defined")
                return dataclasses.replace(t, func=e.func, ref=None)
            return e
        if isinstance(e, ast.Binary):
            return dataclasses.replace(
                e,
                left=self._resolve_window_refs(e.left, wmap),
                right=self._resolve_window_refs(e.right, wmap),
            )
        if isinstance(e, (ast.Unary, ast.Cast)):
            return dataclasses.replace(
                e, child=self._resolve_window_refs(e.child, wmap)
            )
        if isinstance(e, ast.Func):
            return dataclasses.replace(
                e,
                args=tuple(
                    self._resolve_window_refs(a, wmap) for a in e.args
                ),
            )
        return e

    def _contains_window(self, e) -> bool:
        if isinstance(e, ast.WindowFunc):
            return True
        if isinstance(e, ast.Binary):
            return self._contains_window(e.left) or self._contains_window(e.right)
        if isinstance(e, (ast.Unary, ast.Cast)):
            return self._contains_window(e.child)
        if isinstance(e, ast.Func):
            return any(self._contains_window(a) for a in e.args)
        return False

    def _extract_windows(self, plan: ExecPlan, items):
        """Pull WindowFunc nodes out of the SELECT items into a WindowExec
        below the projection; each occurrence is replaced by a ColRef to
        the window's appended output column."""
        from sequila_tpu_torch.exec.plan import _WINDOW_FUNCS, WindowExec

        if not any(self._contains_window(it.expr) for it in items):
            return plan, items
        schema = plan.schema()
        specs = []
        counter = [0]

        def replace(e):
            if isinstance(e, ast.WindowFunc):
                if e.ref is not None:
                    raise PlanError(f"window '{e.ref}' is not defined")
                fn = e.func
                if fn.name not in _WINDOW_FUNCS:
                    raise PlanError(f"unsupported window function: {fn.name}")
                if fn.distinct:
                    raise PlanError("DISTINCT window aggregates are not supported")
                if fn.filter_where is not None:
                    raise PlanError(
                        "FILTER on window functions is not supported"
                    )
                if fn.order_by:
                    raise PlanError(
                        "ORDER BY inside a window aggregate call is not "
                        "supported; order the OVER clause instead"
                    )
                args = []
                for i, a in enumerate(fn.args):
                    if (
                        (fn.name in ("lag", "lead") and i >= 1)
                        or (fn.name == "nth_value" and i == 1)
                        or fn.name == "ntile"
                    ):
                        lit = a
                        neg = False
                        while isinstance(lit, ast.Unary) and lit.op == "-":
                            neg = not neg
                            lit = lit.child
                        if not isinstance(lit, ast.Lit):
                            raise PlanError(
                                f"{fn.name} offset/default must be a literal"
                            )
                        v = lit.value
                        v = -v if neg and v is not None else v
                        if i == 1 and fn.name in ("lag", "lead") and (
                            not isinstance(v, int) or v < 0
                        ):
                            raise PlanError(
                                f"{fn.name} offset must be a non-negative integer"
                            )
                        args.append(v)
                    else:
                        args.append(self._bind_expr(a, schema).expr)
                parts = [self._bind_expr(p, schema).expr for p in e.partition_by]
                orders = [
                    self._bind_expr(oi.expr, schema).expr for oi in e.order_by
                ]
                ascs = [oi.asc for oi in e.order_by]
                nfs = [oi.nulls_first for oi in e.order_by]
                if fn.name in (
                    "row_number", "rank", "dense_rank",
                    "percent_rank", "cume_dist",
                ) and not orders:
                    raise PlanError(f"{fn.name}() requires ORDER BY in OVER()")
                frame = e.frame
                if frame is not None and fn.name in (
                    "row_number", "rank", "dense_rank", "percent_rank",
                    "cume_dist", "ntile", "lag", "lead",
                ):
                    # SQL: frames have no effect on ranking/offset functions
                    # (sqlite window-function docs; DataFusion agrees)
                    frame = None
                if frame is not None:
                    if fn.name not in (
                        "sum", "count", "avg", "min", "max",
                        "first_value", "last_value", "nth_value",
                    ):
                        raise PlanError(
                            "ROWS/RANGE BETWEEN frames are supported for "
                            "aggregate and value window functions only"
                        )
                    if not orders:
                        raise PlanError(
                            "ROWS/RANGE BETWEEN requires ORDER BY in OVER()"
                        )
                    if e.frame_kind == "range" and len(orders) != 1:
                        raise PlanError(
                            "RANGE BETWEEN requires exactly one ORDER BY key"
                        )
                    if e.frame_kind == "rows" and any(
                        b is not None and not isinstance(b, int)
                        for b in frame
                    ):
                        raise PlanError("ROWS frame offsets must be integers")
                name = f"__window_{counter[0]}"
                counter[0] += 1
                specs.append(
                    (fn.name, args, parts, orders, ascs, name, frame, nfs,
                     e.frame_kind)
                )
                return ast.ColRef(None, name)
            if isinstance(e, ast.Binary):
                return ast.Binary(replace(e.left), e.op, replace(e.right))
            if isinstance(e, ast.Unary):
                return ast.Unary(e.op, replace(e.child))
            if isinstance(e, ast.Cast):
                return ast.Cast(replace(e.child), e.type_name)
            if isinstance(e, ast.Func):
                return dataclasses.replace(
                    e, args=tuple(replace(a) for a in e.args)
                )
            return e

        def window_display(w: ast.WindowFunc) -> str:
            fn = w.func
            args = "*" if fn.star else ", ".join(
                self._display_name(a) for a in fn.args
            )
            over = []
            if w.partition_by:
                over.append(
                    "PARTITION BY "
                    + ", ".join(self._display_name(e) for e in w.partition_by)
                )
            if w.order_by:
                over.append(
                    "ORDER BY "
                    + ", ".join(
                        self._display_name(oi.expr) + ("" if oi.asc else " DESC")
                        for oi in w.order_by
                    )
                )
            return f"{fn.name}({args}) OVER ({' '.join(over)})"

        new_items = []
        for it in items:
            alias = it.alias
            if alias is None and isinstance(it.expr, ast.WindowFunc):
                alias = window_display(it.expr)
            new_items.append(
                dataclasses.replace(it, expr=replace(it.expr), alias=alias)
            )
        return WindowExec(plan, specs), tuple(new_items)

    # -- correlated subqueries ------------------------------------------
    def _is_correlated(self, sel: ast.Select) -> bool:
        """True when the subquery references columns outside its own FROM
        scope (binding it standalone fails name resolution)."""
        try:
            self.bind_select(sel)
            return False
        except PlanError as e:
            if "not found" in str(e):
                return True
            raise

    def _decorrelate_where(self, plan: ExecPlan, where):
        """Rewrite top-level correlated [NOT] EXISTS / IN conjuncts into
        semi/anti joins (what DataFusion's decorrelate_predicate_subquery
        rule does).  Uncorrelated subquery conjuncts stay for the eager
        bind-time evaluation path."""
        if where is None:
            return plan, None
        kept = []
        for cj in self._flatten_and(where):
            if isinstance(cj, (ast.Exists, ast.InSubquery)) and self._is_correlated(
                cj.select
            ):
                plan = self._decorrelate_subquery(plan, cj)
                continue
            scalar = self._match_scalar_agg_conjunct(cj)
            if scalar is not None and self._is_correlated(scalar[1].select):
                plan = self._decorrelate_scalar_agg(plan, *scalar)
                continue
            kept.append(cj)
        out = None
        for c in kept:
            out = c if out is None else ast.Binary(out, "AND", c)
        return plan, out

    @staticmethod
    def _match_scalar_agg_conjunct(cj):
        """(outer_expr_ast, ScalarSubquery, op, sub_on_left) for conjuncts
        shaped `expr cmp (SELECT agg(..) ..)` (either side)."""
        if not (isinstance(cj, ast.Binary) and cj.op in ("=", "!=", "<", "<=", ">", ">=")):
            return None
        if isinstance(cj.right, ast.ScalarSubquery) and not isinstance(
            cj.left, ast.ScalarSubquery
        ):
            return cj.left, cj.right, cj.op, False
        if isinstance(cj.left, ast.ScalarSubquery) and not isinstance(
            cj.right, ast.ScalarSubquery
        ):
            return cj.right, cj.left, cj.op, True
        return None

    def _decorrelate_scalar_agg(
        self, plan: ExecPlan, outer_ast, sub, op, sub_on_left
    ) -> ExecPlan:
        """`expr cmp (SELECT agg(e) FROM inner WHERE inner.k = outer.k ..)`
        -> group inner by its correlation keys, join, filter, project the
        outer columns back (DataFusion's scalar_subquery_to_join)."""
        from sequila_tpu_torch.exec.plan import AggregateExec

        sel = sub.select
        if (
            len(sel.items) != 1
            or sel.group_by
            or sel.having is not None
            or sel.limit is not None
        ):
            raise PlanError(
                "correlated scalar subqueries must be a single aggregate "
                "with no GROUP BY/HAVING/LIMIT"
            )
        item = sel.items[0].expr
        if not (isinstance(item, ast.Func) and item.name in _AGG_FUNCS):
            raise PlanError(
                "correlated scalar subqueries must select a plain aggregate"
            )
        inner_plan, pairs, residual, lschema, nleft = self._split_correlation(
            plan, sel
        )
        if residual:
            if not pairs and len(residual) == 1:
                built = self._try_ineq_scalar_agg(
                    plan, inner_plan, residual[0], lschema, nleft,
                    item, outer_ast, op, sub_on_left,
                )
                if built is not None:
                    return built
            raise PlanError(
                "correlated scalar subqueries support equality correlation "
                "or a single inequality correlation predicate"
            )
        if not pairs:
            raise PlanError("correlated scalar subquery has no correlation keys")
        # aggregate the inner side per correlation-key group
        group_exprs = [p[1] for p in pairs]
        group_names = [f"__corr_k{i}" for i in range(len(pairs))]
        arg = (
            None
            if item.star or not item.args
            else self._bind_expr(item.args[0], inner_plan.schema()).expr
        )
        agg_name = "__corr_agg"
        agg_plan = AggregateExec(
            inner_plan,
            group_exprs,
            group_names,
            [(item.name, arg, item.distinct, agg_name)],
        )
        is_count = item.name == "count"
        jt = "left" if is_count else "inner"
        join = HashJoinExec(
            plan,
            agg_plan,
            [(p[0], pe.Column(n, i)) for i, (p, n) in enumerate(zip(pairs, group_names))],
            None,
            jt,
        )
        agg_col = pe.Column(agg_name, nleft + len(pairs))
        if is_count:
            # count over an empty correlation group is 0, not NULL
            agg_col = pe.IfNullExpr(agg_col, 0)
        outer_expr = self._bind_expr(outer_ast, lschema).expr
        cmp = (
            pe.BinaryExpr(agg_col, op, outer_expr)
            if sub_on_left
            else pe.BinaryExpr(outer_expr, op, agg_col)
        )
        filtered = FilterExec(join, cmp)
        return self._project_outer(filtered, lschema)

    def _split_correlation(self, plan: ExecPlan, sel: ast.Select):
        """Shared decorrelation front half: bind the subquery's FROM,
        push inner-only conjuncts below, and split cross-scope conjuncts
        into equality pairs vs residual bound filters.

        Returns (inner_plan, pairs, residual_bounds, lschema, nleft)."""
        inner_plan, inner_where = self._bind_from(sel)
        inner_schema = inner_plan.schema()
        cross = []
        if inner_where is not None:
            for cj in self._flatten_and(inner_where):
                try:
                    b = self._bind_expr(cj, inner_schema)
                except PlanError:
                    cross.append(cj)  # references the outer scope
                else:
                    inner_plan = FilterExec(inner_plan, b.expr)
        lschema = plan.schema()
        nleft = len(lschema)
        combined = lschema + inner_plan.schema()
        pairs, residual = [], []
        for cj in cross:
            bound = self._bind_expr(cj, combined)
            pair = self._as_equi_pair(bound, nleft)
            if pair is not None:
                pairs.append(pair)
            else:
                residual.append(bound)
        return inner_plan, pairs, residual, lschema, nleft

    def _project_outer(self, plan: ExecPlan, lschema) -> ExecPlan:
        """Project a decorrelated join back to the outer schema (with
        qualifiers, so downstream resolution keeps working)."""
        return ProjectExec(
            plan,
            [pe.Column(n, i) for i, (_, n) in enumerate(lschema)],
            [n for _, n in lschema],
            [q for q, _ in lschema],
        )

    def _decorrelate_not_in(self, plan: ExecPlan, node) -> ExecPlan:
        """Correlated NOT IN needs a NULL-AWARE anti join: for each outer
        row, `x NOT IN S` is TRUE iff S is empty, or (x is not NULL, S has
        no NULLs, and x matches nothing).  Plan: anti-join on the
        correlation keys + (x = y) to drop exact matches, left-join
        per-group [count(*), count(y)] to detect empty / NULL-bearing
        groups, filter, project the outer schema back."""
        from sequila_tpu_torch.exec.plan import AggregateExec

        sel = node.select
        if (
            len(sel.items) != 1
            or isinstance(sel.items[0].expr, ast.Star)
            or sel.group_by
            or sel.having is not None
            or sel.limit is not None
            or any(self._contains_agg(it.expr) for it in sel.items)
        ):
            raise PlanError(
                "correlated NOT IN requires a single plain column subquery"
            )
        inner_plan, pairs, residual, lschema, nleft = self._split_correlation(
            plan, sel
        )
        if residual:
            raise PlanError(
                "correlated NOT IN supports only equality correlation"
            )
        y_expr = self._bind_expr(sel.items[0].expr, inner_plan.schema()).expr
        x_expr = self._bind_expr(node.child, lschema).expr
        # 1) drop outer rows with an exact (corr, x=y) match
        anti = HashJoinExec(
            plan, inner_plan, pairs + [(x_expr, y_expr)], None, "leftanti"
        )
        # 2) per-correlation-group counts: cnt (rows) vs nn (non-null y)
        agg_plan = AggregateExec(
            inner_plan,
            [p[1] for p in pairs],
            [f"__ni_k{i}" for i in range(len(pairs))],
            [("count", None, False, "__ni_cnt"), ("count", y_expr, False, "__ni_nn")],
        )
        join = HashJoinExec(
            anti,
            agg_plan,
            [
                (p[0], pe.Column(f"__ni_k{i}", i))
                for i, p in enumerate(pairs)
            ],
            None,
            "left",
        )
        cnt_col = pe.Column("__ni_cnt", nleft + len(pairs))
        nn_col = pe.Column("__ni_nn", nleft + len(pairs) + 1)
        absent = pe.BinaryExpr(
            pe.IfNullExpr(cnt_col, -1), "=", pe.Literal(-1)
        )
        clean = pe.BinaryExpr(
            pe.NotExpr(pe.ScalarFuncExpr("isnull", (x_expr,))),
            "AND",
            pe.BinaryExpr(cnt_col, "=", nn_col),
        )
        filtered = FilterExec(join, pe.BinaryExpr(absent, "OR", clean))
        return self._project_outer(filtered, lschema)

    def _try_ineq_scalar_agg(
        self, plan, inner_plan, bound, lschema, nleft,
        item, outer_ast, cmp_op, sub_on_left,
    ):
        """`expr cmp (SELECT agg(e) FROM inner WHERE inner.k <op> outer.k)`
        -> PrefixAggJoinExec (sorted prefix/suffix aggregates + one
        searchsorted per outer row).  Returns None when the residual isn't
        a single two-sided inequality."""
        from sequila_tpu_torch.exec.joins.ineq_agg import AGG_COL, PrefixAggJoinExec

        e = bound.expr
        if not (
            isinstance(e, pe.BinaryExpr) and e.op in ("<", "<=", ">", ">=")
        ):
            return None

        def side_of(x):
            idxs = [c.index for c in x.columns()]
            if not idxs:
                return None
            if all(i < nleft for i in idxs):
                return "outer"
            if all(i >= nleft for i in idxs):
                return "inner"
            return None

        ls_, rs_ = side_of(e.left), side_of(e.right)
        if {ls_, rs_} != {"outer", "inner"}:
            return None
        if item.distinct:
            raise PlanError(
                "DISTINCT aggregates are not supported with inequality "
                "correlation"
            )
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        if ls_ == "inner":
            inner_key = self._rebase(e.left, -nleft)
            outer_key = e.right
            rel = e.op
        else:
            inner_key = self._rebase(e.right, -nleft)
            outer_key = e.left
            rel = flip[e.op]
        arg = (
            None
            if item.star or not item.args
            else self._bind_expr(item.args[0], inner_plan.schema()).expr
        )
        node = PrefixAggJoinExec(
            plan, inner_plan, outer_key, inner_key, rel, item.name, arg
        )
        agg_col = pe.Column(AGG_COL, nleft)
        outer_expr = self._bind_expr(outer_ast, lschema).expr
        cmp = (
            pe.BinaryExpr(agg_col, cmp_op, outer_expr)
            if sub_on_left
            else pe.BinaryExpr(outer_expr, cmp_op, agg_col)
        )
        return self._project_outer(FilterExec(node, cmp), lschema)

    def _decorrelate_subquery(self, plan: ExecPlan, node) -> ExecPlan:
        """Outer plan ⋉/▷ inner plan on the correlation predicates.

        The subquery's WHERE conjuncts split three ways: inner-only ->
        filter below the join; equality spanning outer+inner -> hash-join
        key pair; anything else spanning sides -> join filter."""
        sel = node.select
        if (
            sel.group_by
            or sel.having is not None
            or sel.limit is not None
            or any(self._contains_agg(it.expr) for it in sel.items)
        ):
            raise PlanError(
                "correlated subqueries with aggregation or LIMIT are not supported"
            )
        if isinstance(node, ast.InSubquery) and node.negated:
            return self._decorrelate_not_in(plan, node)
        inner_plan, on_pairs, filter_conjuncts, lschema, nleft = (
            self._split_correlation(plan, sel)
        )
        if isinstance(node, ast.InSubquery):
            if len(sel.items) != 1 or isinstance(sel.items[0].expr, ast.Star):
                raise PlanError("IN subquery must return exactly one column")
            on_pairs.append(
                (
                    self._bind_expr(node.child, lschema).expr,
                    self._bind_expr(sel.items[0].expr, inner_plan.schema()).expr,
                )
            )
        jt = "leftanti" if node.negated else "leftsemi"
        jf = (
            self._make_join_filter(filter_conjuncts, nleft)
            if filter_conjuncts
            else None
        )
        if on_pairs:
            return HashJoinExec(plan, inner_plan, on_pairs, jf, jt)
        return NestedLoopJoinExec(plan, inner_plan, jf, jt)

    def _flatten_and(self, e: ast.SqlExpr) -> list[ast.SqlExpr]:
        if isinstance(e, ast.Binary) and e.op == "AND":
            return self._flatten_and(e.left) + self._flatten_and(e.right)
        return [e]

    def _make_join(
        self, left: ExecPlan, right: ExecPlan, on_expr: ast.SqlExpr, join_type: str
    ) -> ExecPlan:
        lschema, rschema = left.schema(), right.schema()
        nleft = len(lschema)
        combined = lschema + rschema
        on_pairs: list[tuple[pe.PhysicalExpr, pe.PhysicalExpr]] = []
        filter_conjuncts: list[_Bound] = []
        for conj in self._flatten_and(on_expr):
            bound = self._bind_expr(conj, combined)
            pair = self._as_equi_pair(bound, nleft)
            if pair is not None:
                on_pairs.append(pair)
            else:
                filter_conjuncts.append(bound)
        jf = self._make_join_filter(filter_conjuncts, nleft) if filter_conjuncts else None
        if on_pairs:
            return HashJoinExec(left, right, on_pairs, jf, join_type)
        return NestedLoopJoinExec(left, right, jf, join_type)

    def _make_using_join(
        self, left: ExecPlan, right: ExecPlan, cols: tuple, join_type: str
    ) -> ExecPlan:
        """JOIN ... USING (c1, ...): equi-join on the named columns with
        the duplicate copies projected away, so each USING column appears
        ONCE in the output (SELECT * shows one copy; unqualified
        references are unambiguous).  The surviving copy sits at the left
        column's position under the left qualifier; its VALUES come from
        the left side (the right side for RIGHT joins, COALESCE of both
        for FULL joins, where either side can be NULL-extended)."""
        lschema, rschema = left.schema(), right.schema()
        nleft = len(lschema)
        on_pairs = []
        l_idx: list[int] = []
        r_idx: list[int] = []
        for col in cols:
            li = [i for i, (_, n) in enumerate(lschema) if n.lower() == col.lower()]
            ri = [i for i, (_, n) in enumerate(rschema) if n.lower() == col.lower()]
            if len(li) != 1 or len(ri) != 1:
                raise PlanError(
                    f"USING column '{col}' must appear exactly once on each side"
                )
            on_pairs.append(
                (pe.Column(lschema[li[0]][1], li[0]),
                 pe.Column(rschema[ri[0]][1], ri[0]))
            )
            l_idx.append(li[0])
            r_idx.append(ri[0])
        plan = HashJoinExec(left, right, on_pairs, None, join_type)
        if join_type in ("leftsemi", "leftanti", "rightsemi", "rightanti"):
            return plan  # single-sided output: nothing to dedup
        exprs, names, quals = [], [], []
        for i, (q, n) in enumerate(lschema):
            if i in l_idx:
                k = l_idx.index(i)
                rcol = pe.Column(rschema[r_idx[k]][1], nleft + r_idx[k])
                if join_type == "full":
                    exprs.append(pe.ScalarFuncExpr("coalesce", (pe.Column(n, i), rcol)))
                elif join_type == "right":
                    exprs.append(rcol)
                else:
                    exprs.append(pe.Column(n, i))
            else:
                exprs.append(pe.Column(n, i))
            names.append(n)
            quals.append(q)
        for j, (q, n) in enumerate(rschema):
            if j in r_idx:
                continue
            exprs.append(pe.Column(n, nleft + j))
            names.append(n)
            quals.append(q)
        return ProjectExec(plan, exprs, names, quals)

    def _make_join_from_where(
        self, left: ExecPlan, right: ExecPlan, conjuncts: list[ast.SqlExpr]
    ):
        """Comma cross-join + WHERE conjuncts -> pushed-down filters + join
        extraction (what DataFusion's predicate pushdown does for the
        reference's q2/q3-style queries).  Conjuncts that reference tables
        not yet in scope (3+-table comma joins) are returned unconsumed."""
        if not conjuncts:
            return NestedLoopJoinExec(left, right, None, "inner"), []
        lschema, rschema = left.schema(), right.schema()
        nleft = len(lschema)
        combined = lschema + rschema
        on_pairs = []
        filter_conjuncts = []
        left_filters, right_filters = [], []
        leftover: list[ast.SqlExpr] = []
        for conj in conjuncts:
            try:
                bound = self._bind_expr(conj, combined)
            except PlanError:
                leftover.append(conj)  # names a table not yet joined
                continue
            sides = {("l" if i < nleft else "r") for i in bound.col_indices}
            if sides == {"l"}:
                left_filters.append(bound.expr)
            elif sides == {"r"}:
                # rebase column indices to the right schema
                right_filters.append(self._rebase(bound.expr, -nleft))
            else:
                pair = self._as_equi_pair(bound, nleft)
                if pair is not None:
                    on_pairs.append(pair)
                else:
                    filter_conjuncts.append(bound)
        for f in left_filters:
            left = FilterExec(left, f)
        for f in right_filters:
            right = FilterExec(right, f)
        jf = self._make_join_filter(filter_conjuncts, nleft) if filter_conjuncts else None
        if on_pairs:
            return HashJoinExec(left, right, on_pairs, jf, "inner"), leftover
        return NestedLoopJoinExec(left, right, jf, "inner"), leftover

    def _rebase(self, expr: pe.PhysicalExpr, delta: int) -> pe.PhysicalExpr:
        def fn(node):
            if isinstance(node, pe.Column):
                return pe.Column(node.name, node.index + delta)
            return node

        return expr.transform(fn)

    def _as_equi_pair(self, bound: _Bound, nleft: int):
        """`col = col` spanning both sides -> (left_col, right_col)."""
        e = bound.expr
        if (
            isinstance(e, pe.BinaryExpr)
            and e.op == "="
            and isinstance(e.left, pe.Column)
            and isinstance(e.right, pe.Column)
        ):
            li, ri = e.left.index, e.right.index
            if li < nleft <= ri:
                return e.left, pe.Column(e.right.name, ri - nleft)
            if ri < nleft <= li:
                return e.right, pe.Column(e.left.name, li - nleft)
        return None

    def _make_join_filter(self, conjuncts: list[_Bound], nleft: int) -> pe.JoinFilter:
        """Build the compact filter schema (left-side columns first, by
        source index — DataFusion's layout, which the reference's
        `name@i` EXPLAIN strings and ColumnIndex mapping reflect)."""
        used: set[tuple[str, int]] = set()
        for b in conjuncts:
            for i in b.col_indices:
                side = pe.LEFT if i < nleft else pe.RIGHT
                src = i if i < nleft else i - nleft
                used.add((side, src))
        ordered = sorted(used, key=lambda t: (0 if t[0] == pe.LEFT else 1, t[1]))
        col_indices = tuple(pe.ColumnIndex(src, side) for side, src in ordered)
        remap = { (side, src): pos for pos, (side, src) in enumerate(ordered) }

        def rewrite(nleft_=nleft):
            def fn(node):
                if isinstance(node, pe.Column):
                    side = pe.LEFT if node.index < nleft_ else pe.RIGHT
                    src = node.index if node.index < nleft_ else node.index - nleft_
                    return pe.Column(node.name, remap[(side, src)])
                return node

            return fn

        exprs = [b.expr.transform(rewrite()) for b in conjuncts]
        combined = exprs[0]
        for e in exprs[1:]:
            combined = pe.BinaryExpr(combined, "AND", e)
        return pe.JoinFilter(combined, col_indices)

    # -- expressions ----------------------------------------------------
    def _resolve_column(self, ref: ast.ColRef, schema) -> int:
        cands = []
        for i, (qual, name) in enumerate(schema):
            if name == ref.name or name.lower() == ref.name.lower():
                if ref.qualifier is None or (
                    qual is not None and qual.lower() == ref.qualifier.lower()
                ):
                    cands.append(i)
        if not cands and ref.qualifier is not None:
            # aggregate outputs drop qualifiers; fall back to bare-name
            # resolution when unambiguous (ORDER BY t.col after GROUP BY)
            bare = [
                i
                for i, (qual, name) in enumerate(schema)
                if qual is None and name.lower() == ref.name.lower()
            ]
            if len(bare) == 1:
                return bare[0]
        if not cands:
            raise PlanError(f"column '{ref.display()}' not found")
        if len(cands) > 1 and ref.qualifier is None:
            raise PlanError(f"column '{ref.name}' is ambiguous")
        return cands[0]

    def _bind_expr(self, e: ast.SqlExpr, schema) -> _Bound:
        cols: list[int] = []

        def go(node: ast.SqlExpr) -> pe.PhysicalExpr:
            if isinstance(node, ast.Lit):
                return pe.Literal(node.value)
            if isinstance(node, ast.Param):
                raise PlanError(
                    f"parameter ${node.index} is unbound; run via "
                    "PREPARE ... / EXECUTE name(values)"
                )
            if isinstance(node, ast.Interval):
                return pe.Literal(_parse_interval(node.value, node.unit))
            if isinstance(node, ast.ColRef):
                idx = self._resolve_column(node, schema)
                cols.append(idx)
                return pe.Column(schema[idx][1], idx)
            if isinstance(node, ast.Binary):
                return pe.BinaryExpr(go(node.left), node.op, go(node.right))
            if isinstance(node, ast.Unary):
                if node.op == "NOT":
                    return pe.NotExpr(go(node.child))
                return pe.NegExpr(go(node.child))
            if isinstance(node, ast.Cast):
                return pe.CastExpr(go(node.child), node.type_name)
            if isinstance(node, ast.Case):
                return pe.CaseExpr(
                    tuple((go(c), go(r)) for c, r in node.whens),
                    go(node.else_) if node.else_ is not None else None,
                )
            if isinstance(node, ast.Like):
                return pe.LikeExpr(
                    go(node.child), go(node.pattern),
                    node.negated, node.case_insensitive,
                )
            if isinstance(node, ast.DistinctFrom):
                return pe.DistinctFromExpr(
                    go(node.left), go(node.right), node.negated
                )
            if isinstance(node, ast.InList):
                child = go(node.child)
                vals, exprs = [], []
                for it in node.items:
                    b = go(it)
                    exprs.append(b)
                    vals.append(b.value if isinstance(b, pe.Literal) else None)
                if all(isinstance(x, pe.Literal) for x in exprs):
                    return pe.InListExpr(
                        child,
                        tuple(vals),
                        node.negated,
                        has_null=any(v is None for v in vals),
                    )
                # non-literal items: desugar to an OR chain of equalities
                cond = None
                for b in exprs:
                    eq = pe.BinaryExpr(child, "=", b)
                    cond = eq if cond is None else pe.BinaryExpr(cond, "OR", eq)
                return pe.NotExpr(cond) if node.negated else cond
            if isinstance(node, ast.InSubquery):
                sub = self._run_subquery(node.select, "IN")
                if len(sub.column_names) != 1:
                    raise PlanError(
                        "IN subquery must return exactly one column, got "
                        f"{len(sub.column_names)}"
                    )
                col = sub.column(0)
                if sub.num_rows >= 4096:
                    # large subquery results stay numpy: tuple(to_pylist)
                    # + the any() null scan cost ~240 ms at 500k rows
                    nn = col.combine_chunks().drop_null()
                    try:
                        values = nn.to_numpy(zero_copy_only=False)
                    except Exception:
                        values = np.asarray(nn.to_pylist(), dtype=object)
                    return pe.InListExpr(
                        go(node.child),
                        values,
                        node.negated,
                        has_null=col.null_count > 0,
                    )
                values = tuple(sub.to_pylist_column(0))
                return pe.InListExpr(
                    go(node.child),
                    values,
                    node.negated,
                    has_null=any(v is None for v in values),
                )
            if isinstance(node, ast.Exists):
                sub = self._run_subquery(node.select, "EXISTS")
                return pe.Literal((sub.num_rows > 0) != node.negated)
            if isinstance(node, ast.ScalarSubquery):
                sub = self._run_subquery(node.select, "scalar")
                if len(sub.column_names) != 1:
                    raise PlanError(
                        "scalar subquery must return exactly one column"
                    )
                if sub.num_rows > 1:
                    raise PlanError(
                        "more than one row returned by a subquery used as an expression"
                    )
                vals = sub.to_pylist_column(0)
                return pe.Literal(vals[0] if vals else None)
            if isinstance(node, ast.Func):
                if node.name in _AGG_FUNCS:
                    raise PlanError(
                        f"aggregate function {node.name} not allowed in this context"
                    )
                if node.name == "arrow_cast":
                    # arrow_cast(expr, 'Type') — DataFusion's typed cast;
                    # arrow type names map onto the engine's SQL casts
                    if len(node.args) != 2 or not (
                        isinstance(node.args[1], ast.Lit)
                        and isinstance(node.args[1].value, str)
                    ):
                        raise PlanError(
                            "arrow_cast takes (expr, 'ArrowType' literal)"
                        )
                    t = node.args[1].value.strip()
                    base = t.split("(", 1)[0].lower()
                    mapped = {
                        "int8": "INT", "int16": "INT", "int32": "INT",
                        "int64": "INT", "uint8": "INT", "uint16": "INT",
                        "uint32": "INT", "uint64": "INT",
                        "float16": "FLOAT", "float32": "FLOAT",
                        "float64": "FLOAT",
                        "utf8": "VARCHAR", "largeutf8": "VARCHAR",
                        "utf8view": "VARCHAR",
                        "boolean": "BOOLEAN",
                        "date32": "DATE", "date64": "DATE",
                        "timestamp": "TIMESTAMP",
                    }.get(base)
                    if mapped is None:
                        raise PlanError(f"arrow_cast: unsupported type {t!r}")
                    return pe.CastExpr(go(node.args[0]), mapped)
                if node.name in pe.SCALAR_FUNCS:
                    if node.star or node.distinct:
                        raise PlanError(
                            f"invalid arguments for {node.name}()"
                        )
                    if node.order_by:
                        raise PlanError(
                            f"ORDER BY inside {node.name}() is not supported"
                        )
                    lo_a, hi_a = pe.SCALAR_FUNC_ARITY[node.name]
                    if len(node.args) < lo_a or (
                        hi_a is not None and len(node.args) > hi_a
                    ):
                        raise PlanError(
                            f"{node.name}() takes "
                            + (f"{lo_a}" if lo_a == hi_a else f"{lo_a}-{hi_a or 'N'}")
                            + f" arguments, got {len(node.args)}"
                        )
                    return pe.ScalarFuncExpr(
                        node.name, tuple(go(a) for a in node.args)
                    )
                raise PlanError(f"unknown function: {node.name}")
            raise PlanError(f"unsupported expression: {node}")

        return _Bound(go(e), cols)

    # -- projection / aggregation --------------------------------------
    def _contains_agg(self, e: ast.SqlExpr) -> bool:
        if isinstance(e, ast.Func):
            return e.name in _AGG_FUNCS or any(
                self._contains_agg(a) for a in e.args
            )
        if isinstance(e, ast.Binary):
            return self._contains_agg(e.left) or self._contains_agg(e.right)
        if isinstance(e, (ast.Unary, ast.Cast, ast.Like)):
            return self._contains_agg(e.child)
        if isinstance(e, ast.Case):
            return (
                any(
                    self._contains_agg(c) or self._contains_agg(r)
                    for c, r in e.whens
                )
                or (e.else_ is not None and self._contains_agg(e.else_))
            )
        if isinstance(e, ast.InList):
            return self._contains_agg(e.child)
        return False

    def _expand_star(self, item: ast.SelectItem, schema):
        star: ast.Star = item.expr
        excl = {e.lower() for e in star.exclude}
        matched = set()
        out = []
        for i, (qual, name) in enumerate(schema):
            if star.qualifier is None or (
                qual is not None and qual.lower() == star.qualifier.lower()
            ):
                if name.lower() in excl:
                    matched.add(name.lower())
                    continue
                out.append((pe.Column(name, i), name, qual))
        missing = excl - matched
        if missing:
            raise PlanError(
                f"EXCLUDE column(s) not found: {', '.join(sorted(missing))}"
            )
        if not out:
            raise PlanError(f"no columns match {star.qualifier}.*")
        return out

    def _display_name(self, e: ast.SqlExpr) -> str:
        if isinstance(e, ast.ColRef):
            return e.name
        if isinstance(e, ast.Func):
            if e.star:
                base = f"{e.name}(*)"
            else:
                args = ",".join(self._display_name(a) for a in e.args)
                inner = f"DISTINCT {args}" if e.distinct else args
                base = f"{e.name}({inner})"
            if e.order_by:
                # differently-ordered collectors must not dedupe either
                keys = ",".join(
                    self._display_name(oi.expr) + ("" if oi.asc else " DESC")
                    for oi in e.order_by
                )
                base = base[:-1] + f" ORDER BY {keys})"
            if e.filter_where is not None:
                # distinct filters must not dedupe to one spec
                base += f" FILTER (WHERE {self._display_name(e.filter_where)})"
            return base
        if isinstance(e, ast.Lit):
            return str(e.value)
        if isinstance(e, ast.Binary):
            return f"{self._display_name(e.left)} {e.op} {self._display_name(e.right)}"
        if isinstance(e, ast.Cast):
            # DataFusion names a cast column after the inner expression
            return self._display_name(e.child)
        return "expr"

    def _bind_projection(self, plan: ExecPlan, sel: ast.Select) -> ExecPlan:
        schema = plan.schema()
        exprs, names, quals = [], [], []
        all_star = True
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                for col_expr, name, qual in self._expand_star(item, schema):
                    exprs.append(col_expr)
                    names.append(name)
                    quals.append(qual)
                if item.expr.qualifier is not None or item.expr.exclude:
                    all_star = False
            else:
                all_star = False
                bound = self._bind_expr(item.expr, schema)
                exprs.append(bound.expr)
                names.append(item.alias or self._display_name(item.expr))
                quals.append(None)
        if all_star and len(sel.items) == 1:
            return plan  # SELECT * passthrough
        return ProjectExec(plan, exprs, names, quals)

    def _bind_agg_value_expr(
        self, e: ast.SqlExpr, aschema, alias_map=None
    ) -> pe.PhysicalExpr:
        """Bind an expression over an aggregate's OUTPUT schema: aggregate
        calls resolve by display name, plain columns by name (HAVING).
        ``alias_map`` maps canonical aggregate displays to the aliased
        output column the spec was registered under (count(*) AS n)."""
        names = [n for _, n in aschema]
        if isinstance(e, ast.Func) and e.name in _AGG_FUNCS:
            disp = self._display_name(e)
            if disp in names:
                return pe.Column(disp, names.index(disp))
            if alias_map and alias_map.get(disp) in names:
                d2 = alias_map[disp]
                return pe.Column(d2, names.index(d2))
            raise PlanError(f"aggregate '{disp}' not available after grouping")
        if isinstance(e, ast.Lit):
            return pe.Literal(e.value)
        if isinstance(e, ast.Binary):
            return pe.BinaryExpr(
                self._bind_agg_value_expr(e.left, aschema, alias_map),
                e.op,
                self._bind_agg_value_expr(e.right, aschema, alias_map),
            )
        if isinstance(e, ast.Unary):
            child = self._bind_agg_value_expr(e.child, aschema, alias_map)
            return pe.NotExpr(child) if e.op == "NOT" else pe.NegExpr(child)
        if isinstance(e, ast.Func) and e.name in pe.SCALAR_FUNCS:
            return pe.ScalarFuncExpr(
                e.name,
                tuple(self._bind_agg_value_expr(a, aschema, alias_map) for a in e.args),
            )
        if isinstance(e, ast.Cast):
            return pe.CastExpr(
                self._bind_agg_value_expr(e.child, aschema, alias_map), e.type_name
            )
        if isinstance(e, ast.Case):
            return pe.CaseExpr(
                tuple(
                    (
                        self._bind_agg_value_expr(c, aschema, alias_map),
                        self._bind_agg_value_expr(r, aschema, alias_map),
                    )
                    for c, r in e.whens
                ),
                self._bind_agg_value_expr(e.else_, aschema, alias_map)
                if e.else_ is not None
                else None,
            )
        if isinstance(e, ast.Like):
            return pe.LikeExpr(
                self._bind_agg_value_expr(e.child, aschema, alias_map),
                self._bind_agg_value_expr(e.pattern, aschema, alias_map),
                e.negated,
                e.case_insensitive,
            )
        if isinstance(e, ast.InList):
            items = tuple(self._bind_agg_value_expr(a, aschema, alias_map) for a in e.items)
            if all(isinstance(x, pe.Literal) for x in items):
                vals = tuple(x.value for x in items)
                return pe.InListExpr(
                    self._bind_agg_value_expr(e.child, aschema, alias_map),
                    vals,
                    e.negated,
                    has_null=any(v is None for v in vals),
                )
            raise PlanError("IN over aggregates requires literal items")
        if isinstance(e, ast.ColRef):
            return self._bind_expr(e, aschema).expr
        raise PlanError(f"unsupported HAVING expression: {e}")

    def _collect_agg_funcs(self, e: ast.SqlExpr) -> list:
        if isinstance(e, ast.Func):
            if e.name in _AGG_FUNCS:
                return [e]
            return [f for a in e.args for f in self._collect_agg_funcs(a)]
        if isinstance(e, ast.Binary):
            return self._collect_agg_funcs(e.left) + self._collect_agg_funcs(e.right)
        if isinstance(e, (ast.Unary, ast.Cast)):
            return self._collect_agg_funcs(e.child)
        if isinstance(e, ast.Case):
            out = []
            for c, r in e.whens:
                out += self._collect_agg_funcs(c) + self._collect_agg_funcs(r)
            if e.else_ is not None:
                out += self._collect_agg_funcs(e.else_)
            return out
        return []

    @staticmethod
    def _ordinal(e) -> int | None:
        """1-based select-list position for a bare integer literal."""
        if isinstance(e, ast.Lit) and isinstance(e.value, int) and not isinstance(
            e.value, bool
        ):
            return e.value
        return None

    def _effective_items(self, sel: ast.Select, schema):
        """SELECT items with `*` / `alias.*` expanded against the input
        schema, so ordinals count real output columns."""
        out = []
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                for _, name, qual in self._expand_star(item, schema):
                    out.append(ast.SelectItem(ast.ColRef(qual, name), None))
            else:
                out.append(item)
        return out

    def _substitute_aliases(self, e, sel: ast.Select, schema):
        """Replace bare ColRefs that only resolve as SELECT aliases with
        their aliased expressions (generic dataclass walk); input columns
        shadow aliases, matching sqlite's fallback resolution."""
        alias_map = {
            it.alias.lower(): it.expr
            for it in sel.items
            if it.alias is not None
        }
        if not alias_map:
            return e

        def go(node):
            if isinstance(node, (ast.Select, ast.Union)):
                # subqueries are their own scope: never rewrite inside
                return node
            if isinstance(node, ast.ColRef) and node.qualifier is None:
                key = node.name.lower()
                if key in alias_map:
                    try:
                        self._resolve_column(node, schema)
                        return node  # a real input column shadows the alias
                    except PlanError as exc:
                        if "ambiguous" in str(exc):
                            raise  # sqlite errors here too; don't mask
                        return alias_map[key]
                return node
            if dataclasses.is_dataclass(node) and not isinstance(node, type):
                changes = {}
                for f in dataclasses.fields(node):
                    v = getattr(node, f.name)
                    nv = go(v)
                    if nv is not v:
                        changes[f.name] = nv
                return (
                    dataclasses.replace(node, **changes) if changes else node
                )
            if isinstance(node, tuple):
                out = tuple(go(x) for x in node)
                if any(a is not b for a, b in zip(out, node)):
                    return out
                return node
            return node

        return go(e)

    def _resolve_item_ref(self, e, sel: ast.Select, schema, alias_wins: bool):
        """SELECT-alias or 1-based ordinal reference -> (target_expr,
        display_name) — standard GROUP BY / ORDER BY shorthand.

        alias_wins: ORDER BY prefers the output alias for a bare name;
        GROUP BY prefers the input column (Postgres/sqlite resolution)."""
        k = self._ordinal(e)
        if k is not None:
            items = self._effective_items(sel, schema)
            if not 1 <= k <= len(items):
                raise PlanError(
                    f"ORDER/GROUP BY position {k} is not in the select list"
                )
            item = items[k - 1]
            return item.expr, item.alias or self._display_name(item.expr)
        if isinstance(e, ast.ColRef) and e.qualifier is None:
            if not alias_wins:
                # input column shadows the alias when it resolves
                try:
                    self._resolve_column(e, schema)
                    return e, self._display_name(e)
                except PlanError:
                    pass
            for item in sel.items:
                if item.alias == e.name:
                    return item.expr, item.alias
        return e, self._display_name(e)

    def _bind_aggregate(self, plan: ExecPlan, sel: ast.Select) -> ExecPlan:
        schema = plan.schema()
        items = self._effective_items(sel, schema)
        # -- expand ROLLUP / CUBE / GROUPING SETS into index sets --------
        import itertools as _it

        plain_items: list = []
        families: list[list[tuple]] = []
        gb_items = sel.group_by
        if len(gb_items) == 1 and isinstance(gb_items[0], ast.GroupByAll):
            # GROUP BY ALL: every non-aggregate select item is a key
            if any(isinstance(it.expr, ast.Star) for it in items):
                raise PlanError("GROUP BY ALL cannot be used with SELECT *")
            gb_items = tuple(
                it.expr for it in items if not self._contains_agg(it.expr)
            )
        for g in gb_items:
            if isinstance(g, ast.GroupingSets):
                families.append([tuple(s) for s in g.sets])
            elif (
                isinstance(g, ast.Func)
                and not g.star
                and g.name in ("rollup", "cube")
            ):
                if g.name == "rollup":
                    fam = [
                        tuple(g.args[:i])
                        for i in range(len(g.args), -1, -1)
                    ]
                else:
                    fam = [
                        tuple(c)
                        for r in range(len(g.args), -1, -1)
                        for c in _it.combinations(g.args, r)
                    ]
                families.append(fam)
            else:
                plain_items.append(g)

        group_exprs, group_names, group_targets = [], [], []
        uniq_targets: list = []

        def ensure_group(g) -> int:
            target, disp = self._resolve_item_ref(
                g, sel, schema, alias_wins=False
            )
            for i, t in enumerate(uniq_targets):
                if t == target:
                    return i
            uniq_targets.append(target)
            b = self._bind_expr(target, schema)
            group_exprs.append(b.expr)
            group_names.append(disp)
            group_targets.append(target)
            return len(uniq_targets) - 1

        plain_idx = [ensure_group(g) for g in plain_items]
        if families:
            fam_idx = [
                [tuple(ensure_group(g) for g in s) for s in fam]
                for fam in families
            ]
            grouping_sets = [
                tuple(dict.fromkeys(plain_idx + [i for s in combo for i in s]))
                for combo in _it.product(*fam_idx)
            ]
        else:
            grouping_sets = None

        agg_specs = []
        existing: set = set()
        # canonical display -> registered output column, so HAVING /
        # ORDER BY reuse `count(*) AS n` instead of computing a twin spec
        canon_map: dict[str, str] = {}

        def ensure_spec(f: ast.Func, out_name=None):
            """Register an aggregate call as a spec (dedup by display,
            including aliased twins via canon_map)."""
            canon = self._display_name(f)
            if out_name is None and canon in canon_map:
                return canon_map[canon]
            disp = out_name or canon
            if disp in existing:
                canon_map.setdefault(canon, disp)
                return disp
            if f.star or (
                f.name == "count"
                and len(f.args) == 1
                and isinstance(f.args[0], ast.Lit)
                and f.args[0].value is not None
            ):
                # count(<non-null literal>) == count(*); count(NULL) is 0
                # and must keep its argument so NULL-skipping applies
                arg = None
            elif f.name in _AGG_TWO_ARG and len(f.args) == 2:
                arg = tuple(
                    self._bind_expr(a, schema).expr for a in f.args
                )
            elif f.name == "group_concat" and len(f.args) == 2:
                # group_concat(x, sep) — sqlite/MySQL form of string_agg
                arg = tuple(
                    self._bind_expr(a, schema).expr for a in f.args
                )
            elif len(f.args) == 1:
                arg = self._bind_expr(f.args[0], schema).expr
            elif f.name in _AGG_TWO_ARG:
                raise PlanError(f"{f.name} takes two arguments")
            else:
                raise PlanError(f"{f.name} takes one argument")
            filt = (
                self._bind_expr(f.filter_where, schema).expr
                if f.filter_where is not None
                else None
            )
            ord_spec = None
            if f.order_by:
                if f.name not in (
                    "array_agg", "string_agg", "group_concat",
                    "first_value", "last_value",
                ):
                    raise PlanError(
                        f"ORDER BY inside {f.name}() is not supported"
                    )
                if f.distinct:
                    raise PlanError(
                        f"{f.name}(DISTINCT ... ORDER BY ...) is not "
                        "supported"
                    )
                ord_spec = tuple(
                    (self._bind_expr(oi.expr, schema).expr, oi.asc,
                     oi.nulls_first)
                    for oi in f.order_by
                )
            agg_specs.append((f.name, arg, f.distinct, disp, filt, ord_spec))
            existing.add(disp)
            canon_map.setdefault(canon, disp)
            return disp

        out_items = []  # ('agg', name) | ('group', src, out) | ('expr', ast, out)
        for item in items:
            e = item.expr
            if isinstance(e, ast.Func) and e.name in _AGG_FUNCS:
                name = ensure_spec(e, item.alias or self._display_name(e))
                out_items.append(("agg", name))
            elif self._contains_agg(e):
                # expression over aggregates (round(avg(v),1), sum/count..):
                # inner calls become hidden specs, the item evaluates over
                # the aggregate output schema
                for f in self._collect_agg_funcs(e):
                    ensure_spec(f)
                out_items.append(
                    ("expr", e, item.alias or self._display_name(e))
                )
            elif not self._bind_expr(e, schema).col_indices:
                # constant expression (no column refs): legal alongside
                # aggregates without GROUP BY membership (Postgres rule)
                out_items.append(
                    ("expr", e, item.alias or self._display_name(e))
                )
            else:
                # must be a grouped expression: match by display name or by
                # structural equality with a resolved GROUP BY target (an
                # alias match alone is NOT enough — `SELECT x AS g ...
                # GROUP BY g` groups by input column g, so x itself is
                # ungrouped and rejected, as in Postgres/DataFusion)
                name = self._display_name(e)
                key = name if name in group_names else None
                if key is None:
                    for tgt, disp in zip(group_targets, group_names):
                        if tgt == e:
                            key = disp
                            break
                if key is None:
                    raise PlanError(
                        f"'{name}' must appear in GROUP BY or an aggregate"
                    )
                # (source name in the aggregate schema, output name)
                out_items.append(("group", key, item.alias or name))
        # HAVING may reference aggregates not in the SELECT list: compute
        # them as hidden specs, filter, then project them away.
        if sel.having is not None:
            for f in self._collect_agg_funcs(sel.having):
                ensure_spec(f)
        # ORDER BY may likewise reference aggregates not in the SELECT
        # list (ORDER BY count(*) DESC): compute hidden specs and emit
        # __sort_<i> columns; bind_select sorts on them and strips them.
        order_hidden: dict[int, object] = {}
        for i, oi in enumerate(sel.order_by or ()):
            if self._ordinal(oi.expr) is not None:
                continue
            if not self._contains_agg(oi.expr):
                continue
            disp = self._display_name(oi.expr)
            visible = any(
                (it[0] == "agg" and it[1] == disp)
                or (len(it) == 3 and it[2] == disp)
                for it in out_items
            )
            if visible:
                continue
            for f in self._collect_agg_funcs(oi.expr):
                ensure_spec(f)
            order_hidden[i] = oi.expr

        agg = AggregateExec(
            plan, group_exprs, group_names, agg_specs, grouping_sets
        )
        plan_after = agg
        if sel.having is not None:
            plan_after = FilterExec(
                agg,
                self._bind_agg_value_expr(
                    sel.having, agg.schema(), canon_map
                ),
            )
        # project to select-list order/aliases
        aschema = agg.schema()
        exprs, names = [], []
        for kind, src, out_name in (
            it if len(it) == 3 else (it[0], it[1], it[1]) for it in out_items
        ):
            if kind == "expr":
                exprs.append(self._bind_agg_value_expr(src, aschema, canon_map))
            else:
                idx = next(
                    i for i, (_, n) in enumerate(aschema) if n == src
                )
                exprs.append(pe.Column(aschema[idx][1], idx))
            names.append(out_name)
        for i, e in order_hidden.items():
            exprs.append(self._bind_agg_value_expr(e, aschema, canon_map))
            names.append(f"__sort_{i}")
        has_expr_items = any(it[0] == "expr" for it in out_items)
        if (
            names == [n for _, n in aschema]
            and plan_after is agg
            and not has_expr_items
            and not order_hidden
        ):
            return agg
        return ProjectExec(plan_after, exprs, names)
