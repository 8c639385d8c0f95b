"""SessionContext: the engine's embedding entry point.

Role-equivalent of the reference's SeQuiLaSessionExt +
SessionContext::new_with_sequila (reference session_context.rs:16-48): a
catalog of registered tables, a SequilaConfig settable via SQL
`SET sequila.* = ...`, and a `sql()` method that parses, plans, optimizes
(interval-join rewrite + count fast path) and executes statements.

Standard `datafusion.*` SET keys are accepted for compatibility with the
reference's recommended pragmas (repartition_joins, coalesce_batches,
target_partitions — see reference README and queries/q1-coitrees.sql) and
mapped onto this engine's knobs where they have an analog.

The session names the torch device its join kernels run on
(``SessionContext(device="cuda")``, the default).  The CPU runs them only
when it is named; a session on a missing card fails at construction.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import pyarrow as pa
import torch

from sequila_tpu_torch.config import SequilaConfig
from sequila_tpu_torch.errors import ExecutionError, PlanError
from sequila_tpu_torch.exec.context import ExecContext
from sequila_tpu_torch.io.readers import read_table
from sequila_tpu_torch.models.table import Table, pretty_format
from sequila_tpu_torch.planner.binder import Binder
from sequila_tpu_torch.planner.optimizer import (
    CountFastPathRule,
    IntervalJoinRule,
    PredicatePushdownRule,
    ProjectionPushdownRule,
)
from sequila_tpu_torch.sql import ast
from sequila_tpu_torch.sql.parser import parse_sql
from sequila_tpu_torch.utils.logging import get_logger
from sequila_tpu_torch.utils.metrics import PROGRAM, collecting, merge_into_chrome_trace, span

log = get_logger(__name__)


def _stmt_references(node, key: str) -> bool:
    """Does this AST subtree contain a table reference to ``key``?
    Generic dataclass walk — subqueries, joins and nested WITHs are all
    dataclass fields holding tuples of dataclasses."""
    import dataclasses as _dc

    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, (tuple, list)):
            stack.extend(n)
            continue
        if _dc.is_dataclass(n) and not isinstance(n, type):
            if isinstance(n, ast.TableRef) and (
                n.name or ""
            ).lower() == key:
                return True
            stack.extend(getattr(n, f.name) for f in _dc.fields(n))
    return False


def _rename_columns(t: Table, names) -> Table:
    names = list(names)
    if len(names) != len(t.column_names):
        raise PlanError(
            f"CTE column list has {len(names)} names for "
            f"{len(t.column_names)} columns"
        )
    if names == list(t.column_names):
        return t
    return Table(t.arrow.rename_columns(names))


def _distinct_rows(t: Table, seen: set) -> tuple[Table, set]:
    """Keep the first occurrence of each row not already in ``seen``
    (UNION-recursion dedup); returns the filtered table and updated set."""
    cols = [t.arrow.column(i).to_pylist() for i in range(t.arrow.num_columns)]
    keep = []
    for i, row in enumerate(zip(*cols)) if cols else ():
        if row not in seen:
            seen.add(row)
            keep.append(i)
    if not cols:
        return t, seen
    if len(keep) == t.num_rows:
        return t, seen
    return Table(t.arrow.take(pa.array(keep, type=pa.int64()))), seen

_SQL_TYPES = {
    "VARCHAR": pa.string(),
    "TEXT": pa.string(),
    "STRING": pa.string(),
    "CHAR": pa.string(),
    "INTEGER": pa.int32(),
    "INT": pa.int32(),
    "SMALLINT": pa.int16(),
    "BIGINT": pa.int64(),
    "FLOAT": pa.float32(),
    "REAL": pa.float32(),
    "DOUBLE": pa.float64(),
    "BOOLEAN": pa.bool_(),
}


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; name device='cpu' to run the kernels' plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    return dev


class SessionContext:
    def __init__(self, config: SequilaConfig | None = None, device="cuda"):
        self.config = config or SequilaConfig()
        self.device = _resolve_device(device)
        self.catalog: dict[str, Table] = {}
        self.views: dict[str, ast.Select] = {}  # values: Select | Union
        self.datafusion_options: dict[str, str] = {}
        self.prepared: dict[str, ast.Prepare] = {}
        self.last_metrics = None
        # in-flight view names, shared across Binder instances so cycles
        # through set-operation views are detected (binder.py _scan)
        self._view_guard: list[str] = []

    # -- embedding API ------------------------------------------------------
    def register_table(self, name: str, table: Table | pa.Table) -> None:
        if isinstance(table, pa.Table):
            table = Table(table)
        self.catalog[name.lower()] = table

    def deregister_table(self, name: str) -> None:
        self.catalog.pop(name.lower(), None)

    def table(self, name: str) -> Table:
        if name.lower() not in self.catalog:
            raise PlanError(f"table '{name}' not found")
        return self.catalog[name.lower()]

    # -- SQL ----------------------------------------------------------------
    def sql(self, text: str) -> Table | None:
        """Execute one or more ;-separated statements; returns the result of
        the last result-producing statement.  Recorded as the root span
        ``session.sql`` over ``session.parse`` and each statement's spans."""
        result: Table | None = None
        with span("session.sql"):
            with span("session.parse"):
                stmts = parse_sql(text)
            for stmt in stmts:
                out = self._execute_statement(stmt)
                if out is not None:
                    result = out
        return result

    def sql_batches(self, text: str):
        """Batch-at-a-time query execution: yields Tables whose
        concatenation equals ``sql(text)``'s result, without ever holding
        the whole result table (the reference's streamed RecordBatch
        delivery, interval_join.rs:1338-1420).  A SELECT whose plan can
        stream (interval joins, filters, projections, limits) yields
        bounded batches of ~4x max_output_batch_size rows; barrier plans
        (sorts, aggregates) and non-SELECT statements yield one batch.
        Leading ;-separated statements (SET, DDL) are executed first."""
        with span("session.parse"):
            stmts = parse_sql(text)
        for stmt in stmts[:-1]:
            self._execute_statement(stmt)
        yield from self._statement_batches(stmts[-1])

    def _statement_batches(self, stmt):
        if isinstance(stmt, ast.With):
            with self._cte_scope(stmt.ctes, recursive=stmt.recursive):
                yield from self._statement_batches(stmt.body)
            return
        if isinstance(stmt, ast.Select):
            ctx = ExecContext(self.config.copy())
            with collecting(ctx.metrics):
                plan = self.create_physical_plan(stmt)
            yield from plan.execute_batches(ctx)
            self.last_metrics = ctx.metrics
            return
        out = self._execute_statement(stmt)
        if out is not None:
            yield out

    def _run_query(self, stmt) -> Table:
        """Execute a query statement: a plain SELECT, a set-operation
        chain (UNION/INTERSECT/EXCEPT), or a WITH-wrapped query."""
        if isinstance(stmt, ast.With):
            with self._cte_scope(stmt.ctes, recursive=stmt.recursive):
                return self._run_query(stmt.body)
        if isinstance(stmt, ast.Union):
            return self._run_union(stmt)
        return self._run_select(stmt)

    @contextmanager
    def _cte_scope(self, ctes, recursive: bool = False):
        """Materialize CTEs as session tables for the scope's duration
        (each may reference earlier ones); shadowed tables/views are
        restored on exit.  DataFusion inlines CTE plans instead — eager
        materialization is result-equivalent for the CTEs accepted here
        and lets every lookup path (joins, subqueries, EXPLAIN) resolve
        them with no special cases.  Under WITH RECURSIVE, each
        self-referencing cte iterates to a fixpoint before registration."""
        saved_tables: dict[str, Table] = {}
        saved_views: dict = {}
        added: list[str] = []
        try:
            for name, cols, q in ctes:
                key = name.lower()
                if key in self.views and key not in saved_views:
                    saved_views[key] = self.views.pop(key)
                if key in self.catalog and key not in saved_tables:
                    saved_tables[key] = self.catalog[key]
                else:
                    added.append(key)
                if recursive and _stmt_references(q, key):
                    out = self._run_recursive_cte(key, cols, q)
                else:
                    out = self._run_query(q)
                    if cols is not None:
                        out = _rename_columns(out, cols)
                self.catalog[key] = out
            yield
        finally:
            for key in added:
                self.catalog.pop(key, None)
            self.catalog.update(saved_tables)
            self.views.update(saved_views)

    def _run_recursive_cte(self, key: str, cols, q) -> Table:
        """Iterate <base> UNION [ALL] <step> to a fixpoint (Postgres
        semantics: the step sees only the PREVIOUS iteration's rows;
        UNION dedups against every row produced so far and the loop
        stops when an iteration adds nothing new)."""
        if not isinstance(q, ast.Union) or len(q.selects) < 2:
            raise PlanError(
                f"recursive CTE '{key}' must be <base> UNION [ALL] "
                "<recursive term>"
            )
        if q.order_by or q.limit is not None or q.offset:
            raise PlanError(
                "ORDER BY / LIMIT are not allowed in a recursive CTE body"
            )
        step_term = q.selects[-1]
        dedup = q.ops[-1] == "union"
        for s in q.selects[:-1]:
            if _stmt_references(s, key):
                raise PlanError(
                    f"recursive reference to '{key}' is only allowed in "
                    "the final UNION branch"
                )
        if len(q.selects) == 2:
            base = self._run_query(q.selects[0])
        else:
            base = self._run_union(
                ast.Union(q.selects[:-1], q.ops[:-1], None, None, None)
            )
        if cols is not None:
            base = _rename_columns(base, cols)
        names = base.column_names
        seen: set | None = None
        if dedup:
            base, seen = _distinct_rows(base, set())
        max_iters = int(os.environ.get("SEQUILA_RECURSION_LIMIT", "10000"))
        pieces = [base.arrow]
        working = base
        iters = 0
        while working.num_rows:
            iters += 1
            if iters > max_iters:
                raise ExecutionError(
                    f"recursive CTE '{key}' exceeded "
                    f"{max_iters} iterations (SEQUILA_RECURSION_LIMIT)"
                )
            self.catalog[key] = working
            step = self._run_query(step_term)
            if len(step.column_names) != len(names):
                raise PlanError(
                    f"recursive CTE '{key}': step returns "
                    f"{len(step.column_names)} columns, expected {len(names)}"
                )
            step = _rename_columns(step, names)
            if dedup:
                step, seen = _distinct_rows(step, seen)
            if step.num_rows == 0:
                break
            pieces.append(step.arrow)
            working = step
        from sequila_tpu_torch.models.table import concat_tables_unify

        return Table(concat_tables_unify(pieces))

    def _validate_query(self, stmt) -> None:
        """Bind a query statement now to surface errors early (results
        discarded); recurses into set-operation branches."""
        if isinstance(stmt, ast.Union):
            for s in stmt.selects:
                self._validate_query(s)
            return
        Binder(
            self.catalog, runner=self._run_query, views=self.views,
            view_guard=self._view_guard, info_schema=self._info_schema, device=self.device,
        ).bind_select(stmt)

    def _insert_into(self, stmt: ast.InsertInto) -> None:
        key = stmt.name.lower()
        if key not in self.catalog:
            raise PlanError(f"table '{stmt.name}' not found")
        target = self.catalog[key]
        tcols = target.column_names
        # explicit column list: values arrive in that order; unlisted
        # columns are filled with NULL
        order = list(stmt.columns) if stmt.columns is not None else tcols
        unknown = [c for c in order if c not in tcols]
        if unknown:
            raise PlanError(f"INSERT column(s) not in '{stmt.name}': {unknown}")
        if len(set(order)) != len(order):
            raise PlanError("duplicate column in INSERT column list")
        if stmt.select is not None:
            new = self._run_query(stmt.select)
            if len(new.column_names) != len(order):
                raise PlanError(
                    f"INSERT expects {len(order)} columns from SELECT, "
                    f"got {len(new.column_names)}"
                )
            by_name = {
                dest: new.arrow.column(i) for i, dest in enumerate(order)
            }
            nrows = new.num_rows
        else:
            for i, row in enumerate(stmt.rows):
                if len(row) != len(order):
                    raise PlanError(
                        f"INSERT row {i + 1} has {len(row)} values, "
                        f"expected {len(order)}"
                    )
            cols = list(zip(*stmt.rows)) if stmt.rows else [[] for _ in order]
            by_name = {dest: list(vals) for dest, vals in zip(order, cols)}
            nrows = len(stmt.rows)
        arrays = []
        for name in tcols:
            field = target.arrow.schema.field(name)
            if name in by_name:
                try:
                    arrays.append(pa.array(by_name[name], type=field.type)
                                  if not isinstance(by_name[name], (pa.Array, pa.ChunkedArray))
                                  else by_name[name].cast(field.type))
                except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError) as e:
                    raise PlanError(
                        f"INSERT value type mismatch for column '{name}': {e}"
                    ) from e
            else:
                arrays.append(pa.nulls(nrows, type=field.type))
        new_t = pa.table(dict(zip(tcols, arrays)), schema=target.arrow.schema)
        self.catalog[key] = Table(pa.concat_tables([target.arrow, new_t]))

    def show(self, text: str) -> str:
        res = self.sql(text)
        return pretty_format(res) if res is not None else ""

    def _execute_statement(self, stmt: ast.Statement) -> Table | None:
        if isinstance(stmt, ast.SetStmt):
            self._handle_set(stmt)
            return None
        if isinstance(stmt, ast.Prepare):
            self.prepared[stmt.name] = stmt
            return None
        if isinstance(stmt, ast.ExecuteStmt):
            prep = self.prepared.get(stmt.name)
            if prep is None:
                raise PlanError(f"prepared statement '{stmt.name}' not found")
            expected = (
                len(prep.types) if prep.types
                else ast.max_param_index(prep.stmt)
            )
            if len(stmt.values) != expected:
                raise PlanError(
                    f"prepared statement '{stmt.name}' expects "
                    f"{expected} parameters, got {len(stmt.values)}"
                )
            return self._execute_statement(
                ast.substitute_params(prep.stmt, stmt.values)
            )
        if isinstance(stmt, ast.Deallocate):
            if stmt.name not in self.prepared:
                raise PlanError(f"prepared statement '{stmt.name}' not found")
            del self.prepared[stmt.name]
            return None
        if isinstance(stmt, ast.CreateExternalTable):
            if stmt.if_not_exists and stmt.name.lower() in self.catalog:
                return None
            schema = (
                pa.schema([pa.field(c.name, _SQL_TYPES.get(c.type_name, pa.string()))
                           for c in stmt.columns])
                if stmt.columns
                else None
            )
            options = dict(stmt.options)
            kwargs = {}
            if stmt.fmt == "csv":
                kwargs["has_header"] = options.get("has_header", "true").lower() == "true"
                kwargs["delimiter"] = options.get("delimiter", ",")
                if stmt.columns:
                    kwargs["column_names"] = [c.name for c in stmt.columns]
                    kwargs["schema"] = schema
                if not kwargs["has_header"] and not stmt.columns:
                    pass
            t = read_table(stmt.location, stmt.fmt, **kwargs)
            self.catalog[stmt.name.lower()] = t
            return None
        if isinstance(stmt, ast.CreateTableValues):
            if stmt.if_not_exists and stmt.name.lower() in self.catalog:
                return None
            self.catalog[stmt.name.lower()] = self._values_table(stmt)
            return None
        if isinstance(stmt, ast.CreateTableAsSelect):
            if stmt.if_not_exists and stmt.name.lower() in self.catalog:
                return None
            self.catalog[stmt.name.lower()] = self._run_query(stmt.select)
            return None
        if isinstance(stmt, ast.CreateView):
            key = stmt.name.lower()
            if not stmt.or_replace and (key in self.views or key in self.catalog):
                raise PlanError(f"'{stmt.name}' already exists")
            # bind now to surface errors early (result is discarded)
            self._validate_query(stmt.select)
            self.views[key] = stmt.select
            return None
        if isinstance(stmt, ast.InsertInto):
            self._insert_into(stmt)
            return None
        if isinstance(stmt, ast.Describe):
            key = stmt.name.lower()
            if key in self.views:
                view = self.views[key]
                while isinstance(view, ast.Union):
                    view = view.selects[0]  # set-op output schema = first branch
                plan = self.create_physical_plan(view)
                names = [n for _, n in plan.schema()]
                return Table(pa.table({
                    "column_name": names,
                    "data_type": ["?"] * len(names),
                    "is_nullable": ["YES"] * len(names),
                }))
            if key not in self.catalog:
                raise PlanError(f"table '{stmt.name}' not found")
            sch = self.catalog[key].arrow.schema
            return Table(pa.table({
                "column_name": [f.name for f in sch],
                "data_type": [str(f.type) for f in sch],
                "is_nullable": ["YES" if f.nullable else "NO" for f in sch],
            }))
        if isinstance(stmt, ast.DropTable):
            key = stmt.name.lower()
            if stmt.view:
                if key not in self.views and not stmt.if_exists:
                    raise PlanError(f"view '{stmt.name}' not found")
                self.views.pop(key, None)
                return None
            if key not in self.catalog and not stmt.if_exists:
                raise PlanError(f"table '{stmt.name}' not found")
            self.catalog.pop(key, None)
            return None
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, (ast.Select, ast.Union, ast.With)):
            return self._run_query(stmt)
        if isinstance(stmt, ast.CopyTo):
            # streamed sink: batches flow straight into the incremental
            # writer, so COPY of a full-genome join result holds at most
            # one output batch in memory at a time
            from sequila_tpu_torch.io.readers import write_table_batches

            if isinstance(stmt.source, str):
                src = self.table(stmt.source)
                step = 4 * self.config.max_output_batch_size
                batches = (
                    src.slice(lo, step)
                    for lo in range(0, max(src.num_rows, 1), step)
                )
            else:
                batches = self._statement_batches(stmt.source)
            count = write_table_batches(batches, stmt.path, fmt=stmt.fmt)
            return Table(pa.table({"count": [count]}))
        if isinstance(stmt, ast.ShowTables):
            names = sorted(self.catalog)
            return Table(pa.table({"table_name": names}))
        if isinstance(stmt, ast.ShowColumns):
            return self._execute_statement(ast.Describe(stmt.name))
        if isinstance(stmt, ast.ShowConfig):
            return self._show_config(stmt.key)
        raise PlanError(f"unsupported statement: {stmt}")

    def _info_schema(self, key: str) -> Table | None:
        """information_schema virtual tables (DataFusion enables these in
        datafusion-cli: tables/columns/views/df_settings/schemata).
        Snapshots are built per query against the live catalog."""
        name = key.split(".", 1)[1]
        if name == "tables":
            rows = [(t, "BASE TABLE") for t in sorted(self.catalog)] + [
                (v, "VIEW") for v in sorted(self.views)
            ]
            return Table(
                pa.table(
                    {
                        "table_catalog": ["datafusion"] * len(rows),
                        "table_schema": ["public"] * len(rows),
                        "table_name": [r[0] for r in rows],
                        "table_type": [r[1] for r in rows],
                    }
                )
            )
        if name == "columns":
            cats, scms, tabs, cols, ords, nulls, types = (
                [], [], [], [], [], [], []
            )
            for tname in sorted(self.catalog):
                sch = self.catalog[tname].arrow.schema
                for i, f in enumerate(sch):
                    cats.append("datafusion")
                    scms.append("public")
                    tabs.append(tname)
                    cols.append(f.name)
                    ords.append(i + 1)
                    nulls.append("YES" if f.nullable else "NO")
                    types.append(str(f.type))
            # views contribute their bound output columns too (types are
            # unknown without execution -> NULL data_type)
            for vname in sorted(self.views):
                view = self.views[vname]
                try:
                    sel = view
                    while isinstance(sel, ast.Union):
                        sel = sel.selects[0]
                    schema = Binder(
                        self.catalog, runner=self._run_query,
                        views=self.views, view_guard=self._view_guard,
                        info_schema=self._info_schema, device=self.device,
                    ).bind_select(sel).schema()
                except Exception:
                    continue  # unbindable right now: skip, don't fail
                for i, (_, cname) in enumerate(schema):
                    cats.append("datafusion")
                    scms.append("public")
                    tabs.append(vname)
                    cols.append(cname)
                    ords.append(i + 1)
                    nulls.append("YES")
                    types.append(None)
            return Table(
                pa.table(
                    {
                        "table_catalog": cats,
                        "table_schema": scms,
                        "table_name": tabs,
                        "column_name": cols,
                        "ordinal_position": pa.array(ords, pa.int64()),
                        "is_nullable": nulls,
                        "data_type": types,
                    }
                )
            )
        if name == "views":
            vnames = sorted(self.views)
            return Table(
                pa.table(
                    {
                        "table_catalog": ["datafusion"] * len(vnames),
                        "table_schema": ["public"] * len(vnames),
                        "table_name": vnames,
                        "definition": [None] * len(vnames),
                    }
                )
            )
        if name == "df_settings":
            t = self._show_config(None)
            return t
        if name == "schemata":
            return Table(
                pa.table(
                    {
                        "catalog_name": ["datafusion"],
                        "schema_name": ["public"],
                    }
                )
            )
        return None

    def _show_config(self, key: str | None) -> Table:
        """SHOW ALL / SHOW <var> — name/value rows like DataFusion's
        information_schema-backed SHOW."""
        cfg = self.config
        pairs = {
            "sequila.prefer_interval_join": cfg.prefer_interval_join,
            "sequila.interval_join_algorithm": str(
                cfg.interval_join_algorithm
            ),
            "sequila.interval_join_low_memory": cfg.interval_join_low_memory,
            "sequila.partitioned_skew": cfg.partitioned_skew,
            "sequila.max_output_batch_size": cfg.max_output_batch_size,
            "datafusion.execution.target_partitions": cfg.target_partitions,
            "datafusion.execution.batch_size": cfg.batch_size,
        }
        for k, v in self.datafusion_options.items():
            pairs.setdefault(k, v)
        if key is not None:
            kl = key.lower()
            if kl in pairs:
                pairs = {kl: pairs[kl]}
            else:  # suffix match: SHOW target_partitions
                cands = {
                    k: v for k, v in pairs.items() if k.endswith("." + kl)
                }
                if not cands:
                    raise PlanError(f"unknown configuration option: {key}")
                pairs = cands
        names = sorted(pairs)
        return Table(
            pa.table(
                {
                    "name": names,
                    "value": [
                        str(pairs[n]).lower()
                        if isinstance(pairs[n], bool)
                        else str(pairs[n])
                        for n in names
                    ],
                }
            )
        )

    def _handle_set(self, stmt: ast.SetStmt) -> None:
        key = stmt.key.lower()
        if key.startswith("sequila."):
            self.config.set(key[len("sequila."):], stmt.value)
        elif key.startswith("datafusion."):
            # Accept the reference's recommended pragmas; map where analogous.
            self.datafusion_options[key] = stmt.value
            short = key.rsplit(".", 1)[-1]
            if short == "target_partitions":
                self.config.target_partitions = int(stmt.value)
            elif short == "batch_size":
                self.config.batch_size = int(stmt.value)
        else:
            raise PlanError(f"unknown SET key: {stmt.key}")

    def _values_table(self, stmt: ast.CreateTableValues) -> Table:
        ncols = len(stmt.columns) if stmt.columns else (len(stmt.rows[0]) if stmt.rows else 0)
        for i, row in enumerate(stmt.rows):
            if len(row) != ncols:
                raise PlanError(
                    f"VALUES row {i + 1} has {len(row)} values, expected {ncols}"
                )
        names = (
            [c.name for c in stmt.columns]
            if stmt.columns
            else [f"column{i+1}" for i in range(ncols)]
        )
        arrays = []
        for i in range(ncols):
            vals = [r[i] for r in stmt.rows]
            typ = (
                _SQL_TYPES.get(stmt.columns[i].type_name)
                if stmt.columns
                else None
            )
            arrays.append(pa.array(vals, type=typ))
        return Table(pa.Table.from_arrays(arrays, names=names))

    # -- planning + execution ----------------------------------------------
    def create_physical_plan(self, sel: ast.Select):
        """The optimized physical plan of ``sel``, recorded as the span
        ``session.plan`` (a genomic table function runs its verb here)."""
        with span("session.plan"):
            plan = Binder(
                self.catalog, runner=self._run_query, views=self.views,
                view_guard=self._view_guard, info_schema=self._info_schema, device=self.device,
            ).bind_select(sel)
            plan = PredicatePushdownRule().optimize(plan)
            plan = IntervalJoinRule(self.config, self.device).optimize(plan)
            plan = ProjectionPushdownRule().optimize(plan)
            return CountFastPathRule().optimize(plan)

    def plan_sql(self, text: str):
        """Parse a single SELECT and return its optimized physical plan."""
        stmts = parse_sql(text)
        sel = stmts[-1]
        if isinstance(sel, ast.Explain):
            sel = sel.stmt
        if not isinstance(sel, ast.Select):
            raise PlanError("plan_sql expects a SELECT")
        return self.create_physical_plan(sel)

    def _run_select(self, sel: ast.Select) -> Table:
        """Plan and execute ``sel``; the counters of both (the verbs'
        routes, the kernels' launches) go to the query's metrics."""
        ctx = ExecContext(self.config.copy())
        with collecting(ctx.metrics):
            plan = self.create_physical_plan(sel)
            profile_dir = os.environ.get("SEQUILA_PROFILE")
            if profile_dir:
                out = self._profiled(plan, ctx, profile_dir)
            else:
                out = plan.execute(ctx)
        self.last_metrics = ctx.metrics
        return out

    def _profiled(self, plan, ctx, profile_dir: str) -> Table:
        """Execute under torch.profiler (the reference's flamegraph/RUST_LOG
        analog): one Chrome trace per query, for chrome://tracing or
        Perfetto, holding the host's operators, the card's kernels and
        copies, and the program's spans and counters (category
        ``program``)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        lo = time.time_ns()
        with profile(activities=acts) as prof:
            out = plan.execute(ctx)
        hi = time.time_ns()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_{os.getpid()}_{id(plan):x}.json")
        prof.export_chrome_trace(path)
        merge_into_chrome_trace(path, lo, hi)
        return out

    def _run_union(self, u: ast.Union) -> Table:
        parts = [
            self._run_select(s) if isinstance(s, ast.Select) else self._run_union(s)
            for s in u.selects
        ]
        arity = len(parts[0].column_names)
        names = parts[0].column_names
        out = parts[0]
        # left-associative: (A UNION B) UNION ALL C keeps C's duplicates
        for nxt, op in zip(parts[1:], u.ops):
            if op.endswith(" by name"):
                # UNION [ALL] BY NAME: align columns by name; names unique
                # to one side become NULL on the other (DataFusion)
                names = list(out.column_names)
                names += [n for n in nxt.column_names if n not in names]
                out = _align_by_name(out, names)
                nxt = _align_by_name(nxt, names)
                arity = len(names)
                out = _set_op(out, nxt, op[:-8], names)
                continue
            if len(nxt.column_names) != arity:
                raise PlanError(
                    "set operation inputs must have the same column count"
                )
            out = _set_op(out, nxt, op, names)
        if u.order_by:
            from sequila_tpu_torch.exec.plan import ScanExec, SortExec
            from sequila_tpu_torch.planner.binder import Binder

            scan = ScanExec("__union__", out, None)
            b = Binder(
                self.catalog, runner=self._run_query, views=self.views,
                view_guard=self._view_guard, info_schema=self._info_schema, device=self.device,
            )
            schema = scan.schema()
            exprs, asc, nfs = [], [], []
            for oi in u.order_by:
                k = Binder._ordinal(oi.expr)
                if k is not None:  # ORDER BY 1-based output position
                    if not 1 <= k <= len(schema):
                        raise PlanError(
                            f"ORDER BY position {k} is not in the select list"
                        )
                    from sequila_tpu_torch.planner import expr as pe

                    exprs.append(pe.Column(schema[k - 1][1], k - 1))
                else:
                    exprs.append(b._bind_expr(oi.expr, schema).expr)
                asc.append(oi.asc)
                nfs.append(oi.nulls_first)
            out = SortExec(scan, exprs, asc, nfs).execute(
                ExecContext(self.config.copy())
            )
        if u.offset:
            out = out.slice(u.offset, None)
        if u.limit is not None:
            out = out.slice(0, u.limit)
        return out

    def _explain(self, stmt: ast.Explain) -> Table:
        target = stmt.stmt
        if isinstance(target, ast.With):
            with self._cte_scope(target.ctes, recursive=target.recursive):
                return self._explain(ast.Explain(target.body, stmt.analyze))
        if isinstance(target, ast.Union):
            text = self._explain_set_op(target, analyze=stmt.analyze)
            kind = "Plan with Metrics" if stmt.analyze else "physical_plan"
            return Table(pa.table({"plan_type": [kind], "plan": [text]}))
        ctx = ExecContext(self.config.copy(), collect_metrics=True)
        with collecting(ctx.metrics):
            plan = self.create_physical_plan(stmt.stmt)
            if stmt.analyze:
                plan.execute(ctx)
        show_stats = self._show_statistics()
        if stmt.analyze:
            text = _explain_analyzed(plan, ctx.metrics, show_stats)
            return Table(
                pa.table({"plan_type": ["Plan with Metrics"], "plan": [text]})
            )
        text = plan.explain(show_stats=show_stats)
        return Table(pa.table({"plan_type": ["physical_plan"], "plan": [text]}))

    def _show_statistics(self) -> bool:
        """DataFusion's `datafusion.explain.show_statistics` knob: EXPLAIN
        lines gain `statistics=[Rows=..., Bytes=...]` when set."""
        return (
            self.datafusion_options.get(
                "datafusion.explain.show_statistics", "false"
            ).lower()
            == "true"
        )

    def _explain_set_op(self, u: ast.Union, analyze: bool, indent: str = "") -> str:
        """Textual plan of a set-operation chain: a SetOpExec header with
        each branch's physical plan indented beneath it."""
        ops = ", ".join(u.ops)
        lines = [f"{indent}SetOpExec: ops=[{ops}]"]
        for s in u.selects:
            if isinstance(s, ast.Union):
                lines.append(self._explain_set_op(s, analyze, indent + "  "))
                continue
            ctx = ExecContext(self.config.copy(), collect_metrics=True)
            with collecting(ctx.metrics):
                plan = self.create_physical_plan(s)
                if analyze:
                    plan.execute(ctx)
            if analyze:
                text = _explain_analyzed(plan, ctx.metrics, self._show_statistics())
            else:
                text = plan.explain(show_stats=self._show_statistics())
            lines.append(
                "\n".join(indent + "  " + ln for ln in text.splitlines())
            )
        return "\n".join(lines)


def _explain_analyzed(plan, metrics, show_stats: bool) -> str:
    """EXPLAIN ANALYZE's text: the plan with each operator's metrics, then
    the counters no operator owns (kernel launches, verb routes, bytes
    copied), where there are any."""
    text = plan.explain(metrics=metrics, show_stats=show_stats)
    program = metrics.format_op(PROGRAM)
    return f"{text}\nProgram: metrics=[{program}]" if program else text


def _align_by_name(t: Table, names: list) -> Table:
    """Project t onto the given column-name list; absent columns are
    all-NULL (UNION BY NAME alignment)."""
    cols = []
    for n in names:
        if n in t.column_names:
            cols.append(t.arrow.column(n))
        else:
            cols.append(pa.nulls(t.num_rows))
    return Table(pa.Table.from_arrays(cols, names=list(names)))


def _set_op(a: Table, b: Table, op: str, names) -> Table:
    """One SQL set-operation step (DataFusion/standard semantics).

    Rows compare with NULLs equal (grouping semantics, like GROUP BY and
    IS NOT DISTINCT FROM) and types coerce permissively, as in UNION.
    Multiplicities: UNION ALL concatenates; UNION dedups; INTERSECT [ALL]
    keeps min(count_a, count_b) (1 row without ALL); EXCEPT [ALL] keeps
    max(count_a - count_b, 0) (at most 1 without ALL).  Output rows come
    from the LEFT input in its original order."""
    from sequila_tpu_torch.exec.plan import _row_group_codes

    from sequila_tpu_torch.models.table import concat_tables_unify

    combined = Table(
        concat_tables_unify(
            [a.arrow.rename_columns(names), b.arrow.rename_columns(names)]
        )
    )
    if op == "union all":
        return combined
    cols = [combined.column_np(i) for i in range(len(names))]
    if not cols:
        return combined
    codes, first_idx = _row_group_codes(cols)
    if op == "union":
        return combined.take(np.sort(first_idx))
    na = a.num_rows
    codes_a, codes_b = codes[:na], codes[na:]
    ngroups = int(codes.max()) + 1 if len(codes) else 0
    ca = np.bincount(codes_a, minlength=ngroups)
    cb = np.bincount(codes_b, minlength=ngroups)
    if op == "intersect":
        allowed = np.minimum(np.minimum(ca, cb), 1)
    elif op == "intersect all":
        allowed = np.minimum(ca, cb)
    elif op == "except":
        allowed = np.where(cb > 0, 0, np.minimum(ca, 1))
    elif op == "except all":
        allowed = np.maximum(ca - cb, 0)
    else:
        raise PlanError(f"unknown set operation '{op}'")
    if na == 0 or ngroups == 0:
        return Table(combined.arrow.slice(0, na))
    # per-left-row rank within its group (original row order)
    order = np.argsort(codes_a, kind="stable")
    grp_start = np.concatenate(
        [[0], np.cumsum(np.bincount(codes_a, minlength=ngroups))]
    )[:-1]
    ranks = np.empty(na, np.int64)
    ranks[order] = np.arange(na) - grp_start[codes_a[order]]
    keep = np.nonzero(ranks < allowed[codes_a])[0]
    return Table(combined.arrow.slice(0, na)).take(keep)


def connect(config: SequilaConfig | None = None, device="cuda") -> SessionContext:
    return SessionContext(config, device)
