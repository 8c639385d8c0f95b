"""SQL abstract syntax tree for the engine's dialect subset."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


# -- expressions ------------------------------------------------------------


class SqlExpr:
    pass


@dataclasses.dataclass(frozen=True)
class ColRef(SqlExpr):
    qualifier: Optional[str]
    name: str

    def display(self):
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


@dataclasses.dataclass(frozen=True)
class Lit(SqlExpr):
    value: Any


@dataclasses.dataclass(frozen=True)
class Interval(SqlExpr):
    """INTERVAL '<value>' [unit] literal (day/time units)."""

    value: str
    unit: str | None = None


@dataclasses.dataclass(frozen=True)
class Binary(SqlExpr):
    left: SqlExpr
    op: str  # + - * / % = != < <= > >= AND OR
    right: SqlExpr


@dataclasses.dataclass(frozen=True)
class Unary(SqlExpr):
    op: str  # NOT | -
    child: SqlExpr


@dataclasses.dataclass(frozen=True)
class Func(SqlExpr):
    name: str  # lowercased
    args: tuple[SqlExpr, ...]
    distinct: bool = False
    star: bool = False  # count(*)
    filter_where: Optional[SqlExpr] = None  # agg(x) FILTER (WHERE ...)
    order_by: tuple = ()  # array_agg(x ORDER BY y): OrderItem tuple


@dataclasses.dataclass(frozen=True)
class GroupingSets(SqlExpr):
    """GROUP BY GROUPING SETS ((a, b), (a), ()) — appears only inside a
    Select's group_by list (ROLLUP/CUBE parse as Func and are expanded
    by the binder)."""

    sets: tuple  # tuple[tuple[SqlExpr, ...], ...]


@dataclasses.dataclass(frozen=True)
class Star(SqlExpr):
    qualifier: Optional[str] = None
    exclude: tuple = ()  # SELECT * EXCLUDE/EXCEPT (cols) — DataFusion


@dataclasses.dataclass(frozen=True)
class Cast(SqlExpr):
    child: SqlExpr
    type_name: str


@dataclasses.dataclass(frozen=True)
class InList(SqlExpr):
    child: SqlExpr
    items: tuple[SqlExpr, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(SqlExpr):
    child: SqlExpr
    select: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Exists(SqlExpr):
    select: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(SqlExpr):
    select: "Select"


@dataclasses.dataclass(frozen=True)
class Case(SqlExpr):
    """CASE [operand] WHEN c THEN v .. [ELSE e] END (operand form is
    desugared to equality conditions at parse time)."""

    whens: tuple  # ((cond, result), ...)
    else_: Optional[SqlExpr] = None


@dataclasses.dataclass(frozen=True)
class Like(SqlExpr):
    child: SqlExpr
    pattern: SqlExpr
    negated: bool = False
    case_insensitive: bool = False  # ILIKE


@dataclasses.dataclass(frozen=True)
class WindowFunc(SqlExpr):
    func: "Func"
    partition_by: tuple = ()
    order_by: tuple = ()  # OrderItem
    # ROWS/RANGE BETWEEN frame as (lo, hi) offsets relative to the
    # current row (rows) or its ORDER BY value (range); None side =
    # unbounded; -k = k PRECEDING, +k = k FOLLOWING
    frame: Optional[tuple] = None
    frame_kind: str = "rows"
    ref: Optional[str] = None  # OVER w — resolved via the WINDOW clause


@dataclasses.dataclass(frozen=True)
class DistinctFrom(SqlExpr):
    left: SqlExpr
    right: SqlExpr
    negated: bool = False  # True = IS NOT DISTINCT FROM


# -- select -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: SqlExpr
    alias: Optional[str]


@dataclasses.dataclass(frozen=True)
class Values:
    """VALUES (...), (...) used as a table expression; column names
    default to column1..columnN (DataFusion's convention) unless the
    table alias carries a column list."""

    rows: tuple  # tuple[tuple[literal, ...], ...]


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str]
    # derived table: FROM (SELECT ...) alias — a Select, Union or Values;
    # when set, ``name`` is the placeholder "__derived__"
    subquery: Optional[object] = None
    col_aliases: Optional[tuple] = None  # alias(c1, c2, ...) renames
    # table function: FROM generate_series(1, 10) t — (fname, arg exprs)
    table_func: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class With:
    """WITH [RECURSIVE] name [(cols)] AS (query), ... <body>.

    Each cte query may reference earlier CTEs; under RECURSIVE a cte
    whose body is <base> UNION [ALL] <step> may reference itself in the
    final step term (Postgres/DataFusion iteration-to-fixpoint
    semantics; the reference operator's reset_state exists for exactly
    this re-execution, interval_join.rs:559-575).  The body is a Select
    or Union."""

    ctes: tuple  # tuple[(name, cols | None, Select | Union), ...]
    body: object  # Select | Union
    recursive: bool = False


@dataclasses.dataclass(frozen=True)
class JoinClause:
    table: TableRef
    on: Optional[SqlExpr]
    join_type: str = "inner"  # inner | left | right | full | cross
    using: tuple = ()  # JOIN ... USING (c1, ...): shared equi-columns
    natural: bool = False  # NATURAL JOIN: USING(all shared names)


@dataclasses.dataclass(frozen=True)
class GroupByAll(SqlExpr):
    """GROUP BY ALL — every non-aggregate select item becomes a key."""


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: SqlExpr
    asc: bool = True
    nulls_first: Optional[bool] = None  # None = dialect default (LAST)


@dataclasses.dataclass(frozen=True)
class Select:
    items: tuple[SelectItem, ...]
    from_tables: tuple[TableRef, ...]  # comma-list (implicit cross join)
    joins: tuple[JoinClause, ...]
    where: Optional[SqlExpr]
    group_by: tuple[SqlExpr, ...]
    order_by: tuple[OrderItem, ...]
    limit: Optional[int]
    distinct: bool = False
    having: Optional[SqlExpr] = None
    offset: int = 0
    # WINDOW w AS (PARTITION BY ... ORDER BY ...): name -> WindowFunc
    # template (func=None); OVER w references resolve against it
    windows: tuple = ()
    # SELECT DISTINCT ON (exprs): keep the first row per key under the
    # query's ORDER BY (Postgres/DataFusion)
    distinct_on: tuple = ()


@dataclasses.dataclass(frozen=True)
class Union:
    """Set-operation chain; ``ops[i]`` ∈ {union, union all, intersect,
    intersect all, except, except all} joins selects[i] and selects[i+1]
    (left-associative).  INTERSECT binds tighter than UNION/EXCEPT
    (standard SQL, as in DataFusion), so an element of ``selects`` may
    itself be a Union holding an intersect chain.  Trailing ORDER BY /
    LIMIT of the chain apply to the whole result."""

    selects: tuple  # tuple[Select | Union, ...]
    ops: tuple  # tuple[str, ...], len == len(selects) - 1
    order_by: tuple = ()
    limit: Optional[int] = None
    offset: int = 0


# -- statements -------------------------------------------------------------


class Statement:
    pass


@dataclasses.dataclass(frozen=True)
class SetStmt(Statement):
    key: str  # e.g. "sequila.interval_join_algorithm"
    value: str


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str
    not_null: bool = False


@dataclasses.dataclass(frozen=True)
class CreateExternalTable(Statement):
    name: str
    columns: tuple[ColumnDef, ...]  # may be empty (schema inference)
    fmt: str  # csv | parquet | bed
    location: str
    options: dict[str, str]
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTableValues(Statement):
    name: str
    columns: tuple[ColumnDef, ...]
    rows: tuple[tuple[Any, ...], ...]
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTableAsSelect(Statement):
    name: str
    select: Select
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateView(Statement):
    name: str
    select: Select
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class InsertInto(Statement):
    """INSERT INTO t [(cols)] VALUES (..), .. | INSERT INTO t [(cols)] SELECT .."""

    name: str
    rows: tuple = ()  # literal rows, or empty when select is set
    select: Optional[Select] = None
    columns: Optional[tuple] = None  # explicit target column order


@dataclasses.dataclass(frozen=True)
class Describe(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class DropTable(Statement):
    name: str
    if_exists: bool
    view: bool = False


@dataclasses.dataclass(frozen=True)
class Explain(Statement):
    stmt: Select
    analyze: bool = False


@dataclasses.dataclass(frozen=True)
class ShowTables(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class ShowColumns(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class ShowConfig(Statement):
    """SHOW ALL (key None) or SHOW <dotted config var>."""

    key: str | None = None


@dataclasses.dataclass(frozen=True)
class CopyTo(Statement):
    """COPY <table | (select)> TO 'path' [STORED AS fmt] — format from
    the STORED AS override or the path extension."""

    source: object  # str table name or Select
    path: str
    fmt: str | None = None


@dataclasses.dataclass(frozen=True)
class Param(SqlExpr):
    """$n placeholder — substituted by EXECUTE (DataFusion PREPARE)."""

    index: int  # 1-based


@dataclasses.dataclass(frozen=True)
class Prepare(Statement):
    name: str
    types: tuple  # declared parameter type names (informational)
    stmt: object  # the prepared Statement/Select AST


@dataclasses.dataclass(frozen=True)
class ExecuteStmt(Statement):
    name: str
    values: tuple  # literal argument values


@dataclasses.dataclass(frozen=True)
class Deallocate(Statement):
    name: str


def substitute_params(node, values: tuple):
    """Replace every Param($n) in a statement tree with Lit(values[n-1]).

    Generic frozen-dataclass walker: the whole AST is dataclasses, tuples
    and scalars, so EXECUTE needs no per-node code (DataFusion does the
    equivalent substitution on the logical plan)."""
    if isinstance(node, Param):
        if not 1 <= node.index <= len(values):
            from sequila_tpu_torch.errors import PlanError

            raise PlanError(
                f"no value for parameter ${node.index} "
                f"({len(values)} supplied)"
            )
        return Lit(values[node.index - 1])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = substitute_params(v, values)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, tuple):
        out = tuple(substitute_params(x, values) for x in node)
        return out if any(a is not b for a, b in zip(out, node)) else node
    if isinstance(node, list):
        return [substitute_params(x, values) for x in node]
    return node


def max_param_index(node) -> int:
    """Highest $n placeholder index in a statement tree (0 = none)."""
    if isinstance(node, Param):
        return node.index
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return max(
            (
                max_param_index(getattr(node, f.name))
                for f in dataclasses.fields(node)
            ),
            default=0,
        )
    if isinstance(node, (tuple, list)):
        return max((max_param_index(x) for x in node), default=0)
    return 0
