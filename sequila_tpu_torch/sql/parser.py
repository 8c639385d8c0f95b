"""Recursive-descent SQL parser for the engine's dialect subset.

Covers the reference's entire SQL surface (reference queries/*.sql,
tests/integration_test.rs, sequila-cli): SET, CREATE (EXTERNAL) TABLE with
STORED AS / LOCATION / OPTIONS, CREATE TABLE ... AS VALUES / AS SELECT,
DROP TABLE, EXPLAIN [ANALYZE], and SELECT with joins (explicit JOIN ... ON
and implicit comma-cross-join + WHERE), aggregates, GROUP BY, ORDER BY,
LIMIT.
"""

from __future__ import annotations

from sequila_tpu_torch.errors import PlanError
from sequila_tpu_torch.sql import ast
from sequila_tpu_torch.sql.lexer import Token, tokenize

_KEYWORDS_STOP = {
    "FROM", "WHERE", "GROUP", "ORDER", "LIMIT", "OFFSET", "JOIN", "INNER", "LEFT",
    "RIGHT", "FULL", "CROSS", "ON", "AS", "AND", "OR", "NOT", "BY", "ASC",
    "DESC", "UNION", "INTERSECT", "EXCEPT", "HAVING", "USING", "NATURAL",
    "WINDOW",
}


def _similar_to_regex(p: str) -> str:
    """SQL SIMILAR TO pattern -> anchored Python regex: % -> .*, _ -> .,
    the standard's regex operators pass through, everything else is
    literal (notably '.'); backslash escapes the next character.  Inside
    a bracket expression [...] characters keep their regex meaning
    ('-' ranges, leading '^' negation) and %/_ are literal members."""
    import re as _re

    out = []
    i = 0
    in_brackets = False
    while i < len(p):
        c = p[i]
        if c == "\\" and i + 1 < len(p):
            out.append(_re.escape(p[i + 1]))
            i += 2
            continue
        if in_brackets:
            # ']' as the first member is literal (SQL/POSIX rule)
            if c == "]" and out[-1] not in ("[", "[^"):
                in_brackets = False
                out.append(c)
            elif c == "^" and out[-1] == "[":
                out[-1] = "[^"
            else:
                out.append(c)
        elif c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif c == "[":
            in_brackets = True
            out.append(c)
        elif c in "|*+?(){}]":
            out.append(c)
        else:
            out.append(_re.escape(c))
        i += 1
    if in_brackets:
        raise PlanError("SIMILAR TO: unterminated bracket expression")
    return "^(?:" + "".join(out) + ")$"


def _fold_const_int(e):
    """Fold a literal integer arithmetic expression; None when not one."""
    if isinstance(e, ast.Lit) and isinstance(e.value, (int, float)) and not isinstance(e.value, bool):
        return int(e.value) if float(e.value).is_integer() else None
    if isinstance(e, ast.Unary) and e.op == "-":
        v = _fold_const_int(e.child)
        return None if v is None else -v
    if isinstance(e, ast.Binary):
        lv, rv = _fold_const_int(e.left), _fold_const_int(e.right)
        if lv is None or rv is None:
            return None
        if e.op == "+":
            return lv + rv
        if e.op == "-":
            return lv - rv
        if e.op == "*":
            return lv * rv
        if e.op == "/" and rv != 0 and lv % rv == 0:
            return lv // rv
    return None


def _strip_trailing(node):
    """Pull trailing ORDER BY / LIMIT / OFFSET off the right-most branch
    of a set-operation chain: parse_select consumes them into the LAST
    Select, but standard SQL applies them to the whole chain.  Returns
    (node without the clauses, order_by, limit, offset)."""
    import dataclasses as _dc

    order_by, limit, offset = node.order_by, node.limit, node.offset
    stripped = _dc.replace(node, order_by=(), limit=None, offset=0)
    return stripped, order_by, limit, offset


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind == "eof":
            # every grammar production that consumes a token expects one;
            # returning the eof token forever would let unguarded
            # `while not eat(')')` loops spin on truncated input
            raise PlanError("unexpected end of input")
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise PlanError(f"expected {kw}, got {self.peek().value!r}")

    def at(self, kind: str, value: str | None = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value: str | None = None) -> bool:
        if self.at(kind, value):
            self.next()
            return True
        return False

    def expect(self, kind: str, value: str | None = None) -> Token:
        if not self.at(kind, value):
            raise PlanError(
                f"expected {value or kind}, got {self.peek().value!r}"
            )
        return self.next()

    # -- entry --------------------------------------------------------------
    def parse_statements(self) -> list[ast.Statement]:
        stmts = []
        while not self.at("eof"):
            if self.eat("punct", ";"):
                continue
            stmts.append(self.parse_statement())
            if not self.at("eof"):
                self.expect("punct", ";")
        return stmts

    def parse_statement(self) -> ast.Statement:
        if self.at_kw("SET"):
            return self.parse_set()
        if self.at_kw("CREATE"):
            return self.parse_create()
        if self.at_kw("DROP"):
            return self.parse_drop()
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = self.eat_kw("ANALYZE")
            self.eat_kw("VERBOSE")  # accepted; the plan display is single-level
            if self.eat_kw("FORMAT"):
                fmt = self.next().upper
                if fmt not in ("INDENT", "TREE"):
                    raise PlanError(f"unsupported EXPLAIN format: {fmt}")
            return ast.Explain(self.parse_query(), analyze)
        if self.at_kw("SELECT"):
            return self.parse_select_or_union()
        if self.at_kw("WITH"):
            return self.parse_query()
        if self.at_kw("INSERT"):
            self.next()
            self.expect_kw("INTO")
            name = self.parse_object_name()
            columns = None
            if self.at("punct", "("):
                columns = tuple(self.parse_column_names())
            if self.eat_kw("VALUES"):
                rows = []
                while True:
                    self.expect("punct", "(")
                    row = []
                    while not self.at("punct", ")"):
                        row.append(self.parse_literal_value())
                        self.eat("punct", ",")
                    self.expect("punct", ")")
                    rows.append(tuple(row))
                    if not self.eat("punct", ","):
                        break
                return ast.InsertInto(name, tuple(rows), columns=columns)
            if self.at_kw("SELECT"):
                return ast.InsertInto(
                    name, (), self.parse_select_or_union(), columns=columns
                )
            raise PlanError("expected VALUES or SELECT after INSERT INTO")
        if self.at_kw("DESCRIBE") or self.at_kw("DESC"):
            self.next()
            return ast.Describe(self.parse_object_name())
        if self.at_kw("SHOW"):
            self.next()
            if self.eat_kw("TABLES"):
                return ast.ShowTables()
            if self.at_kw("COLUMNS"):
                self.next()
                self.eat_kw("IN") or self.expect_kw("FROM")
                return ast.ShowColumns(self.parse_object_name())
            if self.eat_kw("ALL"):
                return ast.ShowConfig(None)
            key = self.next().value  # full dotted config key
            while self.eat("punct", "."):
                key += "." + self.next().value
            return ast.ShowConfig(key)
        if self.at_kw("COPY"):
            self.next()
            if self.eat("punct", "("):
                src = self.parse_select_or_union()
                self.expect("punct", ")")
            else:
                src = self.parse_object_name()
            self.expect_kw("TO")
            path = self.expect("string").value
            fmt = None
            if self.eat_kw("STORED"):
                self.expect_kw("AS")
                fmt = self.next().value.lower()
            return ast.CopyTo(src, path, fmt)
        if self.eat_kw("PREPARE"):
            name = self.next().value.lower()
            types: list[str] = []
            if self.at("punct", "("):  # optional declared parameter types
                self.next()
                while not self.eat("punct", ")"):
                    types.append(self.next().value.upper())
                    self.eat("punct", ",")
            self.expect_kw("AS")
            return ast.Prepare(name, tuple(types), self.parse_statement())
        if self.eat_kw("EXECUTE"):
            name = self.next().value.lower()
            values: list = []
            if self.at("punct", "("):
                self.next()
                while not self.eat("punct", ")"):
                    neg = self.eat("punct", "-")
                    v = self.parse_literal_value()
                    values.append(-v if neg else v)
                    self.eat("punct", ",")
            return ast.ExecuteStmt(name, tuple(values))
        if self.eat_kw("DEALLOCATE"):
            self.eat_kw("PREPARE")
            return ast.Deallocate(self.next().value.lower())
        raise PlanError(f"unsupported statement start: {self.peek().value!r}")

    # -- SET ----------------------------------------------------------------
    def parse_set(self) -> ast.SetStmt:
        self.expect_kw("SET")
        parts = [self.expect("ident").value]
        while self.eat("punct", "."):
            parts.append(self.expect("ident").value)
        key = ".".join(parts)
        if not (self.eat_kw("TO") or self.eat("op", "=")):
            raise PlanError("expected TO or = in SET")
        # value: a literal or bare identifier(s)
        t = self.next()
        if t.kind in ("string", "number", "ident", "qident"):
            return ast.SetStmt(key, t.value)
        raise PlanError(f"bad SET value: {t.value!r}")

    # -- CREATE -------------------------------------------------------------
    def _parse_const_int(self, what: str) -> int:
        """LIMIT/OFFSET operand: a constant integer expression
        (DataFusion folds LIMIT 1+1 the same way)."""
        v = _fold_const_int(self.parse_expr())
        if v is None or v < 0:
            raise PlanError(f"{what} must be a non-negative integer constant")
        return v

    def parse_column_names(self) -> list[str]:
        self.expect("punct", "(")
        out = []
        while not self.eat("punct", ")"):
            if self.at("eof"):
                raise PlanError("unterminated column list")
            tok = self.next()
            if tok.kind not in ("ident", "qident"):
                raise PlanError(f"expected column name, got {tok.value!r}")
            out.append(tok.value)
            self.eat("punct", ",")
        return out

    def parse_create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        or_replace = False
        if self.eat_kw("OR"):
            self.expect_kw("REPLACE")
            or_replace = True
        if self.eat_kw("VIEW"):
            name = self.parse_object_name()
            self.expect_kw("AS")
            return ast.CreateView(name, self.parse_select_or_union(), or_replace)
        external = self.eat_kw("EXTERNAL")
        self.expect_kw("TABLE")
        if_not_exists = False
        if self.eat_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.parse_object_name()
        columns: list[ast.ColumnDef] = []
        if self.at("punct", "("):
            columns = self.parse_column_defs()

        if external or self.at_kw("STORED") or self.at_kw("LOCATION"):
            fmt = "csv"
            if self.eat_kw("STORED"):
                self.expect_kw("AS")
                fmt = self.next().value.lower()
            self.expect_kw("LOCATION")
            location = self.expect("string").value
            options: dict[str, str] = {}
            if self.eat_kw("OPTIONS"):
                self.expect("punct", "(")
                while not self.eat("punct", ")"):
                    k = self.next().value
                    v = self.next().value
                    options[k.strip("'")] = v
                    self.eat("punct", ",")
            return ast.CreateExternalTable(
                name, tuple(columns), fmt, location, options, if_not_exists
            )

        if columns and not self.at_kw("AS"):
            # CREATE TABLE t (cols): an empty typed table (DataFusion)
            return ast.CreateTableValues(
                name, tuple(columns), (), if_not_exists
            )
        self.expect_kw("AS")
        if self.eat_kw("VALUES"):
            rows = []
            while True:
                self.expect("punct", "(")
                row = []
                while not self.eat("punct", ")"):
                    row.append(self.parse_literal_value())
                    self.eat("punct", ",")
                rows.append(tuple(row))
                if not self.eat("punct", ","):
                    break
            return ast.CreateTableValues(
                name, tuple(columns), tuple(rows), if_not_exists
            )
        if self.at_kw("SELECT"):
            return ast.CreateTableAsSelect(
                name, self.parse_select_or_union(), if_not_exists
            )
        raise PlanError("expected VALUES or SELECT after AS")

    def parse_column_defs(self) -> list[ast.ColumnDef]:
        self.expect("punct", "(")
        cols = []
        while not self.eat("punct", ")"):
            name = self.next().value
            type_name = self.next().value.upper()
            not_null = False
            if self.eat_kw("NOT"):
                self.expect_kw("NULL")
                not_null = True
            cols.append(ast.ColumnDef(name, type_name, not_null))
            self.eat("punct", ",")
        return cols

    def parse_literal_value(self):
        t = self.next()
        if t.kind == "string":
            return t.value
        if t.kind == "number":
            return float(t.value) if "." in t.value or "e" in t.value.lower() else int(t.value)
        if t.kind == "ident":
            if t.upper == "NULL":
                return None
            if t.upper == "TRUE":
                return True
            if t.upper == "FALSE":
                return False
        if t.kind == "punct" and t.value == "-":
            v = self.parse_literal_value()
            return -v
        raise PlanError(f"bad literal: {t.value!r}")

    def parse_object_name(self) -> str:
        parts = [self.next().value]
        while self.eat("punct", "."):
            parts.append(self.next().value)
        # information_schema virtual tables keep their qualifier; other
        # catalog/schema qualifiers resolve to the last path component
        if len(parts) >= 2 and parts[-2].lower() == "information_schema":
            return f"information_schema.{parts[-1]}"
        return parts[-1]

    # -- DROP ---------------------------------------------------------------
    def parse_drop(self) -> ast.DropTable:
        self.expect_kw("DROP")
        view = self.eat_kw("VIEW")
        if not view:
            self.expect_kw("TABLE")
        if_exists = False
        if self.eat_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return ast.DropTable(self.parse_object_name(), if_exists, view)

    # -- SELECT -------------------------------------------------------------
    def parse_select(self) -> ast.Select:
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        if not distinct:
            self.eat_kw("ALL")  # SELECT ALL — the explicit default
        distinct_on: list = []
        if distinct and self.eat_kw("ON"):
            # Postgres DISTINCT ON (exprs): first row per key
            self.expect("punct", "(")
            distinct_on.append(self.parse_expr())
            while self.eat("punct", ","):
                distinct_on.append(self.parse_expr())
            self.expect("punct", ")")
            distinct = False
        items = [self.parse_select_item()]
        while self.eat("punct", ","):
            items.append(self.parse_select_item())

        from_tables: list[ast.TableRef] = []
        joins: list[ast.JoinClause] = []
        if self.eat_kw("FROM"):
            from_tables.append(self.parse_table_ref())
            while True:
                if self.eat("punct", ","):
                    from_tables.append(self.parse_table_ref())
                    continue
                jt = None
                natural = self.eat_kw("NATURAL")
                if self.at_kw("JOIN"):
                    self.next()
                    jt = "inner"
                elif self.at_kw("INNER"):
                    self.next()
                    self.expect_kw("JOIN")
                    jt = "inner"
                elif self.at_kw("LEFT"):
                    self.next()
                    if self.eat_kw("SEMI"):
                        self.expect_kw("JOIN"); jt = "leftsemi"
                    elif self.eat_kw("ANTI"):
                        self.expect_kw("JOIN"); jt = "leftanti"
                    else:
                        self.eat_kw("OUTER"); self.expect_kw("JOIN"); jt = "left"
                elif self.at_kw("RIGHT"):
                    self.next()
                    if self.eat_kw("SEMI"):
                        self.expect_kw("JOIN"); jt = "rightsemi"
                    elif self.eat_kw("ANTI"):
                        self.expect_kw("JOIN"); jt = "rightanti"
                    else:
                        self.eat_kw("OUTER"); self.expect_kw("JOIN"); jt = "right"
                elif self.at_kw("FULL"):
                    self.next(); self.eat_kw("OUTER"); self.expect_kw("JOIN"); jt = "full"
                elif self.at_kw("CROSS"):
                    self.next(); self.expect_kw("JOIN"); jt = "cross"
                if jt is None:
                    if natural:
                        raise PlanError("NATURAL must precede a JOIN")
                    break
                if natural and jt == "cross":
                    raise PlanError("NATURAL CROSS JOIN is not valid")
                tref = self.parse_table_ref()
                on = None
                using: tuple = ()
                if jt != "cross" and not natural:
                    if self.eat_kw("USING"):
                        using = tuple(self.parse_column_names())
                        if not using:
                            raise PlanError("USING requires at least one column")
                    else:
                        self.expect_kw("ON")
                        on = self.parse_expr()
                joins.append(ast.JoinClause(tref, on, jt, using, natural))

        where = self.parse_expr() if self.eat_kw("WHERE") else None
        group_by: list[ast.SqlExpr] = []
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            if self.eat_kw("ALL"):  # DataFusion: group by every
                group_by.append(ast.GroupByAll())  # non-aggregate item
            else:
                group_by.append(self._parse_group_item())
                while self.eat("punct", ","):
                    group_by.append(self._parse_group_item())
        having = self.parse_expr() if self.eat_kw("HAVING") else None
        windows: list = []
        if self.eat_kw("WINDOW"):  # WINDOW w AS (spec) [, w2 AS (spec)]
            while True:
                wname = self.next().value.lower()
                self.expect_kw("AS")
                part, order_w, frame, fk = self._parse_window_spec()
                windows.append(
                    (
                        wname,
                        ast.WindowFunc(
                            None, tuple(part), tuple(order_w), frame,
                            fk or "rows",
                        ),
                    )
                )
                if not self.eat("punct", ","):
                    break
        order_by: list[ast.OrderItem] = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_kw("DESC"):
                    asc = False
                else:
                    self.eat_kw("ASC")
                nf = None
                if self.eat_kw("NULLS"):
                    nf = self.eat_kw("FIRST")
                    if not nf:
                        self.expect_kw("LAST")
                order_by.append(ast.OrderItem(e, asc, nf))
                if not self.eat("punct", ","):
                    break
        limit = None
        offset = 0
        if self.eat_kw("LIMIT"):
            limit = self._parse_const_int("LIMIT")
        if self.eat_kw("OFFSET"):
            offset = self._parse_const_int("OFFSET")
        return ast.Select(
            tuple(items), tuple(from_tables), tuple(joins), where,
            tuple(group_by), tuple(order_by), limit, distinct, having,
            offset=offset, windows=tuple(windows),
            distinct_on=tuple(distinct_on),
        )

    def parse_query(self) -> "ast.Statement":
        """[WITH ctes] select-or-set-op-chain."""
        if not self.eat_kw("WITH"):
            return self.parse_select_or_union()
        recursive = self.eat_kw("RECURSIVE")
        ctes = []
        seen = set()
        while True:
            tok = self.next()
            if tok.kind not in ("ident", "qident"):
                raise PlanError(f"expected CTE name, got {tok.value!r}")
            name = tok.value
            if name.lower() in seen:
                raise PlanError(f"duplicate CTE name '{name}'")
            seen.add(name.lower())
            cols = (
                tuple(self.parse_column_names())
                if self.at("punct", "(")
                else None
            )
            self.expect_kw("AS")
            self.expect("punct", "(")
            q = self.parse_query()  # a CTE body may itself start with WITH
            self.expect("punct", ")")
            ctes.append((name, cols, q))
            if not self.eat("punct", ","):
                break
        return ast.With(tuple(ctes), self.parse_select_or_union(), recursive)

    def parse_select_or_union(self) -> "ast.Statement":
        """Set-operation expression: INTERSECT binds tighter than
        UNION / EXCEPT (standard SQL; DataFusion's sqlparser agrees), all
        left-associative within a precedence level."""
        first = self._parse_intersect_chain()
        if not self.at_kw("UNION", "EXCEPT"):
            return first
        selects = [first]
        ops = []
        while True:
            if self.eat_kw("UNION"):
                op = "union all" if self.eat_kw("ALL") else "union"
                if self.eat_kw("BY"):  # UNION [ALL] BY NAME (DataFusion)
                    self.expect_kw("NAME")
                    op += " by name"
                ops.append(op)
            elif self.eat_kw("EXCEPT"):
                ops.append("except all" if self.eat_kw("ALL") else "except")
            else:
                break
            selects.append(self._parse_intersect_chain())
        selects[-1], order_by, limit, offset = _strip_trailing(selects[-1])
        return ast.Union(tuple(selects), tuple(ops), order_by, limit, offset)

    def _parse_intersect_chain(self) -> "ast.Statement":
        first = self.parse_select()
        if not self.at_kw("INTERSECT"):
            return first
        selects = [first]
        ops = []
        while self.eat_kw("INTERSECT"):
            ops.append("intersect all" if self.eat_kw("ALL") else "intersect")
            selects.append(self.parse_select())
        selects[-1], order_by, limit, offset = _strip_trailing(selects[-1])
        return ast.Union(tuple(selects), tuple(ops), order_by, limit, offset)

    def _maybe_filter_clause(self, fn: ast.Func) -> ast.Func:
        """agg(...) FILTER (WHERE <pred>) — standard aggregate filter."""
        if not (
            self.at_kw("FILTER")
            and self.peek(1).kind == "punct"
            and self.peek(1).value == "("
        ):
            return fn
        self.next()  # FILTER
        self.expect("punct", "(")
        self.expect_kw("WHERE")
        pred = self.parse_expr()
        self.expect("punct", ")")
        import dataclasses as _dc

        return _dc.replace(fn, filter_where=pred)

    def _parse_group_item(self) -> ast.SqlExpr:
        """One GROUP BY item; GROUPING SETS ((a, b), (a), ()) is special
        syntax (ROLLUP(...)/CUBE(...) parse as ordinary Func calls and
        are expanded by the binder)."""
        if self.at_kw("GROUPING") and self.peek(1).upper == "SETS":
            self.next()
            self.next()
            self.expect("punct", "(")
            sets = []
            while True:
                exprs: list = []
                if self.eat("punct", "("):
                    while not self.at("punct", ")"):
                        exprs.append(self.parse_expr())
                        if not self.eat("punct", ","):
                            break
                    self.expect("punct", ")")
                else:  # bare expr counts as a singleton set
                    exprs.append(self.parse_expr())
                sets.append(tuple(exprs))
                if not self.eat("punct", ","):
                    break
            self.expect("punct", ")")
            return ast.GroupingSets(tuple(sets))
        return self.parse_expr()

    def parse_table_ref(self) -> ast.TableRef:
        if self.at("punct", "("):  # derived table: ( SELECT|VALUES ... ) [AS] alias
            self.next()
            if self.at_kw("VALUES"):
                self.next()
                rows = []
                while True:
                    self.expect("punct", "(")
                    row = []
                    while not self.at("punct", ")"):
                        row.append(self.parse_literal_value())
                        self.eat("punct", ",")
                    self.expect("punct", ")")
                    rows.append(tuple(row))
                    if not self.eat("punct", ","):
                        break
                sub = ast.Values(tuple(rows))
            else:
                sub = self.parse_select_or_union()
            self.expect("punct", ")")
            alias, col_aliases = self._parse_alias(allow_columns=True)
            return ast.TableRef(
                "__derived__", alias, subquery=sub, col_aliases=col_aliases
            )
        name = self.parse_object_name()
        if self.at("punct", "("):  # table function: generate_series(1, 10)
            self.next()
            args = []
            if not self.at("punct", ")"):
                args.append(self.parse_expr())
                while self.eat("punct", ","):
                    args.append(self.parse_expr())
            self.expect("punct", ")")
            alias, col_aliases = self._parse_alias(allow_columns=True)
            return ast.TableRef(
                "__tablefunc__", alias, col_aliases=col_aliases,
                table_func=(name.lower(), tuple(args)),
            )
        alias, col_aliases = self._parse_alias(allow_columns=True)
        if col_aliases is not None:
            raise PlanError("column aliases are only valid on derived tables")
        return ast.TableRef(name, alias)

    def _parse_alias(self, allow_columns: bool = False):
        alias = None
        if self.eat_kw("AS"):
            alias = self.next().value
        elif self.peek().kind == "ident" and self.peek().upper not in _KEYWORDS_STOP:
            alias = self.next().value
        if allow_columns and alias is not None and self.at("punct", "("):
            return alias, tuple(self.parse_column_names())
        return (alias, None) if allow_columns else alias

    def _parse_star_modifiers(self) -> tuple:
        """* EXCLUDE (c1, c2) / * EXCEPT (c1) — DataFusion wildcard
        options.  EXCEPT followed by ( SELECT stays a set operation."""
        if (
            (self.at_kw("EXCLUDE") or self.at_kw("EXCEPT"))
            and self.peek(1).kind == "punct"
            and self.peek(1).value == "("
            and self.peek(2).upper != "SELECT"
        ):
            self.next()
            cols = tuple(self.parse_column_names())
            if not cols:
                raise PlanError("EXCLUDE requires at least one column")
            return cols
        if self.at_kw("EXCLUDE") and self.peek(1).kind in ("ident", "qident"):
            self.next()
            return (self.next().value,)
        return ()

    def parse_select_item(self) -> ast.SelectItem:
        if self.at("punct", "*"):
            self.next()
            return ast.SelectItem(ast.Star(exclude=self._parse_star_modifiers()), None)
        # qualified star: ident . *
        if (
            self.peek().kind in ("ident", "qident")
            and self.peek(1).kind == "punct"
            and self.peek(1).value == "."
            and self.peek(2).kind == "punct"
            and self.peek(2).value == "*"
        ):
            q = self.next().value
            self.next()
            self.next()
            return ast.SelectItem(
                ast.Star(q, exclude=self._parse_star_modifiers()), None
            )
        expr = self.parse_expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self.next().value
        elif self.peek().kind in ("ident", "qident") and self.peek().upper not in _KEYWORDS_STOP:
            alias = self.next().value
        return ast.SelectItem(expr, alias)

    # -- expressions (precedence climbing) ----------------------------------
    def parse_over(self, fn: ast.Func) -> ast.SqlExpr:
        """OVER (window spec) or OVER window_name (WINDOW clause ref)."""
        self.expect_kw("OVER")
        if self.peek().kind in ("ident", "qident") and not self.at(
            "punct", "("
        ):
            return ast.WindowFunc(fn, ref=self.next().value.lower())
        partition, order, frame, frame_kind = self._parse_window_spec()
        return ast.WindowFunc(
            fn, tuple(partition), tuple(order), frame, frame_kind or "rows"
        )

    def _parse_window_spec(self):
        """Parenthesized window spec shared by OVER (...) and WINDOW w AS."""
        self.expect("punct", "(")
        partition = []
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.parse_expr())
            while self.eat("punct", ","):
                partition.append(self.parse_expr())
        order = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_kw("DESC"):
                    asc = False
                else:
                    self.eat_kw("ASC")
                nf = None
                if self.eat_kw("NULLS"):
                    nf = self.eat_kw("FIRST")
                    if not nf:
                        self.expect_kw("LAST")
                order.append(ast.OrderItem(e, asc, nf))
                if not self.eat("punct", ","):
                    break
        frame = None
        frame_kind = None
        if self.at_kw("ROWS") or self.at_kw("RANGE"):
            frame_kind = "rows" if self.eat_kw("ROWS") else (self.next() and "range")
            self.expect_kw("BETWEEN")

            def bound(start: bool):
                if self.eat_kw("UNBOUNDED"):
                    self.expect_kw("PRECEDING" if start else "FOLLOWING")
                    return None  # unbounded
                if self.eat_kw("CURRENT"):
                    self.expect_kw("ROW")
                    return 0
                tok = self.expect("number").value
                n_ = float(tok) if "." in tok or "e" in tok.lower() else int(tok)
                if self.eat_kw("PRECEDING"):
                    return -n_
                self.expect_kw("FOLLOWING")
                return n_

            lo = bound(True)
            self.expect_kw("AND")
            hi = bound(False)
            frame = (lo, hi)
        self.expect("punct", ")")
        return partition, order, frame, frame_kind

    def parse_expr(self) -> ast.SqlExpr:
        return self.parse_or()

    def parse_or(self) -> ast.SqlExpr:
        left = self.parse_and()
        while self.eat_kw("OR"):
            left = ast.Binary(left, "OR", self.parse_and())
        return left

    def parse_and(self) -> ast.SqlExpr:
        left = self.parse_not()
        while self.eat_kw("AND"):
            left = ast.Binary(left, "AND", self.parse_not())
        return left

    def parse_not(self) -> ast.SqlExpr:
        if self.at_kw("NOT") and self.peek(1).upper == "EXISTS":
            self.next()
            self.next()
            self.expect("punct", "(")
            sub = self.parse_select()
            self.expect("punct", ")")
            return ast.Exists(sub, negated=True)
        if self.at_kw("NOT") and self.peek(1).upper != "IN":
            self.next()
            return ast.Unary("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.SqlExpr:
        left = self.parse_concat()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return ast.Binary(left, op, self.parse_concat())
        if self.at_kw("BETWEEN"):
            self.next()
            lo = self.parse_concat()
            self.expect_kw("AND")
            hi = self.parse_concat()
            return ast.Binary(
                ast.Binary(left, ">=", lo), "AND", ast.Binary(left, "<=", hi)
            )
        if self.at_kw("IS"):
            self.next()
            neg = self.eat_kw("NOT")
            if self.eat_kw("DISTINCT"):
                self.expect_kw("FROM")
                return ast.DistinctFrom(left, self.parse_concat(), negated=neg)
            self.expect_kw("NULL")
            node = ast.Func("isnull", (left,))
            return ast.Unary("NOT", node) if neg else node
        if self.at_kw("LIKE", "ILIKE") or (
            self.at_kw("NOT") and self.peek(1).upper in ("LIKE", "ILIKE")
        ):
            negated = self.eat_kw("NOT")
            ci = self.peek().upper == "ILIKE"
            self.next()
            return ast.Like(left, self.parse_concat(), negated, ci)
        if self.at_kw("SIMILAR") or (
            self.at_kw("NOT") and self.peek(1).upper == "SIMILAR"
        ):
            # [NOT] SIMILAR TO: SQL regex — %/_ wildcards plus the
            # | * + ? ( ) [ ] { } operators, full-match anchored;
            # desugars to regexp_like with a translated pattern
            negated = self.eat_kw("NOT")
            self.expect_kw("SIMILAR")
            self.expect_kw("TO")
            pat = self.parse_concat()
            if not (isinstance(pat, ast.Lit) and isinstance(pat.value, str)):
                raise PlanError("SIMILAR TO pattern must be a string literal")
            node = ast.Func(
                "regexp_like", (left, ast.Lit(_similar_to_regex(pat.value)))
            )
            return ast.Unary("NOT", node) if negated else node
        if self.at_kw("IN") or (self.at_kw("NOT") and self.peek(1).upper == "IN"):
            negated = self.eat_kw("NOT")
            self.expect_kw("IN")
            self.expect("punct", "(")
            if self.at_kw("SELECT"):
                sub = self.parse_select()
                self.expect("punct", ")")
                return ast.InSubquery(left, sub, negated=negated)
            items = [self.parse_concat()]
            while self.eat("punct", ","):
                items.append(self.parse_concat())
            self.expect("punct", ")")
            return ast.InList(left, tuple(items), negated=negated)
        return left

    def parse_concat(self) -> ast.SqlExpr:
        # || binds looser than +/- but tighter than comparisons (Postgres)
        left = self.parse_additive()
        while self.at("op", "||"):
            self.next()
            left = ast.Binary(left, "||", self.parse_additive())
        return left

    def parse_additive(self) -> ast.SqlExpr:
        left = self.parse_multiplicative()
        while self.at("punct", "+") or self.at("punct", "-"):
            op = self.next().value
            left = ast.Binary(left, op, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> ast.SqlExpr:
        left = self.parse_unary()
        while self.at("punct", "*") or self.at("punct", "/") or self.at("punct", "%"):
            op = self.next().value
            left = ast.Binary(left, op, self.parse_unary())
        return left

    def parse_unary(self) -> ast.SqlExpr:
        if self.eat("punct", "-"):
            return ast.Unary("-", self.parse_unary())
        if self.eat("punct", "+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> ast.SqlExpr:
        e = self.parse_primary()
        while True:
            if self.at("op", "::"):  # expr::TYPE cast shorthand
                self.next()
                e = ast.Cast(e, self.next().value.upper())
            elif self.at("punct", "["):  # arr[i] element access (1-based)
                self.next()
                idx = self.parse_expr()
                self.expect("punct", "]")
                e = ast.Func("array_element", (e, idx))
            else:
                return e

    def parse_primary(self) -> ast.SqlExpr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value) if "." in t.value or "e" in t.value.lower() else int(t.value)
            return ast.Lit(v)
        if t.kind == "string":
            self.next()
            return ast.Lit(t.value)
        if t.kind == "param":
            self.next()
            return ast.Param(int(t.value[1:]))
        if self.eat("punct", "("):
            if self.at_kw("SELECT"):
                sub = self.parse_select()
                self.expect("punct", ")")
                return ast.ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        if self.eat("punct", "["):  # [a, b, ...] array literal
            items = []
            if not self.at("punct", "]"):
                items.append(self.parse_expr())
                while self.eat("punct", ","):
                    items.append(self.parse_expr())
            self.expect("punct", "]")
            return ast.Func("make_array", tuple(items))
        if t.kind in ("ident", "qident"):
            if t.upper == "NULL":
                self.next()
                return ast.Lit(None)
            if t.upper == "TRUE":
                self.next()
                return ast.Lit(True)
            if t.upper == "FALSE":
                self.next()
                return ast.Lit(False)
            if t.upper == "CASE":
                self.next()
                operand = None
                if not self.at_kw("WHEN"):
                    operand = self.parse_expr()
                whens = []
                while self.eat_kw("WHEN"):
                    cond = self.parse_expr()
                    if operand is not None:
                        cond = ast.Binary(operand, "=", cond)
                    self.expect_kw("THEN")
                    whens.append((cond, self.parse_expr()))
                if not whens:
                    raise PlanError("CASE requires at least one WHEN")
                else_ = self.parse_expr() if self.eat_kw("ELSE") else None
                self.expect_kw("END")
                return ast.Case(tuple(whens), else_)
            if t.upper == "EXISTS" and self.peek(1).kind == "punct" and self.peek(1).value == "(":
                self.next()
                self.next()  # (
                sub = self.parse_select()
                self.expect("punct", ")")
                return ast.Exists(sub)
            if t.upper == "CAST":
                self.next()
                self.expect("punct", "(")
                e = self.parse_expr()
                self.expect_kw("AS")
                type_name = self.next().value.upper()
                self.expect("punct", ")")
                return ast.Cast(e, type_name)
            if (
                t.upper in ("DATE", "TIMESTAMP")
                and self.peek(1).kind == "string"
            ):
                # typed literal: DATE '2024-01-01' -> CAST('...' AS DATE)
                self.next()
                return ast.Cast(ast.Lit(self.next().value), t.upper)
            if t.upper == "INTERVAL" and self.peek(1).kind == "string":
                self.next()
                value = self.next().value
                unit = None
                if self.peek().kind in ("ident", "qident") and (
                    self.peek().upper.rstrip("S") in _INTERVAL_UNITS
                ):
                    unit = self.next().value
                return ast.Interval(value, unit)
            if t.upper in (
                "CURRENT_DATE", "CURRENT_TIMESTAMP", "CURRENT_TIME"
            ) and not (
                self.peek(1).kind == "punct" and self.peek(1).value == "("
            ):
                self.next()
                return ast.Func(t.value.lower(), ())
            if (
                t.upper == "EXTRACT"
                and self.peek(1).kind == "punct"
                and self.peek(1).value == "("
            ):
                self.next()
                self.next()  # (
                field = self.next().value
                self.expect_kw("FROM")
                e = self.parse_expr()
                self.expect("punct", ")")
                return ast.Func(
                    "date_part", (ast.Lit(field.lower()), e)
                )
            # function call?
            if self.peek(1).kind == "punct" and self.peek(1).value == "(":
                fname = self.next().value.lower()
                self.next()  # (
                if fname == "position" and not self.at("punct", ")"):
                    # position(substr IN str) -> strpos(str, substr)
                    sub = self.parse_concat()
                    if self.eat_kw("IN"):
                        s = self.parse_expr()
                        self.expect("punct", ")")
                        return ast.Func("strpos", (s, sub))
                    args = [sub]
                    while self.eat("punct", ","):
                        args.append(self.parse_expr())
                    self.expect("punct", ")")
                    return ast.Func("strpos", tuple(reversed(args)))
                distinct = self.eat_kw("DISTINCT")
                if self.eat("punct", "*"):
                    self.expect("punct", ")")
                    fn = ast.Func(fname, (), star=True)
                    fn = self._maybe_filter_clause(fn)
                    if self.at_kw("OVER"):
                        return self.parse_over(fn)
                    return fn
                args = []
                if not self.at("punct", ")"):
                    args.append(self.parse_expr())
                    while self.eat("punct", ","):
                        args.append(self.parse_expr())
                agg_order: list = []
                if self.eat_kw("ORDER"):  # array_agg(x ORDER BY y [DESC])
                    self.expect_kw("BY")
                    while True:
                        e = self.parse_expr()
                        asc = True
                        if self.eat_kw("DESC"):
                            asc = False
                        else:
                            self.eat_kw("ASC")
                        nf = None
                        if self.eat_kw("NULLS"):
                            nf = self.eat_kw("FIRST")
                            if not nf:
                                self.expect_kw("LAST")
                        agg_order.append(ast.OrderItem(e, asc, nf))
                        if not self.eat("punct", ","):
                            break
                self.expect("punct", ")")
                fn = ast.Func(
                    fname, tuple(args), distinct=distinct,
                    order_by=tuple(agg_order),
                )
                fn = self._maybe_filter_clause(fn)
                if self.at_kw("OVER"):
                    return self.parse_over(fn)
                return fn
            # column ref (possibly qualified)
            name = self.next().value
            if self.at("punct", ".") and self.peek(1).kind in ("ident", "qident"):
                self.next()
                col = self.next().value
                return ast.ColRef(name, col)
            return ast.ColRef(None, name)
        raise PlanError(f"unexpected token in expression: {t.value!r}")


_INTERVAL_UNITS = {
    "MICROSECOND", "MILLISECOND", "SECOND", "MINUTE", "HOUR", "DAY",
    "WEEK", "MONTH", "YEAR",
}


def parse_sql(sql: str) -> list[ast.Statement]:
    return Parser(sql).parse_statements()
