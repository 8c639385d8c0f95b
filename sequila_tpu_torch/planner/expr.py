"""Physical expressions: vectorized evaluation over host columnar batches.

Analog of DataFusion's PhysicalExpr tree as used by the reference's filter
parsing and evaluation (reference intervals.rs, interval_join.rs
evaluate_as_i32).  Expressions evaluate column-at-a-time over a Table (or a
plain list of numpy columns) and display themselves in DataFusion's
``name@index`` notation so EXPLAIN output is comparable with the
reference's plan assertions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
from pyarrow import types as pa_types

from sequila_tpu_torch.errors import ExecutionError, PlanError


class PhysicalExpr:
    def eval(self, cols: list[np.ndarray], num_rows: int) -> np.ndarray:
        raise NotImplementedError

    def columns(self) -> list["Column"]:
        """All Column nodes in this subtree (pre-order)."""
        return []

    def display(self) -> str:
        raise NotImplementedError

    def transform(self, fn) -> "PhysicalExpr":
        """Bottom-up rewrite; fn(node) returns a replacement node."""
        return fn(self)


@dataclasses.dataclass(frozen=True)
class Column(PhysicalExpr):
    name: str
    index: int

    def eval(self, cols, num_rows):
        return np.asarray(cols[self.index])

    def columns(self):
        return [self]

    def display(self):
        return f"{self.name}@{self.index}"


@dataclasses.dataclass(frozen=True)
class Literal(PhysicalExpr):
    value: Any

    def eval(self, cols, num_rows):
        if self.value is None:
            return np.full(num_rows, None, dtype=object)
        return np.full(num_rows, self.value)

    def display(self):
        if isinstance(self.value, str):
            return self.value
        if isinstance(self.value, bool):
            return "true" if self.value else "false"
        return str(self.value)


def truth(mask) -> np.ndarray:
    """Collapse a (possibly Kleene float 1/0/NaN) condition to a boolean
    filter mask: UNKNOWN (NaN) never passes (SQL WHERE semantics)."""
    m = np.asarray(mask)
    if m.dtype == bool:
        return m
    if m.dtype == object:
        return np.array([v is True or v == 1 for v in m], dtype=bool)
    with np.errstate(invalid="ignore"):
        return m == 1


def _kleene(x) -> np.ndarray:
    """Lift a condition to the Kleene float domain (1/0/NaN)."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x
    if x.dtype == object:
        return np.array(
            [np.nan if v is None or v != v else float(bool(v)) for v in x]
        )
    return x.astype(np.float64)


_ARROW_CMP = {
    "=": "equal", "!=": "not_equal", "<": "less", "<=": "less_equal",
    ">": "greater", ">=": "greater_equal",
}


def _arrow_str_col(cols, e):
    """The arrow ChunkedArray behind a plain string Column expr (decoded
    if dictionary-encoded), or None when the fast path doesn't apply.

    Comparing / pattern-matching through arrow compute keeps 500k-row
    string filters in C++ (~2 ms) instead of numpy object arrays with
    per-element rich compares (~90 ms measured on the q1-lapper bench
    config); UTF-8 byte order equals code-point order, so ordered
    comparisons agree with the Python-str fallback."""
    t = getattr(cols, "_t", None)
    if t is None or not isinstance(e, Column):
        return None
    try:
        col = t.column(e.index)
    except Exception:
        return None
    typ = col.type
    if pa_types.is_dictionary(typ):
        try:
            col = col.cast(typ.value_type)
        except Exception:
            return None
        typ = col.type
    if not (pa_types.is_string(typ) or pa_types.is_large_string(typ)):
        return None
    return col


def _arrow_bool_mask(res) -> np.ndarray:
    """Arrow boolean array -> engine mask: plain bool when NULL-free,
    Kleene float (1/0/NaN) when NULLs (UNKNOWN) are present."""
    import pyarrow as pa

    if res.null_count == 0:
        return res.to_numpy(zero_copy_only=False).astype(bool, copy=False)
    return res.cast(pa.float64()).to_numpy(zero_copy_only=False)


_OP_FUNCS = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": None,  # integer vs float division resolved at eval
    "%": np.fmod,  # SQL modulo takes the dividend's sign (not np.mod)
    "=": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
}


@dataclasses.dataclass(frozen=True)
class BinaryExpr(PhysicalExpr):
    left: PhysicalExpr
    op: str
    right: PhysicalExpr

    def eval(self, cols, num_rows):
        if self.op in _ARROW_CMP:
            fast = self._arrow_compare(cols)
            if fast is not None:
                return fast
        l = self.left.eval(cols, num_rows)
        r = self.right.eval(cols, num_rows)
        op = self.op
        if op == "AND":
            la, ra = np.asarray(l), np.asarray(r)
            if la.dtype == bool and ra.dtype == bool:
                return np.logical_and(la, ra)
            # Kleene: FALSE dominates, then UNKNOWN (NaN)
            lk, rk = _kleene(la), _kleene(ra)
            with np.errstate(invalid="ignore"):
                return np.where(
                    (lk == 0) | (rk == 0), 0.0,
                    np.where(np.isnan(lk) | np.isnan(rk), np.nan, 1.0),
                )
        if op == "OR":
            la, ra = np.asarray(l), np.asarray(r)
            if la.dtype == bool and ra.dtype == bool:
                return np.logical_or(la, ra)
            # Kleene: TRUE dominates, then UNKNOWN (NaN)
            lk, rk = _kleene(la), _kleene(ra)
            with np.errstate(invalid="ignore"):
                return np.where(
                    (lk == 1) | (rk == 1), 1.0,
                    np.where(np.isnan(lk) | np.isnan(rk), np.nan, 0.0),
                )
        if op == "/":
            l_arr, r_arr = np.asarray(l), np.asarray(r)
            if l_arr.dtype == object or r_arr.dtype == object:
                return self._object_arith(l_arr, r_arr, op)
            if np.issubdtype(l_arr.dtype, np.integer) and np.issubdtype(
                r_arr.dtype, np.integer
            ):
                # SQL integer division truncates toward zero (sqlite,
                # DataFusion); numpy // floors
                with np.errstate(divide="ignore", invalid="ignore"):
                    return np.fix(l_arr / r_arr).astype(np.int64)
            if _expr_is_integer(self.left, cols) and _expr_is_integer(
                self.right, cols
            ):
                # INT-typed columns ride as float (NaN = NULL) once any
                # NULL appears; keep SQL integer-division semantics
                # (truncate toward zero, NULLs stay NaN)
                with np.errstate(divide="ignore", invalid="ignore"):
                    return np.fix(l_arr / r_arr)
            return l_arr / r_arr
        if op == "||":
            # string concatenation, NULL-propagating (unlike concat());
            # operands render via the engine-wide CAST-to-text rules
            return _elementwise(
                lambda a, b: _sql_str(a) + _sql_str(b), [l, r], num_rows
            )
        fn = _OP_FUNCS.get(op)
        if fn is None:
            raise ExecutionError(f"unsupported operator {op}")
        if op in ("+", "-", "*", "%"):
            l_arr, r_arr = np.asarray(l), np.asarray(r)
            if l_arr.dtype == object or r_arr.dtype == object:
                return self._object_arith(l_arr, r_arr, op)
            return fn(l_arr, r_arr)
        if op in ("=", "!=", "<", "<=", ">", ">="):
            # SQL three-valued logic: comparisons with a NULL operand are
            # UNKNOWN, represented as NaN in a Kleene float array so that
            # NOT/AND/OR propagate it; truth() at filter boundaries maps
            # UNKNOWN -> excluded.  NULL-free inputs stay boolean.
            l_arr, r_arr = np.asarray(l), np.asarray(r)
            l_dt = np.issubdtype(l_arr.dtype, np.datetime64)
            r_dt = np.issubdtype(r_arr.dtype, np.datetime64)
            if l_dt != r_dt:
                # date/timestamp vs string literal: coerce the string side
                # (DataFusion's implicit Utf8 -> Date/Timestamp coercion)
                dt = l_arr.dtype if l_dt else r_arr.dtype
                if l_dt:
                    r_arr = _coerce_datetime(r_arr, dt)
                else:
                    l_arr = _coerce_datetime(l_arr, dt)
            if l_arr.dtype == object or r_arr.dtype == object:
                # vectorized rich-compare over the object arrays (one C
                # loop) instead of a per-element ufunc call — ~100x on
                # string filter columns; NULL slots are masked to a
                # harmless 0-vs-0 compare first so ordered ops never see
                # None, then restored as NaN (UNKNOWN)
                l_arr, r_arr = np.broadcast_arrays(l_arr, r_arr)
                nn = _null_mask(l_arr) | _null_mask(r_arr)
                if not nn.any():
                    return np.asarray(fn(l_arr, r_arr), dtype=bool)
                l_safe = l_arr.astype(object, copy=True)
                r_safe = r_arr.astype(object, copy=True)
                l_safe[nn] = 0
                r_safe[nn] = 0
                out = np.asarray(fn(l_safe, r_safe), dtype=np.float64)
                return np.where(nn, np.nan, out)
            nn = _null_mask(l_arr) | _null_mask(r_arr)
            with np.errstate(invalid="ignore"):
                out = fn(l_arr, r_arr)
            if nn.any():
                return np.where(nn, np.nan, out.astype(np.float64))
            return out
        return fn(l, r)

    def _arrow_compare(self, cols):
        """String Column-vs-Literal comparison via arrow compute (C++),
        or None when this isn't that shape.  See _arrow_str_col."""
        l, r, op = self.left, self.right, self.op
        if isinstance(l, Literal) and isinstance(r, Column):
            l, r = r, l
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if not (
            isinstance(l, Column)
            and isinstance(r, Literal)
            and isinstance(r.value, str)
        ):
            return None
        col = _arrow_str_col(cols, l)
        if col is None:
            return None
        import pyarrow.compute as pc

        return _arrow_bool_mask(getattr(pc, _ARROW_CMP[op])(col, r.value))

    @staticmethod
    def _object_arith(l_arr, r_arr, op):
        """NULL-propagating elementwise arithmetic for object arrays
        (outputs of nullif/coalesce/CASE over nullable columns)."""
        import math as _math

        l_arr, r_arr = np.broadcast_arrays(l_arr, r_arr)
        fns = {
            "+": lambda a, b: a + b,
            "-": lambda a, b: a - b,
            "*": lambda a, b: a * b,
            "%": _math.fmod,
            "/": lambda a, b: a / b,
        }
        f = fns[op]
        out = []
        for a, b in zip(l_arr, r_arr):
            if a is None or b is None or a != a or b != b:
                out.append(np.nan)
            else:
                out.append(float(f(float(a), float(b))))
        return np.array(out)

    def columns(self):
        return self.left.columns() + self.right.columns()

    def display(self):
        return f"{self.left.display()} {self.op} {self.right.display()}"

    def transform(self, fn):
        return fn(
            BinaryExpr(self.left.transform(fn), self.op, self.right.transform(fn))
        )


@dataclasses.dataclass(frozen=True)
class NotExpr(PhysicalExpr):
    child: PhysicalExpr

    def eval(self, cols, num_rows):
        c = np.asarray(self.child.eval(cols, num_rows))
        if c.dtype == bool:
            return np.logical_not(c)
        # Kleene NOT: 1-x keeps UNKNOWN (NaN) unknown
        return 1.0 - _kleene(c)

    def columns(self):
        return self.child.columns()

    def display(self):
        return f"NOT {self.child.display()}"

    def transform(self, fn):
        return fn(NotExpr(self.child.transform(fn)))


@dataclasses.dataclass(frozen=True)
class NegExpr(PhysicalExpr):
    child: PhysicalExpr

    def eval(self, cols, num_rows):
        return -self.child.eval(cols, num_rows)

    def columns(self):
        return self.child.columns()

    def display(self):
        return f"(- {self.child.display()})"

    def transform(self, fn):
        return fn(NegExpr(self.child.transform(fn)))


def _expr_is_integer(expr, cols) -> bool:
    """Static SQL-type check: does this expression have INTEGER type?
    Needed because NULL-bearing int columns are represented as float
    arrays (NaN = NULL), which would otherwise silently switch `/` to
    float division.  Conservative: unknown -> False (float semantics)."""
    t = getattr(cols, "_t", None)

    def rec(e):
        if isinstance(e, Literal):
            return isinstance(e.value, int) and not isinstance(e.value, bool)
        if isinstance(e, Column):
            if t is None:
                return False
            try:
                import pyarrow as pa

                return pa.types.is_integer(t.arrow.schema.field(e.index).type)
            except Exception:
                return False
        if isinstance(e, BinaryExpr) and e.op in ("+", "-", "*", "%", "/"):
            return rec(e.left) and rec(e.right)
        if isinstance(e, NegExpr):
            return rec(e.child)
        if isinstance(e, CastExpr):
            return e.type_name in (
                "INT", "INTEGER", "BIGINT", "SMALLINT", "TINYINT"
            )
        if isinstance(e, IfNullExpr):
            return rec(e.child) and isinstance(e.default, int)
        if isinstance(e, ScalarFuncExpr) and e.name == "date_part":
            f = e.args[0]
            return isinstance(f, Literal) and str(f.value).lower() != "epoch"
        return False

    return rec(expr)


def _expr_is_boolean(expr) -> bool:
    """Static SQL-type check: does this expression have BOOLEAN type?
    Kleene logic rides as float 1/0/NaN arrays once NULLs appear; output
    assembly uses this to restore the arrow Boolean type."""
    if isinstance(expr, Literal):
        return isinstance(expr.value, bool)
    if isinstance(expr, BinaryExpr):
        return expr.op in (
            "=", "!=", "<", "<=", ">", ">=", "AND", "OR"
        )
    if isinstance(expr, (NotExpr, LikeExpr, InListExpr, DistinctFromExpr)):
        return True
    if isinstance(expr, ScalarFuncExpr):
        return expr.name in (
            "isnull", "starts_with", "ends_with", "regexp_like",
        )
    if isinstance(expr, CastExpr):
        return expr.type_name in ("BOOL", "BOOLEAN")
    return False


def to_output_array(expr, cols, vals):
    """Expression result -> arrow array for query output.

    Restores the engine-wide NULL representation (NaN in numeric arrays,
    None in object arrays) to real arrow nulls, and applies the
    statically inferred SQL type: INT expressions that rode as float
    (NaN = NULL) come back as Int64, Kleene 1/0/NaN logic as Boolean —
    matching what DataFusion's typed engine returns for the same query."""
    import pyarrow as pa

    if isinstance(vals, pa.Array):
        if (
            expr is not None
            and pa.types.is_floating(vals.type)
            and _expr_is_integer(expr, cols)
        ):
            try:
                return vals.cast(pa.int64())
            except pa.ArrowInvalid:
                return vals
        return vals
    a = np.asarray(vals)
    if a.dtype == object:
        if any(isinstance(v, float) and v != v for v in a):
            a = np.array(
                [
                    None
                    if (v is None or (isinstance(v, float) and v != v))
                    else v
                    for v in a
                ],
                dtype=object,
            )
        return pa.array(a)
    if np.issubdtype(a.dtype, np.floating):
        nulls = np.isnan(a)
        mask = nulls if nulls.any() else None
        if expr is not None and _expr_is_boolean(expr):
            return pa.array(a != 0, mask=mask)
        if expr is not None and _expr_is_integer(expr, cols):
            safe = np.where(nulls, 0, a) if mask is not None else a
            return pa.array(safe.astype(np.int64), mask=mask)
        return pa.array(a, mask=mask)
    return pa.array(a)


def _coerce_datetime(a: np.ndarray, dt) -> np.ndarray:
    """Coerce a string/object array to the given datetime64 dtype
    (NULL -> NaT); raises ExecutionError on unparseable values."""
    a = np.asarray(a)
    try:
        if a.dtype == object:
            return np.array(
                [
                    np.datetime64("NaT")
                    if (v is None or (isinstance(v, float) and v != v))
                    else np.datetime64(str(v))
                    for v in a.ravel()
                ],
                dtype=dt,
            ).reshape(a.shape)
        return a.astype(dt)
    except ValueError as exc:
        raise ExecutionError(f"cannot coerce value to {dt}: {exc}") from exc


def _null_mask(a: np.ndarray) -> np.ndarray:
    """Elementwise NULL mask (NaN for floats, None for object arrays,
    NaT for datetime64/timedelta64)."""
    a = np.asarray(a)
    if a.dtype == object:
        return np.array([v is None for v in a], dtype=bool)
    if np.issubdtype(a.dtype, np.floating):
        return np.isnan(a)
    if np.issubdtype(a.dtype, np.datetime64) or np.issubdtype(
        a.dtype, np.timedelta64
    ):
        return np.isnat(a)
    return np.zeros(a.shape, dtype=bool)


_CAST_NUMPY = {
    "INT": np.int64, "INTEGER": np.int64, "BIGINT": np.int64,
    "SMALLINT": np.int64, "TINYINT": np.int64,
    "FLOAT": np.float64, "DOUBLE": np.float64, "REAL": np.float64,
    "DECIMAL": np.float64, "NUMERIC": np.float64,
    "BOOLEAN": np.bool_, "BOOL": np.bool_,
    "VARCHAR": object, "TEXT": object, "STRING": object, "CHAR": object,
}


@dataclasses.dataclass(frozen=True)
class CastExpr(PhysicalExpr):
    """SQL CAST with real coercion (reference inherits DataFusion's
    CastExpr; its i32 interval casts are handled separately with the
    overflow hard-error in evaluate_as_i32 — interval_join.rs:1661-1672)."""

    child: PhysicalExpr
    type_name: str

    def eval(self, cols, num_rows):
        a = np.asarray(self.child.eval(cols, num_rows))
        if self.type_name in ("DATE", "TIMESTAMP", "DATETIME"):
            dt = np.dtype(
                "datetime64[D]" if self.type_name == "DATE"
                else "datetime64[us]"
            )
            if np.issubdtype(a.dtype, np.datetime64):
                return a.astype(dt)
            return _coerce_datetime(a, dt)
        target = _CAST_NUMPY.get(self.type_name)
        if target is None:
            raise ExecutionError(f"unsupported CAST type: {self.type_name}")
        nulls = _null_mask(a)
        if target is object:
            out = np.array(
                [None if nn else _sql_str(v) for v, nn in zip(a, nulls)],
                dtype=object,
            )
            return out
        if a.dtype == object or nulls.any():
            # NULL-preserving numeric cast goes through float (NaN = NULL)
            vals = np.array(
                [np.nan if nn else float(v) for v, nn in zip(a, nulls)]
            )
            if target is np.float64:
                return vals
            if target is np.int64:
                # truncate toward zero; NULLs stay NaN (the engine-wide
                # NULL representation for numeric arrays)
                out = np.trunc(vals)
                return out if nulls.any() else out.astype(np.int64)
            if target is np.bool_:
                if nulls.any():
                    return np.array(
                        [None if nn else bool(v)
                         for v, nn in zip(vals, nulls)],
                        dtype=object,
                    )
                return vals.astype(np.bool_)
            return vals.astype(target)
        if target is np.int64 and np.issubdtype(a.dtype, np.floating):
            return np.trunc(a).astype(np.int64)
        return a.astype(target)

    def columns(self):
        return self.child.columns()

    def display(self):
        return f"CAST({self.child.display()} AS {self.type_name})"

    def transform(self, fn):
        return fn(CastExpr(self.child.transform(fn), self.type_name))


def _sql_str(v) -> str:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


@dataclasses.dataclass(frozen=True)
class InListExpr(PhysicalExpr):
    """SQL [NOT] IN over a literal or subquery-produced value list with
    Kleene three-valued semantics: NULL x (or an unmatched list NULL) is
    UNKNOWN (NaN), which truth() excludes at filter boundaries and NOT
    keeps unknown."""

    child: PhysicalExpr
    values: tuple
    negated: bool
    has_null: bool = False

    def eval(self, cols, num_rows):
        a = np.asarray(self.child.eval(cols, num_rows))
        if not len(self.values):
            # IN over an empty set is FALSE for every row (even NULL x)
            out = np.zeros(a.shape, dtype=bool)
            return ~out if self.negated else out
        nulls = _null_mask(a)
        if isinstance(self.values, np.ndarray):
            # subquery fast path (binder): NULLs already dropped
            # (has_null records them), values stay a numpy array —
            # to_pylist of a 500k-row subquery was the whole cost
            vals = self.values
        else:
            vals = [v for v in self.values if v is not None]
        if a.dtype == object:
            member = None
            if len(a) >= 4096:
                # arrow's hash-based is_in beats per-row set membership
                # ~5x at 500k strings; non-string objects fall back
                try:
                    import pyarrow as pa
                    import pyarrow.compute as pc

                    pa_a = pa.array(a, from_pandas=True)
                    pa_v = pa.array(list(vals) if not isinstance(vals, np.ndarray) else vals)
                    if pa.types.is_string(pa_a.type) and pa_a.type == pa_v.type:
                        member = np.asarray(
                            pc.is_in(pa_a, value_set=pa_v).fill_null(False)
                        )
                        member &= ~nulls
                except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
                    member = None
            if member is None:
                sv = set(vals)
                member = np.array(
                    [(v in sv) if not nn else False for v, nn in zip(a, nulls)],
                    dtype=bool,
                )
        else:
            member = (
                np.isin(a, np.asarray(vals))
                if len(vals)
                else np.zeros(a.shape, bool)
            )
            member &= ~nulls
        # Kleene: matches are TRUE; NULL x (or a NULL in the list when
        # nothing matched) is UNKNOWN; truth() at the filter boundary
        # excludes UNKNOWN rows
        unknown = nulls | (~member & self.has_null)
        if not unknown.any():
            return ~member if self.negated else member
        base = np.where(member, 1.0, 0.0)
        out = np.where(unknown & ~member, np.nan, base)
        return 1.0 - out if self.negated else out

    def columns(self):
        return self.child.columns()

    def display(self):
        shown = ", ".join(str(v) for v in self.values[:6])
        if len(self.values) > 6:
            shown += ", ..."
        op = "NOT IN" if self.negated else "IN"
        return f"{self.child.display()} {op} ({shown})"

    def transform(self, fn):
        return fn(
            InListExpr(
                self.child.transform(fn), self.values, self.negated, self.has_null
            )
        )


def _str_args(arrs, n):
    """Broadcast scalar/array args to length-n object lists."""
    out = []
    for a in arrs:
        a = np.asarray(a)
        if a.ndim == 0:
            out.append([a.item()] * n)
        else:
            out.append(list(a))
    return out


def _elementwise(fn, arrs, n, skip_null=True, boxed=False):
    cols = _str_args(arrs, n)
    res = []
    for row in zip(*cols):
        if skip_null and any(
            v is None or (isinstance(v, float) and v != v) for v in row
        ):
            res.append(None)
        else:
            res.append(fn(*row))
    if boxed:
        # list-valued results: assign per element so numpy can't collapse
        # equal-length lists into a 2-D array
        out = np.empty(len(res), dtype=object)
        for i, v in enumerate(res):
            out[i] = v
        return out
    return np.array(res, dtype=object)


def _sql_substr(s_, start, length=None):
    start = int(start)
    # SQL substr is 1-based; 0/negative follow DataFusion (chars before
    # position 1 are not part of the string but count against length)
    begin = max(start - 1, 0)
    if length is None:
        return s_[begin:]
    end = start - 1 + int(length)
    return s_[begin:max(end, begin)]


_NUMERIC_FUNCS = {
    "abs": np.abs,
    "floor": np.floor,
    "ceil": np.ceil,
    "ceiling": np.ceil,
    "sqrt": np.sqrt,
    "cbrt": np.cbrt,
    "exp": np.exp,
    "ln": np.log,
    "log10": np.log10,
    "log2": np.log2,
    "sign": np.sign,
    "signum": np.sign,
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "asinh": np.arcsinh,
    "acosh": np.arccosh,
    "atanh": np.arctanh,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "degrees": np.degrees,
    "radians": np.radians,
    "trunc": np.trunc,
    "cot": lambda a: 1.0 / np.tan(a),
}

# names _arrow_string_fast can ever serve — checked before the probe so
# hot non-string functions (abs, coalesce, ...) skip it entirely
_ARROW_FAST_NAMES = frozenset(
    {
        "upper", "lower", "length", "char_length", "character_length",
        "octet_length", "bit_length", "reverse", "trim", "ltrim",
        "rtrim", "btrim", "starts_with", "ends_with", "contains",
        "replace",
    }
)

# Python's str.strip() whitespace set (str.isspace chars), computed once:
# pc.utf8_trim_whitespace uses Unicode White_Space, which EXCLUDES
# \x1c-\x1f/\x85 that Python strips — the explicit set keeps the fast
# path bit-identical to the fallback
_PY_WHITESPACE = "".join(
    chr(c) for c in range(0x3001) if chr(c).isspace()
)


def _arrow_string_fast(name, args, cols, num_rows):
    """C++ fast path for string functions applied to a plain arrow
    string column (same rationale as the LIKE fast path: per-row Python
    string ops cost ~50x more than arrow compute at 500k rows).  Returns
    None when the fast path doesn't apply; NULLs surface as None/NaN
    exactly like the Python fallback."""
    import pyarrow.compute as pc

    one_arg = {
        "upper": pc.utf8_upper,
        "lower": pc.utf8_lower,
        "length": pc.utf8_length,
        "char_length": pc.utf8_length,
        "character_length": pc.utf8_length,
        "octet_length": pc.binary_length,
        "bit_length": lambda c: pc.multiply(pc.binary_length(c), 8),
        "reverse": pc.utf8_reverse,
        "trim": lambda c: pc.utf8_trim(c, characters=_PY_WHITESPACE),
        "ltrim": lambda c: pc.utf8_ltrim(c, characters=_PY_WHITESPACE),
        "rtrim": lambda c: pc.utf8_rtrim(c, characters=_PY_WHITESPACE),
        "btrim": lambda c: pc.utf8_trim(c, characters=_PY_WHITESPACE),
    }
    col = _arrow_str_col(cols, args[0]) if args else None
    if col is None:
        return None
    try:
        if len(args) == 1 and name in one_arg:
            if name in ("upper", "lower") and (
                pc.all(pc.string_is_ascii(col), min_count=0).as_py()
                is False
            ):
                # utf8proc's simple case mapping diverges from Python/
                # Rust full mappings ('ß'.upper() == 'SS'); non-ASCII
                # columns take the exact Python path
                return None
            res = one_arg[name](col)
        elif (
            len(args) == 2
            and name in ("starts_with", "ends_with", "contains")
            # (strpos/instr excluded: pc.find_substring reports BYTE
            # offsets, diverging from Python's code-point find on
            # non-ASCII input)
            and isinstance(args[1], Literal)
            and isinstance(args[1].value, str)
        ):
            pat = args[1].value
            if name == "starts_with":
                res = pc.starts_with(col, pattern=pat)
            elif name == "ends_with":
                res = pc.ends_with(col, pattern=pat)
            else:
                res = pc.match_substring(col, pattern=pat)
        elif (
            len(args) == 3
            and name == "replace"
            and isinstance(args[1], Literal)
            and isinstance(args[2], Literal)
            and isinstance(args[1].value, str)
            and isinstance(args[2].value, str)
        ):
            res = pc.replace_substring(
                col, pattern=args[1].value, replacement=args[2].value
            )
        else:
            return None
    except Exception:
        return None  # any arrow corner falls back to the Python path
    if res.null_count > 0:
        # match the Python fallback's representation exactly: object
        # array with None (ints stay ints — typed NULL output relies
        # on it; a float64/NaN conversion would change output types)
        return np.array(res.to_pylist(), dtype=object)
    return res.to_numpy(zero_copy_only=False)


def _initcap(s_):
    import re as _re

    return _re.sub(
        r"[A-Za-z0-9]+", lambda m: m.group(0).capitalize(), str(s_)
    )


_STRING_FUNCS = {
    "upper": lambda s_: str(s_).upper(),
    "lower": lambda s_: str(s_).lower(),
    "length": lambda s_: len(str(s_)),
    "char_length": lambda s_: len(str(s_)),
    "character_length": lambda s_: len(str(s_)),
    "octet_length": lambda s_: len(str(s_).encode("utf-8")),
    "reverse": lambda s_: str(s_)[::-1],
    "initcap": _initcap,
    "ascii": lambda s_: ord(str(s_)[0]) if str(s_) else 0,
    "bit_length": lambda s_: 8 * len(str(s_).encode("utf-8")),
    "md5": lambda s_: __import__("hashlib").md5(
        str(s_).encode("utf-8")
    ).hexdigest(),
    "sha224": lambda s_: __import__("hashlib").sha224(
        str(s_).encode("utf-8")
    ).hexdigest(),
    "sha256": lambda s_: __import__("hashlib").sha256(
        str(s_).encode("utf-8")
    ).hexdigest(),
    "sha384": lambda s_: __import__("hashlib").sha384(
        str(s_).encode("utf-8")
    ).hexdigest(),
    "sha512": lambda s_: __import__("hashlib").sha512(
        str(s_).encode("utf-8")
    ).hexdigest(),
}


def _levenshtein(a, b2):
    """Classic two-row DP edit distance (DataFusion's levenshtein)."""
    a, b2 = str(a), str(b2)
    if len(a) < len(b2):
        a, b2 = b2, a
    prev = list(range(len(b2) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b2, 1):
            cur.append(
                min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            )
        prev = cur
    return prev[-1]


def _substr_index(s_, delim, n):
    """MySQL/DataFusion substr_index: everything before the nth
    occurrence of delim (after the nth-from-last when n < 0)."""
    s_, delim, n = str(s_), str(delim), int(n)
    if n == 0 or not delim:
        return ""
    parts = s_.split(delim)
    if n > 0:
        return delim.join(parts[:n])
    return delim.join(parts[n:])


def _sql_pad(s_, n, fill=" ", left=True):
    s_, n, fill = str(s_), int(n), str(fill)
    if n <= 0:
        return ""
    if len(s_) >= n:
        return s_[:n]
    if not fill:
        return s_
    pad = (fill * -(-(n - len(s_)) // len(fill)))[: n - len(s_)]
    return pad + s_ if left else s_ + pad


def _sql_split_part(s_, sep, n):
    s_, sep, n = str(s_), str(sep), int(n)
    if not sep:
        raise ExecutionError("split_part: empty delimiter")
    parts = s_.split(sep)
    if n < 0:
        n += len(parts) + 1
    return parts[n - 1] if 1 <= n <= len(parts) else ""


def _sql_left(s_, n):
    s_, n = str(s_), int(n)
    if n >= 0:
        return s_[:n]
    return s_[:n] if n > -len(s_) else ""


def _sql_right(s_, n):
    s_, n = str(s_), int(n)
    if n > 0:
        return s_[-n:]
    return s_[-n:] if n != 0 else ""


def _regex_flags(flags: str) -> int:
    import re as _re

    f = 0
    for ch in str(flags):
        if ch == "i":
            f |= _re.IGNORECASE
        elif ch == "s":
            f |= _re.DOTALL
        elif ch == "m":
            f |= _re.MULTILINE
        elif ch == "x":
            f |= _re.VERBOSE
        elif ch != "g":  # 'g' handled by the caller (global replace)
            raise ExecutionError(f"unsupported regexp flag: {ch!r}")
    return f


# (min_args, max_args or None for variadic)
SCALAR_FUNC_ARITY = {
    **{k: (1, 1) for k in _NUMERIC_FUNCS},
    **{k: (1, 1) for k in _STRING_FUNCS},
    "isnull": (1, 1), "round": (1, 2), "power": (2, 2), "pow": (2, 2),
    "substr": (2, 3), "substring": (2, 3), "concat": (1, None),
    "replace": (3, 3), "starts_with": (2, 2), "ends_with": (2, 2),
    "coalesce": (1, None), "nullif": (2, 2), "ifnull": (2, 2),
    "nvl": (2, 2), "greatest": (1, None), "least": (1, None),
    "trim": (1, 2), "ltrim": (1, 2), "rtrim": (1, 2), "btrim": (1, 2),
    "lpad": (2, 3), "rpad": (2, 3), "split_part": (3, 3),
    "translate": (3, 3), "repeat": (2, 2), "left": (2, 2),
    "right": (2, 2), "strpos": (2, 2), "instr": (2, 2),
    "concat_ws": (2, None), "chr": (1, 1), "to_hex": (1, 1),
    "regexp_like": (2, 3), "regexp_replace": (3, 4), "regexp_count": (2, 3),
    "arrow_typeof": (1, 1),
    # temporal (DataFusion's datetime library subset)
    "now": (0, 0), "current_timestamp": (0, 0), "current_date": (0, 0),
    "version": (0, 0),
    "to_timestamp": (1, 1), "to_date": (1, 1),
    "date_part": (2, 2), "date_trunc": (2, 2),
    "atan2": (2, 2), "log": (1, 2), "pi": (0, 0),
    "factorial": (1, 1), "gcd": (2, 2), "lcm": (2, 2),
    "isnan": (1, 1), "iszero": (1, 1), "nanvl": (2, 2),
    "random": (0, 0), "uuid": (0, 0), "nvl2": (3, 3), "mod": (2, 2),
    "contains": (2, 2), "find_in_set": (2, 2), "levenshtein": (2, 2),
    "substr_index": (3, 3), "regexp_match": (2, 3),
    "current_time": (0, 0), "today": (0, 0),
    "datepart": (2, 2), "datetrunc": (2, 2),
    "from_unixtime": (1, 1), "to_unixtime": (1, 1),
    "make_date": (3, 3), "to_char": (2, 2), "date_format": (2, 2),
    "to_local_time": (1, 1), "date_bin": (2, 3),
    "digest": (2, 2), "encode": (2, 2), "decode": (2, 2),
    # arrays (DataFusion's array library subset; values are python lists
    # in object arrays, arrow list columns at the boundaries)
    "make_array": (0, None), "array": (0, None),
    "array_length": (1, 1), "cardinality": (1, 1),
    "array_element": (2, 2), "list_element": (2, 2),
    "array_contains": (2, 2), "array_has": (2, 2),
    "array_position": (2, 2),
    "array_to_string": (2, 3), "string_to_array": (2, 3),
    "array_join": (2, 3), "list_join": (2, 3),
    "array_append": (2, 2), "list_append": (2, 2),
    "array_push_back": (2, 2),
    "array_prepend": (2, 2), "list_prepend": (2, 2),
    "array_concat": (2, None), "array_cat": (2, None),
    "array_slice": (3, 4), "list_slice": (3, 4),
    "array_sort": (1, 3), "list_sort": (1, 3),
    "array_distinct": (1, 1), "array_reverse": (1, 1),
    "array_union": (2, 2), "array_intersect": (2, 2),
    "array_except": (2, 2),
    "array_remove": (2, 2), "array_remove_all": (2, 2),
    "array_repeat": (2, 2),
    "array_replace": (3, 3), "array_replace_all": (3, 3),
    "array_pop_back": (1, 1), "array_pop_front": (1, 1),
    "array_max": (1, 1), "array_min": (1, 1),
    "array_has_all": (2, 2), "array_has_any": (2, 2),
    "flatten": (1, 1), "empty": (1, 1), "array_empty": (1, 1),
    # structs (DataFusion's struct library; cells are python dicts in
    # object arrays, arrow struct columns at the boundaries)
    "struct": (1, None), "named_struct": (2, None), "row": (1, None),
    "get_field": (2, 2),
    # maps (DataFusion's map library; dict cells like structs)
    "map": (2, 2), "make_map": (2, None),
    "map_keys": (1, 1), "map_values": (1, 1),
    "map_extract": (2, 2), "map_contains_key": (2, 2),
}


def _unbox_py(v):
    """numpy scalar -> python scalar (arrow list inference friendly)."""
    return v.item() if isinstance(v, np.generic) else v


def _as_list(v):
    """Normalize a cell to a python list (arrow list columns surface as
    numpy arrays or lists); None for NULL/non-sequence."""
    if v is None or isinstance(v, (str, bytes)):
        return None
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return list(v)
    return None

def _cellv(x):
    """Normalize one cell value: NaN (engine NULL) -> None, numpy -> py."""
    return (
        None
        if (x is None or (isinstance(x, float) and x != x))
        else _unbox_py(x)
    )


def _arr_slice(v, fr, to, stride=None):
    """DataFusion array_slice: 1-based inclusive bounds, negative counts
    from the end, optional (possibly negative) stride."""
    lst = _as_list(v)
    if lst is None or fr is None or to is None:
        return None
    n = len(lst)
    fr, to = int(fr), int(to)
    if fr < 0:
        fr += n + 1
    if to < 0:
        to += n + 1
    st = 1 if stride is None else int(stride)
    if st == 0:
        raise ExecutionError("array_slice stride cannot be zero")
    ids = range(fr - 1, to, st) if st > 0 else range(fr - 1, to - 2, st)
    return [lst[i] for i in ids if 0 <= i < n]


def _arr_sort(v, order=None, nulls=None):
    lst = _as_list(v)
    if lst is None:
        return None
    desc = str(order or "ASC").strip().upper() == "DESC"
    nf = str(nulls or "NULLS LAST").strip().upper() == "NULLS FIRST"
    vals_ = [_cellv(x) for x in lst]
    nones = [x for x in vals_ if x is None]
    rest = sorted((x for x in vals_ if x is not None), reverse=desc)
    return nones + rest if nf else rest + nones


def _arr_distinct(lst):
    out, seen = [], set()
    for x in lst:
        x = _cellv(x)
        try:
            k = (type(x).__name__, x)
            new = k not in seen
            if new:
                seen.add(k)
        except TypeError:  # unhashable (nested list): linear scan
            new = x not in out
        if new:
            out.append(x)
    return out


def _with_list(fn):
    """Lift fn(list, *rest) over a NULL-propagating list cell."""

    def go(v, *rest):
        lst = _as_list(v)
        return None if lst is None else fn([_cellv(x) for x in lst], *rest)

    return go


def _arr_remove(lst, x, all_=False):
    x = _cellv(x)
    out, removed = [], False
    for e in lst:
        if e == x and (all_ or not removed):
            removed = True
            continue
        out.append(e)
    return out


def _arr_replace(lst, frm, to, all_=False):
    frm, to = _cellv(frm), _cellv(to)
    out, done = [], False
    for e in lst:
        if e == frm and (all_ or not done):
            done = True
            out.append(to)
        else:
            out.append(e)
    return out


def _arr_concat(*arrs):
    out = []
    for v in arrs:
        lst = _as_list(v)
        if lst is None:
            return None
        out.extend(_cellv(x) for x in lst)
    return out


def _arr_has(v, w, quant):
    """array_has_all/any: membership list hoisted once per row (not once
    per needle)."""
    la, lw = _as_list(v), _as_list(w)
    if la is None or lw is None:
        return None
    members = [_cellv(e) for e in la]
    return quant(_cellv(x) in members for x in lw)


def _arr_setop(v, w, kind):
    la, lb = _as_list(v), _as_list(w)
    if la is None or lb is None:
        return None
    la = [_cellv(x) for x in la]
    lb = [_cellv(x) for x in lb]
    if kind == "union":
        return _arr_distinct(la + lb)
    if kind == "intersect":
        return [x for x in _arr_distinct(la) if x in lb]
    return [x for x in _arr_distinct(la) if x not in lb]


_ARRAY_FUNC_IMPLS = {
    "array_append": _with_list(lambda lst, x: lst + [_cellv(x)]),
    "list_append": _with_list(lambda lst, x: lst + [_cellv(x)]),
    "array_push_back": _with_list(lambda lst, x: lst + [_cellv(x)]),
    "array_prepend": lambda x, v: (
        None if _as_list(v) is None
        else [_cellv(x)] + [_cellv(e) for e in _as_list(v)]
    ),
    "list_prepend": lambda x, v: (
        None if _as_list(v) is None
        else [_cellv(x)] + [_cellv(e) for e in _as_list(v)]
    ),
    "array_concat": _arr_concat,
    "array_cat": _arr_concat,
    "array_slice": _arr_slice,
    "list_slice": _arr_slice,
    "array_sort": _arr_sort,
    "list_sort": _arr_sort,
    "array_distinct": _with_list(_arr_distinct),
    "array_reverse": _with_list(lambda lst: lst[::-1]),
    "array_union": lambda v, w: _arr_setop(v, w, "union"),
    "array_intersect": lambda v, w: _arr_setop(v, w, "intersect"),
    "array_except": lambda v, w: _arr_setop(v, w, "except"),
    "array_remove": _with_list(_arr_remove),
    "array_remove_all": _with_list(lambda lst, x: _arr_remove(lst, x, True)),
    "array_repeat": lambda x, n2: (
        None if n2 is None else [_cellv(x)] * max(int(n2), 0)
    ),
    "array_replace": _with_list(_arr_replace),
    "array_replace_all": _with_list(
        lambda lst, f, t2: _arr_replace(lst, f, t2, True)
    ),
    "array_pop_back": _with_list(lambda lst: lst[:-1]),
    "array_pop_front": _with_list(lambda lst: lst[1:]),
    "array_max": _with_list(
        lambda lst: max((x for x in lst if x is not None), default=None)
    ),
    "array_min": _with_list(
        lambda lst: min((x for x in lst if x is not None), default=None)
    ),
    "array_has_all": lambda v, w: _arr_has(v, w, all),
    "array_has_any": lambda v, w: _arr_has(v, w, any),
    "flatten": _with_list(
        lambda lst: [
            y
            for x in lst
            for y in (_as_list(x) if _as_list(x) is not None else [x])
        ]
    ),
    "empty": _with_list(lambda lst: len(lst) == 0),
    "array_empty": _with_list(lambda lst: len(lst) == 0),
}

SCALAR_FUNCS = set(SCALAR_FUNC_ARITY)


def _date_part_vec(field: str, a: np.ndarray) -> np.ndarray:
    """Vectorized date_part over a datetime64 array; NULL (NaT) -> NaN.
    Fields follow Postgres/DataFusion names."""
    f = str(field).lower()
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.datetime64):
        a = _coerce_datetime(a, np.dtype("datetime64[us]"))
    a = a.astype("datetime64[us]")
    nat = np.isnat(a)
    safe = np.where(nat, np.datetime64(0, "us"), a)
    Y = safe.astype("datetime64[Y]")
    M = safe.astype("datetime64[M]")
    D = safe.astype("datetime64[D]")
    if f in ("year", "years"):
        out = Y.astype(np.int64) + 1970
    elif f in ("quarter",):
        out = ((M - Y).astype(np.int64)) // 3 + 1
    elif f in ("month", "months"):
        out = (M - Y).astype(np.int64) + 1
    elif f in ("day", "days"):
        out = (D - M).astype(np.int64) + 1
    elif f in ("hour", "hours"):
        out = (safe.astype("datetime64[h]") - D).astype(np.int64)
    elif f in ("minute", "minutes"):
        out = (
            safe.astype("datetime64[m]") - safe.astype("datetime64[h]")
        ).astype(np.int64)
    elif f in ("second", "seconds"):
        out = (
            safe.astype("datetime64[s]") - safe.astype("datetime64[m]")
        ).astype(np.int64)
    elif f in ("millisecond", "milliseconds"):
        out = (
            (safe - safe.astype("datetime64[m]")).astype(np.int64) // 1000
        )
    elif f in ("microsecond", "microseconds"):
        out = (safe - safe.astype("datetime64[m]")).astype(np.int64)
    elif f in ("dow",):  # Sunday = 0 (Postgres)
        out = (D.astype(np.int64) + 4) % 7
    elif f in ("doy",):
        out = (D - Y).astype(np.int64) + 1
    elif f in ("week",):  # ISO week of the year
        thu = D - ((D.astype(np.int64) + 3) % 7 - 3).astype("timedelta64[D]")
        thu_year = thu.astype("datetime64[Y]")
        out = (thu - thu_year).astype(np.int64) // 7 + 1
    elif f in ("epoch",):
        out = safe.astype(np.int64) / 1e6
        return np.where(nat, np.nan, out)
    elif f in ("decade",):
        out = (Y.astype(np.int64) + 1970) // 10
    elif f in ("century",):
        out = (Y.astype(np.int64) + 1970 + 99) // 100
    else:
        raise ExecutionError(f"unsupported date_part field: {field!r}")
    return np.where(nat, np.nan, out.astype(np.float64))


def _date_trunc_vec(field: str, a: np.ndarray) -> np.ndarray:
    f = str(field).lower()
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.datetime64):
        a = _coerce_datetime(a, np.dtype("datetime64[us]"))
    a = a.astype("datetime64[us]")
    nat = np.isnat(a)
    safe = np.where(nat, np.datetime64(0, "us"), a)
    unit = {
        "year": "Y", "month": "M", "day": "D",
        "hour": "h", "minute": "m", "second": "s",
        "millisecond": "ms", "microsecond": "us",
    }.get(f)
    if unit is not None:
        out = safe.astype(f"datetime64[{unit}]").astype("datetime64[us]")
    elif f == "week":  # truncate to Monday (ISO)
        D = safe.astype("datetime64[D]")
        out = (
            D - ((D.astype(np.int64) + 3) % 7).astype("timedelta64[D]")
        ).astype("datetime64[us]")
    elif f == "quarter":
        Y = safe.astype("datetime64[Y]")
        M = safe.astype("datetime64[M]")
        q0 = Y.astype("datetime64[M]") + (
            ((M - Y).astype(np.int64) // 3) * 3
        ).astype("timedelta64[M]")
        out = q0.astype("datetime64[us]")
    else:
        raise ExecutionError(f"unsupported date_trunc field: {field!r}")
    return np.where(nat, np.datetime64("NaT", "us"), out)


@dataclasses.dataclass(frozen=True)
class ScalarFuncExpr(PhysicalExpr):
    """Vectorized scalar SQL function (the reference inherits DataFusion's
    scalar library; this covers the commonly used subset — see docs/SQL.md)."""

    name: str
    args: tuple

    def eval(self, cols, num_rows):
        name = self.name
        if name in _ARROW_FAST_NAMES:
            fast = _arrow_string_fast(name, self.args, cols, num_rows)
            if fast is not None:
                return fast
        vals = [a.eval(cols, num_rows) for a in self.args]
        if name == "isnull":
            return _null_mask(np.asarray(vals[0]))
        if name in _NUMERIC_FUNCS:
            with np.errstate(invalid="ignore", divide="ignore"):
                return _NUMERIC_FUNCS[name](np.asarray(vals[0], dtype=np.float64))
        if name == "round":
            if len(vals) > 1:
                darr = np.asarray(vals[1])
                d = int(darr.flat[0]) if darr.size else 0
            else:
                d = 0
            return np.round(np.asarray(vals[0], dtype=np.float64), d)
        if name in ("power", "pow"):
            with np.errstate(invalid="ignore"):
                return np.power(
                    np.asarray(vals[0], dtype=np.float64),
                    np.asarray(vals[1], dtype=np.float64),
                )
        if name in _STRING_FUNCS:
            return _elementwise(_STRING_FUNCS[name], vals, num_rows)
        if name in ("substr", "substring"):
            return _elementwise(_sql_substr, vals, num_rows)
        if name == "replace":
            return _elementwise(
                lambda s_, a, b: str(s_).replace(str(a), str(b)), vals, num_rows
            )
        if name == "starts_with":
            return _elementwise(
                lambda s_, p: str(s_).startswith(str(p)), vals, num_rows
            )
        if name == "ends_with":
            return _elementwise(
                lambda s_, p: str(s_).endswith(str(p)), vals, num_rows
            )
        if name == "concat":
            # DataFusion concat skips NULL arguments
            def cc(*row):
                return "".join(str(v) for v in row if v is not None and v == v)

            return _elementwise(cc, vals, num_rows, skip_null=False)
        if name in ("coalesce", "ifnull", "nvl"):
            # numeric fast path: NULL rides as NaN, so coalesce is a
            # right-to-left np.where chain.  Gate strictly: timedelta64
            # is np.number but NaT does NOT convert to NaN, and int64
            # above 2^53 would be corrupted by the float chain — those
            # (and object rows) take the exact per-row path.
            arrs = [np.asarray(v) for v in vals]

            def _float_safe(a):
                # timedelta64 subclasses np.signedinteger in numpy's
                # hierarchy but NaT doesn't become NaN — exclude it first
                if np.issubdtype(a.dtype, np.timedelta64) or np.issubdtype(
                    a.dtype, np.datetime64
                ):
                    return False
                if np.issubdtype(a.dtype, np.floating):
                    return True
                if a.dtype == bool:
                    return True
                if np.issubdtype(a.dtype, np.integer):
                    if a.size == 0:
                        return True
                    return (
                        int(a.min()) >= -(2**53) and int(a.max()) <= 2**53
                    )
                return False

            if all(_float_safe(a) for a in arrs):
                if not any(
                    np.issubdtype(a.dtype, np.floating) for a in arrs
                ):
                    # int/bool only: NULLs are unrepresentable, the first
                    # argument wins everywhere and keeps its exact dtype
                    return np.broadcast_to(arrs[0], (num_rows,))
                out = np.broadcast_to(
                    arrs[-1].astype(np.float64, copy=False), (num_rows,)
                )
                for a in reversed(arrs[:-1]):
                    a = np.broadcast_to(
                        a.astype(np.float64, copy=False), (num_rows,)
                    )
                    out = np.where(np.isnan(a), out, a)
                return out

            def co(*row):
                for v in row:
                    if v is not None and v == v:
                        return v
                return None

            return _elementwise(co, vals, num_rows, skip_null=False)
        if name == "nullif":
            return _elementwise(
                lambda a, b: None if a == b else a, vals, num_rows,
                skip_null=False,
            )
        if name in ("greatest", "least"):
            pick = max if name == "greatest" else min
            def gl(*row):
                vv = [v for v in row if v is not None and v == v]
                return pick(vv) if vv else None

            return _elementwise(gl, vals, num_rows, skip_null=False)
        if name in ("trim", "ltrim", "rtrim", "btrim"):
            strip = {
                "trim": str.strip, "btrim": str.strip,
                "ltrim": str.lstrip, "rtrim": str.rstrip,
            }[name]
            return _elementwise(
                lambda s_, chars=None: strip(
                    str(s_), None if chars is None else str(chars)
                ),
                vals, num_rows,
            )
        if name in ("lpad", "rpad"):
            return _elementwise(
                lambda s_, n, fill=" ": _sql_pad(
                    s_, n, fill, left=(name == "lpad")
                ),
                vals, num_rows,
            )
        if name == "split_part":
            return _elementwise(_sql_split_part, vals, num_rows)
        if name == "translate":
            def tr(s_, frm, to):
                frm, to = str(frm), str(to)
                table = {
                    ord(c): (to[i] if i < len(to) else None)
                    for i, c in enumerate(frm)
                }
                return str(s_).translate(table)

            return _elementwise(tr, vals, num_rows)
        if name == "repeat":
            return _elementwise(
                lambda s_, n: str(s_) * max(int(n), 0), vals, num_rows
            )
        if name == "left":
            return _elementwise(_sql_left, vals, num_rows)
        if name == "right":
            return _elementwise(_sql_right, vals, num_rows)
        if name in ("strpos", "instr"):
            return _elementwise(
                lambda s_, sub: str(s_).find(str(sub)) + 1, vals, num_rows
            )
        if name == "concat_ws":
            # NULL separator -> NULL; NULL pieces are skipped (Postgres)
            def cw(sep, *row):
                if sep is None or sep != sep:
                    return None
                return str(sep).join(
                    str(v) for v in row if v is not None and v == v
                )

            return _elementwise(cw, vals, num_rows, skip_null=False)
        if name == "chr":
            return _elementwise(lambda n: chr(int(n)), vals, num_rows)
        if name == "to_hex":
            return _elementwise(lambda n: format(int(n), "x"), vals, num_rows)
        if name == "regexp_like":
            import re as _re

            return _elementwise(
                lambda s_, pat, flags="": bool(
                    _re.search(str(pat), str(s_), _regex_flags(flags))
                ),
                vals, num_rows,
            )
        if name == "regexp_count":
            import re as _re

            return _elementwise(
                lambda s_, pat, flags="": len(
                    _re.findall(str(pat), str(s_), _regex_flags(flags))
                ),
                vals, num_rows,
            )
        if name == "regexp_replace":
            import re as _re

            def rr(s_, pat, rep, flags=""):
                count = 0 if "g" in str(flags) else 1
                return _re.sub(
                    str(pat), str(rep), str(s_),
                    count=count, flags=_regex_flags(flags),
                )

            return _elementwise(rr, vals, num_rows)
        if name == "atan2":
            with np.errstate(invalid="ignore"):
                return np.arctan2(
                    np.asarray(vals[0], np.float64),
                    np.asarray(vals[1], np.float64),
                )
        if name == "log":
            # log(x) = log10(x); log(base, x) = log(x)/log(base) (DataFusion)
            with np.errstate(invalid="ignore", divide="ignore"):
                if len(vals) == 1:
                    return np.log10(np.asarray(vals[0], np.float64))
                return np.log(np.asarray(vals[1], np.float64)) / np.log(
                    np.asarray(vals[0], np.float64)
                )
        if name == "pi":
            return np.full(num_rows, np.pi)
        if name == "factorial":
            import math as _math

            return _elementwise(
                lambda v: _math.factorial(int(v)), vals, num_rows
            )
        if name in ("gcd", "lcm"):
            import math as _math

            f = _math.gcd if name == "gcd" else _math.lcm
            return _elementwise(
                lambda a, b2: f(int(a), int(b2)), vals, num_rows
            )
        if name == "isnan":
            # engine NaN means NULL, so isnan(NULL-bearing) is NULL-prop;
            # true NaN can only arrive via float columns holding inf-inf
            # etc. — report False for real values (matches our NULL model)
            a = np.asarray(vals[0])
            nulls = _null_mask(a)
            out = np.zeros(a.shape, dtype=object)
            out[...] = False
            out[nulls] = None
            return out
        if name == "iszero":
            return _elementwise(lambda v: float(v) == 0.0, vals, num_rows)
        if name == "nanvl":
            # NaN (engine NULL) in x -> y
            def nv(a, b2):
                return b2 if a is None or a != a else a

            return _elementwise(nv, vals, num_rows, skip_null=False)
        if name in ("make_array", "array"):
            if not vals:
                out = np.empty(num_rows, dtype=object)
                for i in range(num_rows):
                    out[i] = []
                return out
            return _elementwise(
                lambda *row: [
                    None if (isinstance(v, float) and v != v) else _unbox_py(v)
                    for v in row
                ],
                vals, num_rows, skip_null=False, boxed=True,
            )
        if name in ("array_length", "cardinality"):
            def alen(v):
                lst = _as_list(v)
                return None if lst is None else len(lst)

            return _elementwise(alen, vals, num_rows, skip_null=False)
        if name in ("array_element", "list_element"):
            def elem(v, i):
                if isinstance(v, dict):  # struct['field'] access
                    return v.get(str(i))
                lst = _as_list(v)
                if lst is None or i is None or (
                    isinstance(i, float) and i != i
                ):
                    return None
                i = int(i)
                if i < 0:  # negative indexes count from the end (DataFusion)
                    i += len(lst) + 1
                return lst[i - 1] if 1 <= i <= len(lst) else None

            return _elementwise(elem, vals, num_rows, skip_null=False)
        if name in ("array_contains", "array_has"):
            def has(v, x):
                lst = _as_list(v)
                return None if lst is None else _unbox_py(x) in lst

            return _elementwise(has, vals, num_rows)
        if name == "array_position":
            def apos(v, x):
                lst = _as_list(v)
                if lst is None:
                    return None
                x = _unbox_py(x)
                return lst.index(x) + 1 if x in lst else None

            return _elementwise(apos, vals, num_rows)
        if name in ("array_to_string", "array_join", "list_join"):
            def a2s(v, sep, null_str=None):
                lst = _as_list(v)
                if lst is None:
                    return None
                parts = []
                for x in lst:
                    if x is None or (isinstance(x, float) and x != x):
                        if null_str is not None:
                            parts.append(str(null_str))
                    else:
                        parts.append(_sql_str(x))
                return str(sep).join(parts)

            return _elementwise(a2s, vals, num_rows)
        if name == "string_to_array":
            def s2a(s_, sep, null_str=None):
                parts = str(s_).split(str(sep)) if str(sep) else [str(s_)]
                if null_str is not None:
                    return [None if p == str(null_str) else p for p in parts]
                return parts

            return _elementwise(s2a, vals, num_rows, boxed=True)
        if name == "version":
            from sequila_tpu_torch import __version__

            return np.full(
                num_rows, f"sequila-tpu {__version__}", dtype=object
            )
        if name in ("now", "current_timestamp"):
            return np.full(num_rows, np.datetime64("now", "us"))
        if name in ("current_date", "today"):
            return np.full(
                num_rows, np.datetime64("now", "us").astype("datetime64[D]")
            )
        if name == "current_time":
            import datetime as _dt

            return np.full(
                num_rows,
                _dt.datetime.now(_dt.timezone.utc).strftime("%H:%M:%S"),
                dtype=object,
            )
        if name == "to_timestamp":
            a = np.asarray(vals[0])
            if np.issubdtype(a.dtype, np.number):
                nulls = _null_mask(a)
                out = (
                    np.where(nulls, 0, a).astype(np.float64) * 1e6
                ).astype("datetime64[us]")
                return np.where(nulls, np.datetime64("NaT", "us"), out)
            return _coerce_datetime(a, np.dtype("datetime64[us]"))
        if name == "to_date":
            return _coerce_datetime(
                np.asarray(vals[0]), np.dtype("datetime64[D]")
            )
        if name in ("date_part", "datepart"):
            f = self.args[0]
            if not isinstance(f, Literal):
                raise ExecutionError("date_part field must be a literal")
            return _date_part_vec(f.value, vals[1])
        if name in ("date_trunc", "datetrunc"):
            f = self.args[0]
            if not isinstance(f, Literal):
                raise ExecutionError("date_trunc field must be a literal")
            return _date_trunc_vec(f.value, vals[1])
        if name == "random":
            return np.random.random(num_rows)
        if name == "mod":
            # sign follows the dividend (C fmod — sqlite/DataFusion mod);
            # mod-by-zero is NaN, i.e. SQL NULL
            with np.errstate(invalid="ignore", divide="ignore"):
                return np.fmod(
                    np.asarray(vals[0], np.float64),
                    np.asarray(vals[1], np.float64),
                )
        if name == "uuid":
            import uuid as _uuid

            return np.array(
                [str(_uuid.uuid4()) for _ in range(num_rows)], dtype=object
            )
        if name == "nvl2":
            def n2(a, b2, c):
                return c if (a is None or a != a) else b2

            return _elementwise(n2, vals, num_rows, skip_null=False)
        if name == "contains":
            return _elementwise(
                lambda s_, sub: str(sub) in str(s_), vals, num_rows
            )
        if name == "find_in_set":
            def fis(s_, lst):
                s_ = str(s_)
                if "," in s_:  # MySQL: needle containing a comma -> 0
                    return 0
                parts = str(lst).split(",")
                return parts.index(s_) + 1 if s_ in parts else 0

            return _elementwise(fis, vals, num_rows)
        if name == "levenshtein":
            return _elementwise(_levenshtein, vals, num_rows)
        if name == "substr_index":
            return _elementwise(_substr_index, vals, num_rows)
        if name == "regexp_match":
            import re as _re

            def rm(s_, pat, flags=""):
                m = _re.search(str(pat), str(s_), _regex_flags(flags))
                if m is None:
                    return None
                return list(m.groups()) if m.groups() else [m.group(0)]

            return _elementwise(rm, vals, num_rows, boxed=True)
        if name == "from_unixtime":
            a = np.asarray(vals[0])
            nulls = _null_mask(a)
            out = (
                np.where(nulls, 0, a).astype(np.float64) * 1e6
            ).astype("datetime64[us]")
            return np.where(nulls, np.datetime64("NaT", "us"), out)
        if name == "to_unixtime":
            a = np.asarray(vals[0])
            if not np.issubdtype(a.dtype, np.datetime64):
                a = _coerce_datetime(a, np.dtype("datetime64[us]"))
            a = a.astype("datetime64[us]")
            nat = np.isnat(a)
            secs = (
                np.where(nat, 0, a.astype(np.int64)) // 1_000_000
            ).astype(np.float64)
            return np.where(nat, np.nan, secs)
        if name == "to_local_time":
            # the engine is timezone-naive (UTC) end to end: identity
            a = np.asarray(vals[0])
            if np.issubdtype(a.dtype, np.datetime64):
                return a
            return _coerce_datetime(a, np.dtype("datetime64[us]"))
        if name == "make_date":
            import datetime as _dt

            def md(y, m, d):
                try:
                    return _dt.date(int(y), int(m), int(d)).isoformat()
                except ValueError as exc:
                    raise ExecutionError(f"make_date: {exc}") from exc

            out = _elementwise(md, vals, num_rows)
            return np.array(
                [np.datetime64("NaT", "D") if v is None else np.datetime64(v)
                 for v in out],
                dtype="datetime64[D]",
            )
        if name in ("to_char", "date_format"):
            def tc(v, fmt):
                if isinstance(v, np.datetime64):
                    if np.isnat(v):
                        return None
                    return v.astype("datetime64[us]").item().strftime(str(fmt))
                if isinstance(v, np.timedelta64):
                    return str(v)
                try:
                    return (
                        np.datetime64(str(v), "us").item().strftime(str(fmt))
                    )
                except ValueError as exc:
                    raise ExecutionError(
                        f"to_char: cannot format {v!r}: {exc}"
                    ) from exc

            return _elementwise(tc, vals, num_rows)
        if name == "date_bin":
            stride = np.asarray(vals[0])
            if not np.issubdtype(stride.dtype, np.timedelta64):
                raise ExecutionError("date_bin stride must be an INTERVAL")
            sv = int(stride.ravel()[0].astype("timedelta64[us]").astype(np.int64))
            if sv == 0:
                raise ExecutionError("date_bin stride cannot be zero")
            src = np.asarray(vals[1])
            if not np.issubdtype(src.dtype, np.datetime64):
                src = _coerce_datetime(src, np.dtype("datetime64[us]"))
            src = src.astype("datetime64[us]")
            if len(vals) > 2:
                origin = np.asarray(vals[2])
                if not np.issubdtype(origin.dtype, np.datetime64):
                    origin = _coerce_datetime(
                        origin, np.dtype("datetime64[us]")
                    )
                o64 = int(origin.astype("datetime64[us]").ravel()[0].astype(np.int64))
            else:
                o64 = 0
            nat = np.isnat(src)
            s64 = np.where(nat, np.datetime64(0, "us"), src).astype(np.int64)
            binned = ((s64 - o64) // sv) * sv + o64  # floor handles pre-origin
            out = binned.astype("datetime64[us]")
            return np.where(nat, np.datetime64("NaT", "us"), out)
        if name == "digest":
            import hashlib as _hl

            def dg(s_, algo):
                a = str(algo).lower()
                try:
                    return _hl.new(a, str(s_).encode("utf-8")).hexdigest()
                except ValueError as exc:
                    raise ExecutionError(
                        f"digest: unsupported algorithm {algo!r}"
                    ) from exc

            return _elementwise(dg, vals, num_rows)
        if name == "encode":
            import base64 as _b64

            def enc(s_, fmt):
                b = (
                    s_.encode("utf-8") if isinstance(s_, str)
                    else bytes(s_) if isinstance(s_, (bytes, bytearray))
                    else str(s_).encode("utf-8")
                )
                f = str(fmt).lower()
                if f == "hex":
                    return b.hex()
                if f == "base64":  # DataFusion uses unpadded standard base64
                    return _b64.b64encode(b).decode("ascii").rstrip("=")
                raise ExecutionError(f"encode: unsupported format {fmt!r}")

            return _elementwise(enc, vals, num_rows)
        if name == "decode":
            import base64 as _b64

            def dec(s_, fmt):
                f = str(fmt).lower()
                try:
                    if f == "hex":
                        b = bytes.fromhex(str(s_))
                    elif f == "base64":
                        t = str(s_)
                        b = _b64.b64decode(t + "=" * (-len(t) % 4))
                    else:
                        raise ExecutionError(
                            f"decode: unsupported format {fmt!r}"
                        )
                except (ValueError, _b64.binascii.Error) as exc:
                    raise ExecutionError(f"decode: {exc}") from exc
                return b.decode("utf-8", "replace")

            return _elementwise(dec, vals, num_rows)
        if name in _ARRAY_FUNC_IMPLS:
            return _elementwise(
                _ARRAY_FUNC_IMPLS[name], vals, num_rows,
                skip_null=False, boxed=True,
            )
        if name == "map":
            # map(keys_array, values_array) -> dict cell
            def mkm(ks, vs):
                kl, vl = _as_list(ks), _as_list(vs)
                if kl is None or vl is None:
                    return None
                if len(kl) != len(vl):
                    raise ExecutionError(
                        "map: keys and values must have the same length"
                    )
                return {_cellv(k): _cellv(v) for k, v in zip(kl, vl)}

            return _elementwise(mkm, vals, num_rows, skip_null=False, boxed=True)
        if name == "make_map":
            # make_map(k1, v1, k2, v2, ...)
            if len(vals) % 2 != 0:
                raise ExecutionError("make_map takes (key, value) pairs")

            def mkm2(*row):
                return {
                    _cellv(row[i]): _cellv(row[i + 1])
                    for i in range(0, len(row), 2)
                }

            return _elementwise(mkm2, vals, num_rows, skip_null=False, boxed=True)
        if name in ("map_keys", "map_values"):
            which = 0 if name == "map_keys" else 1

            def mk(v):
                if not isinstance(v, dict):
                    return None
                return list(v.keys() if which == 0 else v.values())

            return _elementwise(mk, vals, num_rows, skip_null=False, boxed=True)
        if name == "map_extract":
            # DataFusion returns a list: [value] on hit, [] on miss
            def mx(v, k):
                if not isinstance(v, dict):
                    return None
                k = _cellv(k)
                return [v[k]] if k in v else []

            return _elementwise(mx, vals, num_rows, skip_null=False, boxed=True)
        if name == "map_contains_key":
            def mc(v, k):
                if not isinstance(v, dict):
                    return None
                return _cellv(k) in v

            return _elementwise(mc, vals, num_rows, skip_null=False, boxed=True)
        if name in ("struct", "row"):
            # positional fields are named c0..cN (DataFusion convention)
            def mk(*row):
                return {
                    f"c{i}": (
                        None if (isinstance(v, float) and v != v)
                        else _unbox_py(v)
                    )
                    for i, v in enumerate(row)
                }

            return _elementwise(mk, vals, num_rows, skip_null=False, boxed=True)
        if name == "named_struct":
            if len(vals) % 2 != 0:
                raise ExecutionError(
                    "named_struct takes (name, value) pairs"
                )
            for a in self.args[0::2]:
                if not (isinstance(a, Literal) and isinstance(a.value, str)):
                    raise ExecutionError(
                        "named_struct field names must be string literals"
                    )

            def mkn(*row):
                return {
                    str(row[i]): (
                        None
                        if (isinstance(row[i + 1], float) and row[i + 1] != row[i + 1])
                        else _unbox_py(row[i + 1])
                    )
                    for i in range(0, len(row), 2)
                }

            return _elementwise(mkn, vals, num_rows, skip_null=False, boxed=True)
        if name == "get_field":
            def gf(v, k):
                if not isinstance(v, dict):
                    return None
                return v.get(str(k))

            return _elementwise(gf, vals, num_rows, skip_null=False, boxed=True)
        if name == "arrow_typeof":
            # debugging aid: report the evaluated numpy dtype as the
            # closest arrow type name (the engine's columns are arrow-
            # backed but expression temporaries are numpy)
            a = np.asarray(vals[0])
            if a.dtype == object:
                nn = [v for v in a.ravel() if v is not None and v == v]
                t = (
                    "Utf8" if all(isinstance(v, str) for v in nn) and nn
                    else "Null" if not nn else "Utf8"
                )
            elif a.dtype == bool:
                t = "Boolean"
            elif np.issubdtype(a.dtype, np.integer):
                t = "Int64"
            elif np.issubdtype(a.dtype, np.floating):
                # INT columns ride as float once NULLs appear; report the
                # statically inferred type, not the runtime representation
                t = (
                    "Int64"
                    if _expr_is_integer(self.args[0], cols)
                    else "Float64"
                )
            else:
                t = str(a.dtype)
            return np.full(num_rows, t, dtype=object)
        raise ExecutionError(f"unsupported scalar function: {name}")

    def columns(self):
        out = []
        for a in self.args:
            out += a.columns()
        return out

    def display(self):
        return f"{self.name}({', '.join(a.display() for a in self.args)})"

    def transform(self, fn):
        return fn(
            ScalarFuncExpr(self.name, tuple(a.transform(fn) for a in self.args))
        )


@dataclasses.dataclass(frozen=True)
class CaseExpr(PhysicalExpr):
    """CASE WHEN .. THEN .. ELSE .. END: first matching branch wins;
    unmatched rows take the ELSE value (NULL if absent)."""

    whens: tuple  # ((cond_expr, result_expr), ...)
    else_: PhysicalExpr | None

    def eval(self, cols, num_rows):
        taken = np.zeros(num_rows, dtype=bool)
        out = np.full(num_rows, None, dtype=object)
        for cond, res in self.whens:
            c = truth(cond.eval(cols, num_rows))
            pick = c & ~taken
            if pick.any():
                r = np.asarray(res.eval(cols, num_rows))
                vals = (
                    np.broadcast_to(r, (num_rows,)) if r.ndim == 0 else r
                )
                out[pick] = vals[pick]
            taken |= c
        if self.else_ is not None and not taken.all():
            r = np.asarray(self.else_.eval(cols, num_rows))
            vals = np.broadcast_to(r, (num_rows,)) if r.ndim == 0 else r
            out[~taken] = vals[~taken]
        # collapse to a numeric dtype when possible (no Nones, numeric)
        if all(v is not None and not isinstance(v, str) for v in out):
            try:
                return out.astype(np.float64)
            except (TypeError, ValueError):
                pass
        return out

    def columns(self):
        out = []
        for c, r in self.whens:
            out += c.columns() + r.columns()
        if self.else_ is not None:
            out += self.else_.columns()
        return out

    def display(self):
        parts = " ".join(
            f"WHEN {c.display()} THEN {r.display()}" for c, r in self.whens
        )
        if self.else_ is not None:
            parts += f" ELSE {self.else_.display()}"
        return f"CASE {parts} END"

    def transform(self, fn):
        return fn(
            CaseExpr(
                tuple(
                    (c.transform(fn), r.transform(fn)) for c, r in self.whens
                ),
                self.else_.transform(fn) if self.else_ is not None else None,
            )
        )


def _like_regex(pattern: str, case_insensitive: bool):
    import re

    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    # \A..\Z + DOTALL, not ^..$: SQL LIKE wildcards match newlines and a
    # trailing newline is NOT ignored (sqlite- and arrow-verified)
    return re.compile(
        r"\A" + "".join(out) + r"\Z",
        re.DOTALL | (re.IGNORECASE if case_insensitive else 0),
    )


@dataclasses.dataclass(frozen=True)
class LikeExpr(PhysicalExpr):
    """SQL [NOT] LIKE / ILIKE with % and _ wildcards (backslash escapes).
    NULL operands are UNKNOWN (Kleene NaN) so NOT/AND/OR compose
    correctly; truth() excludes UNKNOWN at filter boundaries."""

    child: PhysicalExpr
    pattern: PhysicalExpr
    negated: bool = False
    case_insensitive: bool = False

    def eval(self, cols, num_rows):
        if isinstance(self.pattern, Literal) and isinstance(
            self.pattern.value, str
        ):
            col = _arrow_str_col(cols, self.child)
            if col is not None:
                # arrow's match_like (RE2) agrees with the Python-regex
                # fallback incl. newline cases (sqlite-verified)
                import pyarrow.compute as pc

                out = _arrow_bool_mask(
                    pc.match_like(
                        col,
                        self.pattern.value,
                        ignore_case=self.case_insensitive,
                    )
                )
                if not self.negated:
                    return out
                return (
                    np.logical_not(out) if out.dtype == bool else 1.0 - out
                )
        a = np.asarray(self.child.eval(cols, num_rows))
        p = np.asarray(self.pattern.eval(cols, num_rows))
        nulls = _null_mask(a)
        if p.ndim == 0:
            rx = _like_regex(str(p.item()), self.case_insensitive)
            hits = np.array(
                [
                    np.nan if nn else float(bool(rx.match(str(v))))
                    for v, nn in zip(a, nulls)
                ],
            )
        else:
            pn = _null_mask(p)
            hits = np.array(
                [
                    np.nan
                    if (nn or pnn)
                    else float(
                        bool(
                            _like_regex(str(pv), self.case_insensitive).match(str(v))
                        )
                    )
                    for v, pv, nn, pnn in zip(a, p, nulls, pn)
                ],
            )
        out = 1.0 - hits if self.negated else hits
        if not np.isnan(out).any():
            return out == 1.0
        return out

    def columns(self):
        return self.child.columns() + self.pattern.columns()

    def display(self):
        op = ("NOT " if self.negated else "") + (
            "ILIKE" if self.case_insensitive else "LIKE"
        )
        return f"{self.child.display()} {op} {self.pattern.display()}"

    def transform(self, fn):
        return fn(
            LikeExpr(
                self.child.transform(fn),
                self.pattern.transform(fn),
                self.negated,
                self.case_insensitive,
            )
        )


@dataclasses.dataclass(frozen=True)
class IfNullExpr(PhysicalExpr):
    """COALESCE(child, default-literal) — used by correlated-aggregate
    decorrelation (count over an empty correlation group is 0, not NULL)."""

    child: PhysicalExpr
    default: Any

    def eval(self, cols, num_rows):
        a = np.asarray(self.child.eval(cols, num_rows))
        nulls = _null_mask(a)
        if not nulls.any():
            return a
        if a.dtype == object:
            return np.array(
                [self.default if nn else v for v, nn in zip(a, nulls)],
                dtype=object,
            )
        return np.where(nulls, self.default, a)

    def columns(self):
        return self.child.columns()

    def display(self):
        return f"COALESCE({self.child.display()}, {self.default})"

    def transform(self, fn):
        return fn(IfNullExpr(self.child.transform(fn), self.default))


@dataclasses.dataclass(frozen=True)
class DistinctFromExpr(PhysicalExpr):
    """IS [NOT] DISTINCT FROM: null-safe comparison (two NULLs are NOT
    distinct; a NULL and a value are distinct) — never returns UNKNOWN."""

    left: PhysicalExpr
    right: PhysicalExpr
    negated: bool  # True = IS NOT DISTINCT FROM (null-safe equality)

    def eval(self, cols, num_rows):
        l = np.asarray(self.left.eval(cols, num_rows))
        r = np.asarray(self.right.eval(cols, num_rows))
        l, r = np.broadcast_arrays(l, r)
        ln, rn = _null_mask(l), _null_mask(r)
        if l.dtype == object or r.dtype == object:
            eq = np.array(
                [x == y for x, y in zip(l, r)], dtype=bool
            ) & ~ln & ~rn
        else:
            with np.errstate(invalid="ignore"):
                eq = np.equal(l, r) & ~ln & ~rn
        same = eq | (ln & rn)
        return same if self.negated else ~same

    def columns(self):
        return self.left.columns() + self.right.columns()

    def display(self):
        op = "IS NOT DISTINCT FROM" if self.negated else "IS DISTINCT FROM"
        return f"{self.left.display()} {op} {self.right.display()}"

    def transform(self, fn):
        return fn(
            DistinctFromExpr(
                self.left.transform(fn), self.right.transform(fn), self.negated
            )
        )


# ---------------------------------------------------------------------------
# Join filters
# ---------------------------------------------------------------------------

LEFT, RIGHT = "left", "right"


@dataclasses.dataclass(frozen=True)
class ColumnIndex:
    """Maps a filter-schema column back to (side, source column index).

    Same role as DataFusion's ColumnIndex used by the reference's
    map_column_to_source_schema (intervals.rs:39-65).
    """

    index: int
    side: str  # LEFT | RIGHT


@dataclasses.dataclass(frozen=True)
class JoinFilter:
    """A join filter expression over a compact filter schema."""

    expression: PhysicalExpr
    column_indices: tuple[ColumnIndex, ...]

    def display(self) -> str:
        return self.expression.display()


def map_column_to_source_schema(
    expr: PhysicalExpr, indices: tuple[ColumnIndex, ...]
) -> tuple[PhysicalExpr, str]:
    """Rewrite filter-schema column indices to source-schema indices.

    Enforces the reference's 'exactly one column per sub-expression' rule
    (intervals.rs:39-65): two columns in one comparison operand is an error
    (the reference panics; we raise PlanError).
    """
    sides: list[str] = []

    def rewrite(node):
        if isinstance(node, Column):
            ci = indices[node.index]
            if sides:
                raise PlanError(f"complex sub queries are not supported: {expr.display()}")
            sides.append(ci.side)
            return Column(node.name, ci.index)
        return node

    new = expr.transform(rewrite)
    if not sides:
        raise PlanError(f"no column found in sub expression: {expr.display()}")
    return new, sides[0]
