"""Range-overlap predicate recognition.

Decides whether a join filter is a 2-conjunct interval-overlap predicate and
extracts the four bound expressions (ls, le, rs, re).  Faithful to the
reference parser (reference intervals.rs:71-232):

- the filter must be an AND of exactly two comparisons;
- the 8 accepted orderings of `ls <= re AND le >= rs` (either conjunct may
  be written in either direction, < / <= / > / >= all accepted);
- strict operators normalize to inclusive bounds by rewriting the END
  expression as `end - 1` (intervals.rs:67-69);
- each comparison operand must contain exactly one source column
  (complex sub-expressions raise, mirroring the reference's panic);
- anything else returns None and the join falls back to hash/NLJ.

Semantics contract carried to the kernels: end-inclusive i32 intervals,
overflow on i32 cast is a hard error.
"""

from __future__ import annotations

import dataclasses

from sequila_tpu_torch.errors import PlanError
from sequila_tpu_torch.planner.expr import (
    LEFT,
    RIGHT,
    BinaryExpr,
    JoinFilter,
    Literal,
    PhysicalExpr,
    map_column_to_source_schema,
)


@dataclasses.dataclass(frozen=True)
class ColInterval:
    start: PhysicalExpr
    end: PhysicalExpr


@dataclasses.dataclass(frozen=True)
class ColIntervals:
    left_interval: ColInterval
    right_interval: ColInterval


def _minus_one(expr: PhysicalExpr) -> PhysicalExpr:
    return BinaryExpr(expr, "-", Literal(1))


class _Builder:
    def __init__(self):
        self.ls = self.le = self.rs = self.re = None

    def set(self, name, expr):
        if getattr(self, name) is not None:
            # Same condition supplied twice, e.g. `ls <= re AND ls <= re`:
            # the reference panics ("must not be called twice").
            raise PlanError(f"{name} must not be set twice")
        setattr(self, name, expr)

    def finish(self):
        if None in (self.ls, self.le, self.rs, self.re):
            raise _NotInterval("incomplete interval predicate")
        return ColIntervals(
            ColInterval(self.ls, self.le), ColInterval(self.rs, self.re)
        )


class _NotInterval(Exception):
    pass


def _parse_condition(expr: PhysicalExpr, indices, builder: _Builder) -> None:
    if not isinstance(expr, BinaryExpr) or expr.op not in ("<", "<=", ">", ">="):
        raise _NotInterval(f"unsupported operator in {expr.display() if isinstance(expr, PhysicalExpr) else expr}")
    strict = expr.op in ("<", ">")
    lhs, lhs_side = map_column_to_source_schema(expr.left, indices)
    rhs, rhs_side = map_column_to_source_schema(expr.right, indices)

    if expr.op in ("<", "<="):
        if lhs_side == RIGHT and rhs_side == LEFT:  # rs <= le
            builder.set("rs", lhs)
            builder.set("le", _minus_one(rhs) if strict else rhs)
        elif lhs_side == LEFT and rhs_side == RIGHT:  # ls <= re
            builder.set("ls", lhs)
            builder.set("re", _minus_one(rhs) if strict else rhs)
        else:
            raise _NotInterval("comparison does not span both sides")
    else:  # > / >=
        if lhs_side == RIGHT and rhs_side == LEFT:  # re >= ls
            builder.set("re", _minus_one(lhs) if strict else lhs)
            builder.set("ls", rhs)
        elif lhs_side == LEFT and rhs_side == RIGHT:  # le >= rs
            builder.set("le", _minus_one(lhs) if strict else lhs)
            builder.set("rs", rhs)
        else:
            raise _NotInterval("comparison does not span both sides")


def try_parse(filter_: JoinFilter) -> ColIntervals:
    expr = filter_.expression
    if not isinstance(expr, BinaryExpr) or expr.op != "AND":
        raise _NotInterval("top-level expression is not AND")
    left, right = expr.left, expr.right
    if not isinstance(left, BinaryExpr) or not isinstance(right, BinaryExpr):
        raise _NotInterval("conjuncts are not binary expressions")
    builder = _Builder()
    _parse_condition(left, filter_.column_indices, builder)
    _parse_condition(right, filter_.column_indices, builder)
    return builder.finish()


def parse(filter_: JoinFilter | None) -> ColIntervals | None:
    """Reference `parse` (intervals.rs:30-37): None on any benign mismatch.

    PlanError (complex sub-expression / duplicate bound) propagates — the
    reference panics on those rather than falling back.
    """
    if filter_ is None:
        return None
    try:
        return try_parse(filter_)
    except _NotInterval:
        return None
