"""Shared join plumbing: pair gathering, filter evaluation, display.


Analog of the reference's joins/utils.rs (metrics, output assembly); the
output of every join is take(left, left_idx) ++ take(right, right_idx)
exactly as the reference's emit paths (interval_join.rs:1338-1420).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.planner.expr import LEFT, JoinFilter, truth

JOIN_TYPE_DISPLAY = {
    "inner": "Inner",
    "left": "Left",
    "right": "Right",
    "full": "Full",
    "leftsemi": "LeftSemi",
    "leftanti": "LeftAnti",
    "rightsemi": "RightSemi",
    "rightanti": "RightAnti",
}


def apply_join_type(
    join_type: str,
    n_left: int,
    n_right: int,
    left_idx: np.ndarray,
    right_idx: np.ndarray,
):
    """Expand inner-match pairs into the requested join type's row set.

    Returns (left_idx, right_idx, left_null, right_null) ready for
    gather_join_output, or ('semi'/'anti', side_rows) for semi/anti joins
    which project a single side.  Mirrors DataFusion's join-type semantics
    that the reference inherits (IntervalJoinExec passes join_type through,
    reference interval_join.rs:210-224)."""
    if join_type == "inner":
        return left_idx, right_idx, None, None
    matched_left = np.zeros(n_left, bool)
    matched_left[left_idx] = True
    matched_right = np.zeros(n_right, bool)
    matched_right[right_idx] = True
    if join_type == "leftsemi":
        return ("rows", "left", np.nonzero(matched_left)[0])
    if join_type == "leftanti":
        return ("rows", "left", np.nonzero(~matched_left)[0])
    if join_type == "rightsemi":
        return ("rows", "right", np.nonzero(matched_right)[0])
    if join_type == "rightanti":
        return ("rows", "right", np.nonzero(~matched_right)[0])

    li = [left_idx]
    ri = [right_idx]
    lnull = [np.zeros(len(left_idx), bool)]
    rnull = [np.zeros(len(right_idx), bool)]
    if join_type in ("left", "full"):
        extra = np.nonzero(~matched_left)[0]
        li.append(extra)
        ri.append(np.zeros(len(extra), np.int64))
        lnull.append(np.zeros(len(extra), bool))
        rnull.append(np.ones(len(extra), bool))
    if join_type in ("right", "full"):
        extra = np.nonzero(~matched_right)[0]
        li.append(np.zeros(len(extra), np.int64))
        ri.append(extra)
        lnull.append(np.ones(len(extra), bool))
        rnull.append(np.zeros(len(extra), bool))
    return (
        np.concatenate(li),
        np.concatenate(ri),
        np.concatenate(lnull),
        np.concatenate(rnull),
    )


def gather_join_output(
    left: Table,
    right: Table,
    left_idx: np.ndarray,
    right_idx: np.ndarray,
    left_null: np.ndarray | None = None,
    right_null: np.ndarray | None = None,
) -> Table:
    lt = left.take(left_idx, left_null)
    rt = right.take(right_idx, right_null)
    arrays = list(lt.arrow.columns) + list(rt.arrow.columns)
    names = lt.column_names + rt.column_names
    return Table(pa.Table.from_arrays(arrays, names=names))


def eval_join_filter(
    filter_: JoinFilter,
    left: Table,
    right: Table,
    left_idx: np.ndarray,
    right_idx: np.ndarray,
) -> np.ndarray:
    """Evaluate a join filter over candidate pairs -> bool mask."""
    cols = []
    for ci in filter_.column_indices:
        if ci.side == LEFT:
            cols.append(left.column_np(ci.index)[left_idx])
        else:
            cols.append(right.column_np(ci.index)[right_idx])
    return np.asarray(
        truth(filter_.expression.eval(cols, len(left_idx))), dtype=bool
    )


def finish_join(join_type, left_t, right_t, left_idx, right_idx):
    """apply_join_type + gather into the output Table."""
    res = apply_join_type(
        join_type, left_t.num_rows, right_t.num_rows, left_idx, right_idx
    )
    if len(res) == 3 and res[0] == "rows":
        _, side, rows = res
        return (left_t if side == "left" else right_t).take(rows)
    li, ri, lnull, rnull = res
    return gather_join_output(left_t, right_t, li, ri, lnull, rnull)


def join_schema(join_type, lschema, rschema):
    if join_type in ("leftsemi", "leftanti"):
        return lschema
    if join_type in ("rightsemi", "rightanti"):
        return rschema
    return lschema + rschema


def display_on(on_pairs) -> str:
    """`on=[(contig@0, contig@0)]` display, `(1, 1)` for the NLJ-synthesized
    literal pair (reference sequila_physical_planner.rs:127-148)."""
    parts = [f"({l.display()}, {r.display()})" for l, r in on_pairs]
    return "on=[" + ", ".join(parts) + "]"
