"""Hash equi-join (vectorized build/probe) — the engine's baseline join.

Role-equivalent of DataFusion's HashJoinExec, which the reference keeps as
the fallback when a join is not an interval join and as the ground-truth
oracle in its test-suite.  Build = dictionary-encode + sort the left keys;
probe = searchsorted segment expansion; residual filter applied on the
candidate pairs.
"""

from __future__ import annotations

import numpy as np

from sequila_tpu_torch.exec.joins.utils import (
    JOIN_TYPE_DISPLAY,
    display_on,
    eval_join_filter,
    finish_join,
    join_schema,
)
from sequila_tpu_torch.exec.plan import ExecPlan
from sequila_tpu_torch.models.table import Table, encode_join_keys
from sequila_tpu_torch.planner.expr import JoinFilter, PhysicalExpr


def equi_join_pairs(
    left: Table,
    right: Table,
    on: list[tuple[PhysicalExpr, PhysicalExpr]],
) -> tuple[np.ndarray, np.ndarray]:
    """All (left_row, right_row) pairs with equal keys, right-major order."""
    from sequila_tpu_torch.exec.joins.interval_join import _eval_keys

    lkeys = _eval_keys([l for l, _ in on], left)
    rkeys = _eval_keys([r for _, r in on], right)
    lcodes, rcodes, _ = encode_join_keys(lkeys, rkeys)
    # sort/search/expand through the threaded native kernels at scale
    # (exec.plan helpers fall back to numpy when native is unavailable)
    from sequila_tpu_torch.exec.plan import _stable_argsort_int

    order = _stable_argsort_int(lcodes).astype(np.int64, copy=False)
    sorted_codes = lcodes[order]
    if len(rcodes) >= (1 << 15):
        from sequila_tpu_torch.ops.genomic import _searchsorted_comp

        s64 = sorted_codes.astype(np.int64)
        q64 = rcodes.astype(np.int64)
        lo = _searchsorted_comp(s64, q64, side="left")
        hi = _searchsorted_comp(s64, q64, side="right")
    else:
        lo = np.searchsorted(sorted_codes, rcodes, side="left")
        hi = np.searchsorted(sorted_codes, rcodes, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total >= (1 << 15) and total < 2**31 and len(order) < 2**31:
        from sequila_tpu_torch.native.loader import expand_runs, repeat_counts

        c32 = cnt.astype(np.int32)
        right_idx = repeat_counts(c32, total)
        left_idx = expand_runs(
            lo.astype(np.int32), c32, order.astype(np.int32), total
        )
        if right_idx is not None and left_idx is not None:
            return left_idx.astype(np.int64), right_idx.astype(np.int64)
    right_idx = np.repeat(np.arange(len(rcodes), dtype=np.int64), cnt)
    offsets = np.concatenate([[0], np.cumsum(cnt)])
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], cnt)
    left_idx = order[np.repeat(lo, cnt) + within]
    return left_idx, right_idx


class HashJoinExec(ExecPlan):
    def __init__(
        self,
        left: ExecPlan,
        right: ExecPlan,
        on: list[tuple[PhysicalExpr, PhysicalExpr]],
        filter_: JoinFilter | None,
        join_type: str = "inner",
        mode: str = "CollectLeft",
    ):
        self.children = [left, right]
        self.on = on
        self.filter = filter_
        self.join_type = join_type
        self.mode = mode

    def schema(self):
        return join_schema(
            self.join_type, self.children[0].schema(), self.children[1].schema()
        )

    def execute(self, ctx):
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        with ctx.timer(self.op_id(), "join_time"):
            left_idx, right_idx = equi_join_pairs(left, right, self.on)
            if self.filter is not None and len(left_idx):
                mask = eval_join_filter(self.filter, left, right, left_idx, right_idx)
                left_idx, right_idx = left_idx[mask], right_idx[mask]
            out = finish_join(self.join_type, left, right, left_idx, right_idx)
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def statistics(self):
        """Equi-key containment cardinality estimate (reference
        joins/utils.rs:estimate_join_statistics)."""
        from sequila_tpu_torch.exec.statistics import estimate_join_statistics
        from sequila_tpu_torch.planner.expr import Column

        on = [
            (l.index, r.index)
            for l, r in self.on
            if isinstance(l, Column) and isinstance(r, Column)
        ]
        est = estimate_join_statistics(
            self.join_type,
            self.children[0].statistics(),
            self.children[1].statistics(),
            on,
        )
        return est.to_inexact() if self.filter is not None else est

    def display_line(self):
        jt = JOIN_TYPE_DISPLAY[self.join_type]
        s = f"HashJoinExec: mode={self.mode}, join_type={jt}, {display_on(self.on)}"
        if self.filter is not None:
            s += f", filter={self.filter.display()}"
        return s

    def with_children(self, children):
        return HashJoinExec(
            children[0], children[1], self.on, self.filter, self.join_type, self.mode
        )
