"""Nested-loop join (chunked cross product + filter) — baseline for joins
with no equi-keys, role-equivalent of DataFusion's NestedLoopJoinExec."""

from __future__ import annotations

import numpy as np

from sequila_tpu_torch.exec.joins.utils import (
    JOIN_TYPE_DISPLAY,
    eval_join_filter,
    finish_join,
    join_schema,
)
from sequila_tpu_torch.exec.plan import ExecPlan
from sequila_tpu_torch.planner.expr import JoinFilter

_CHUNK_PAIRS = 8_000_000


class NestedLoopJoinExec(ExecPlan):
    def __init__(self, left: ExecPlan, right: ExecPlan, filter_: JoinFilter | None, join_type: str = "inner"):
        self.children = [left, right]
        self.filter = filter_
        self.join_type = join_type

    def schema(self):
        return join_schema(
            self.join_type, self.children[0].schema(), self.children[1].schema()
        )

    def execute(self, ctx):
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        n, m = left.num_rows, right.num_rows
        li_parts, ri_parts = [], []
        chunk = max(1, _CHUNK_PAIRS // max(m, 1))
        with ctx.timer(self.op_id(), "join_time"):
            for lo in range(0, n, chunk):
                rows = min(chunk, n - lo)
                li = np.repeat(np.arange(lo, lo + rows, dtype=np.int64), m)
                ri = np.tile(np.arange(m, dtype=np.int64), rows)
                if self.filter is not None:
                    mask = eval_join_filter(self.filter, left, right, li, ri)
                    li, ri = li[mask], ri[mask]
                li_parts.append(li)
                ri_parts.append(ri)
            left_idx = np.concatenate(li_parts) if li_parts else np.empty(0, np.int64)
            right_idx = np.concatenate(ri_parts) if ri_parts else np.empty(0, np.int64)
            out = finish_join(self.join_type, left, right, left_idx, right_idx)
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def statistics(self):
        from sequila_tpu_torch.exec.statistics import estimate_join_statistics

        return estimate_join_statistics(
            self.join_type,
            self.children[0].statistics(),
            self.children[1].statistics(),
            on=[],
        ).to_inexact()

    def display_line(self):
        jt = JOIN_TYPE_DISPLAY[self.join_type]
        s = f"NestedLoopJoinExec: join_type={jt}"
        if self.filter is not None:
            s += f", filter={self.filter.display()}"
        return s

    def with_children(self, children):
        return NestedLoopJoinExec(children[0], children[1], self.filter, self.join_type)
