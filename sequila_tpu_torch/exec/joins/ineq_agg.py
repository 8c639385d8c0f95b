"""Inequality-correlated scalar aggregates as a prefix-aggregate join.

`outer.x cmp (SELECT agg(v) FROM inner WHERE inner.k < outer.k)` — the
running-aggregate subquery — needs no per-row re-execution: sort the
inner side by k once, take prefix (or suffix) aggregates, and place each
outer row with one vectorized searchsorted.  This is DataFusion's
unsupported-decorrelation corner solved with the same sorted-array
machinery as the interval kernels (sequila-tpu design: ranks are the
only primitive).

Supported: one inequality correlation predicate (<, <=, >, >=) on
numeric keys, aggregates sum/count/avg/min/max with SQL NULL skipping;
empty groups are NULL (count: 0).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.exec.plan import ExecPlan, _LazyCols
from sequila_tpu_torch.models.table import Table
from sequila_tpu_torch.planner.expr import _null_mask

AGG_COL = "__corr_agg"


class PrefixAggJoinExec(ExecPlan):
    """Appends agg(inner rows with inner_key <op> outer_key) per outer row.

    Output schema = outer schema + (None, '__corr_agg').
    """

    def __init__(
        self,
        outer: ExecPlan,
        inner: ExecPlan,
        outer_key,  # PhysicalExpr over outer schema
        inner_key,  # PhysicalExpr over inner schema
        op: str,  # inner_key <op> outer_key, one of < <= > >=
        func: str,
        arg,  # PhysicalExpr over inner schema, or None for count(*)
    ):
        self.children = [outer, inner]
        self.outer_key = outer_key
        self.inner_key = inner_key
        self.op = op
        self.func = func
        self.arg = arg

    def schema(self):
        return self.children[0].schema() + [(None, AGG_COL)]

    def execute(self, ctx):
        outer = self.children[0].execute(ctx)
        inner = self.children[1].execute(ctx)
        n_out = outer.num_rows
        n_in = inner.num_rows

        def numeric(expr, table, n, what):
            raw = np.asarray(expr.eval(_LazyCols(table), n))
            try:
                if raw.dtype == object:
                    return np.array(
                        [np.nan if v is None else float(v) for v in raw]
                    )
                return raw.astype(np.float64)
            except (TypeError, ValueError):
                raise ExecutionError(
                    f"inequality correlation requires a numeric {what}"
                ) from None

        ok = numeric(self.outer_key, outer, n_out, "correlation key")
        ik = numeric(self.inner_key, inner, n_in, "correlation key")
        if self.arg is not None:
            raw = np.asarray(self.arg.eval(_LazyCols(inner), n_in))
            nulls = _null_mask(raw)
            try:
                vals = np.where(
                    nulls, 0.0,
                    raw.astype(np.float64) if raw.dtype != object
                    else np.array([0.0 if x is None else float(x) for x in raw]),
                )
            except (TypeError, ValueError):
                raise ExecutionError(
                    f"{self.func}() with inequality correlation requires a "
                    "numeric argument"
                ) from None
            nn = (~nulls).astype(np.float64)
        else:
            vals = np.ones(n_in)
            nn = np.ones(n_in)
        # NULL inner keys never satisfy the correlation predicate
        knull = np.isnan(ik)
        nn = np.where(knull, 0.0, nn)
        vals = np.where(knull, 0.0, vals)

        order = np.argsort(ik, kind="stable")
        ik_s, vals_s, nn_s = ik[order], vals[order], nn[order]
        # NaN keys sort last; cut them off the prefix domain entirely
        n_real = int(n_in - knull.sum())
        ik_s, vals_s, nn_s = ik_s[:n_real], vals_s[:n_real], nn_s[:n_real]

        # boundary index: how many inner rows satisfy ik <op> ok
        if self.op in ("<", "<="):
            side = "left" if self.op == "<" else "right"
            bound = np.searchsorted(ik_s, ok, side=side)
            prefix = True
        else:  # > or >=: the suffix starting at the boundary
            side = "right" if self.op == ">" else "left"
            bound = np.searchsorted(ik_s, ok, side=side)
            prefix = False
        # NULL outer keys match nothing
        bound = np.where(np.isnan(ok), 0 if prefix else n_real, bound)

        func = self.func
        if func in ("sum", "avg", "count"):
            cs = np.concatenate([[0.0], np.cumsum(vals_s)])
            cn = np.concatenate([[0.0], np.cumsum(nn_s)])
            if prefix:
                tot, cnt = cs[bound], cn[bound]
            else:
                tot, cnt = cs[-1] - cs[bound], cn[-1] - cn[bound]
            if func == "count":
                agg = cnt
            elif func == "avg":
                with np.errstate(invalid="ignore"):
                    agg = tot / np.maximum(cnt, 1)
            else:
                agg = tot
        else:  # min / max: running extremes from the matching end
            acc = np.minimum if func == "min" else np.maximum
            ident = np.inf if func == "min" else -np.inf
            filled = np.where(nn_s > 0, vals_s, ident)
            if prefix:
                run = np.concatenate(
                    [[ident], acc.accumulate(filled) if n_real else []]
                )
                agg = run[bound]
            else:
                run = np.concatenate(
                    [acc.accumulate(filled[::-1])[::-1] if n_real else [], [ident]]
                )
                agg = run[bound]
            cs = np.concatenate([[0.0], np.cumsum(nn_s)])
            cnt = cs[bound] if prefix else cs[-1] - cs[bound]

        if func == "count":
            col = pa.array(agg.astype(np.int64))
        else:
            col = pa.array(agg, mask=cnt == 0)  # empty group -> NULL
        out = Table(outer.arrow.append_column(AGG_COL, col))
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        return out

    def display_line(self):
        return (
            f"PrefixAggJoinExec: {self.func}(..) over "
            f"{self.inner_key.display()} {self.op} {self.outer_key.display()}"
        )

    def with_children(self, children):
        return PrefixAggJoinExec(
            children[0], children[1], self.outer_key, self.inner_key,
            self.op, self.func, self.arg,
        )
