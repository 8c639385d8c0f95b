"""IntervalJoinExec — the engine's flagship operator (PyTorch port, slice 1).

Role-equivalent of the reference's IntervalJoinExec (reference
joins/interval_join.rs:71-594): a build/probe range-overlap join keyed on
equi-columns.  Build side = LEFT, probe side = RIGHT.

This slice of the port carries the count(*) path of
sequila_tpu/exec/joins/interval_join.py:
- below the host threshold, every join (count and materializing inner or
  outer joins) runs on the native C++ host index, as in the JAX package;
- above it, count(*) runs the merge-count backend
  (ops/cuda/merge_count.py) on the operator's torch ``device``: two
  hand-written CUDA rank passes over the tables' cached sorted views, or
  their plain PyTorch versions when the named device is the CPU.

Every other route raises NotImplementedError naming its ROADMAP.md item;
none is rerouted quietly.

Semantics parity contract:
- end-inclusive i32 intervals; strict </> already normalized to `end - 1`
  expressions by the planner (planner/intervals.py);
- i32 cast overflow is a hard error (interval_join.rs:1661-1672);
- probe-side row order is preserved (reference: probe side is always Right
  and its order is maintained, interval_join.rs:210-224).
"""

from __future__ import annotations

import os as _os

import numpy as np
import pyarrow as pa
import torch

from sequila_tpu_torch.config import Algorithm
from sequila_tpu_torch.exec.joins.utils import (
    JOIN_TYPE_DISPLAY,
    display_on,
    finish_join,
    gather_join_output,
    join_schema,
)
from sequila_tpu_torch.exec.plan import ExecPlan
from sequila_tpu_torch.models.table import Table, encode_join_keys
from sequila_tpu_torch.planner.expr import JoinFilter, Literal, PhysicalExpr
from sequila_tpu_torch.planner.intervals import ColIntervals


def _host_threshold() -> int:
    """At or below this many total rows the join runs on the host path
    (NumPy / C++).  SEQUILA_HOST_THRESHOLD=0 forces the device path
    everywhere."""
    return int(_os.environ.get("SEQUILA_HOST_THRESHOLD", 65536))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sequila_tpu_torch yet (ROADMAP.md {item})"
    )


def _eval_keys(exprs: list[PhysicalExpr], table: Table) -> list:
    """Key columns for dictionary encoding; plain Column exprs pass the
    arrow column through untouched (no python-string materialization)."""
    from sequila_tpu_torch.planner.expr import Column

    out = []
    cols = None
    for e in exprs:
        if isinstance(e, Column):
            out.append(table.column(e.index))
        else:
            if cols is None:
                cols = [table.column_np(i) for i in range(len(table.column_names))]
            out.append(np.asarray(e.eval(cols, table.num_rows)))
    return out


def _eval_as_i32(expr: PhysicalExpr, table: Table) -> np.ndarray:
    """Evaluate an interval-bound expression and cast to i32, hard-erroring
    on overflow — the reference's evaluate_as_i32 contract
    (interval_join.rs:1661-1672)."""
    from sequila_tpu_torch.errors import CastOverflowError, ExecutionError
    from sequila_tpu_torch.models.table import I32_MAX, I32_MIN
    from sequila_tpu_torch.planner.expr import Column

    if isinstance(expr, Column):
        # routes through the NULL check + overflow contract in one place
        return table.column_as_i32(expr.index)
    cols = [table.column_np(i) for i in range(len(table.column_names))]
    arr = np.asarray(expr.eval(cols, table.num_rows))
    if arr.dtype == np.int32:
        return arr
    if not (
        np.issubdtype(arr.dtype, np.integer) or np.issubdtype(arr.dtype, np.floating)
    ):
        raise ExecutionError(f"interval bound column has non-numeric type {arr.dtype}")
    if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
        raise ExecutionError(
            "interval bound expression produced NULLs (bounds must be "
            "non-null; filter them out first)"
        )
    a64 = arr.astype(np.int64, copy=False)
    if len(a64) and (a64.min() < I32_MIN or a64.max() > I32_MAX):
        bad = a64[(a64 < I32_MIN) | (a64 > I32_MAX)][0]
        raise CastOverflowError(f"Can't cast value {bad} to type Int32")
    return a64.astype(np.int32)


class IntervalJoinExec(ExecPlan):
    def __init__(
        self,
        left: ExecPlan,
        right: ExecPlan,
        on: list[tuple[PhysicalExpr, PhysicalExpr]],
        filter_: JoinFilter | None,
        intervals: ColIntervals,
        join_type: str = "inner",
        algorithm: Algorithm = Algorithm.COITREES,
        low_memory: bool = False,
        mode: str = "CollectLeft",
        projection: list[int] | None = None,
        projection_names: list[str] | None = None,
        distribution: str = "auto",
        *,
        device,
    ):
        self.children = [left, right]
        self.on = on
        self.filter = filter_
        self.intervals = intervals
        self.join_type = join_type
        self.algorithm = algorithm
        self.low_memory = low_memory
        self.mode = mode
        # Partitioned-mode distribution strategy (auto|hash|shuffle|skew),
        # resolved from the session config at plan time; `auto` picks per
        # query from the key-weight histogram at execute time.
        self.distribution = distribution
        # combined-schema column indices to emit (the reference's
        # projection pushdown, interval_join.rs try_new `projection`):
        # gathers only the needed columns instead of both full tables.
        self.projection = projection
        self.projection_names = projection_names
        # the torch device the count kernels run on; the CPU only when named
        self.device = torch.device(device)

    def schema(self):
        full = join_schema(
            self.join_type, self.children[0].schema(), self.children[1].schema()
        )
        if self.projection is None:
            return full
        names = self.projection_names or [full[i][1] for i in self.projection]
        return [(full[i][0], name) for i, name in zip(self.projection, names)]

    def _gather_views(self, left: Table, right: Table):
        """Column-pruned (zero-copy) views for output assembly, plus the
        post-gather column order.  Pruning happens BEFORE the row gather,
        so unprojected columns are never materialized."""
        if self.projection is None:
            return left, right, None
        nleft = len(left.column_names)
        lids = [i for i in self.projection if i < nleft]
        rids = [i - nleft for i in self.projection if i >= nleft]
        order = []
        li = ri = 0
        for i in self.projection:
            if i < nleft:
                order.append(li)
                li += 1
            else:
                order.append(len(lids) + ri)
                ri += 1
        return left.select(lids), right.select(rids), order

    def _assemble(self, left, right, b_rows, p_rows, left_null=None):
        """Gather one output batch through the pruned views."""
        lv, rv, order = self._gather_views(left, right)
        out = gather_join_output(lv, rv, b_rows, p_rows, left_null)
        if order is not None:
            t = out.arrow.select(order)
            if self.projection_names:
                t = t.rename_columns(self.projection_names)
            out = Table(t)
        return out

    # -- host execution -----------------------------------------------------
    def _execute_host(self, ctx, left: Table, right: Table):
        hidx, rcodes, rs, re = self._host_index(ctx, left, right)
        m = right.num_rows
        with ctx.timer(self.op_id(), "join_time"):
            if self.join_type == "inner":
                if self.low_memory:
                    out = self._host_inner_chunked(
                        ctx, hidx, left, right, rcodes, rs, re
                    )
                else:
                    out = self._fused_host_inner(
                        hidx, left, right, rcodes, rs, re
                    )
                    if out is None:
                        b_rows, p_rows = hidx.pairs(rcodes, rs, re)
                        out = self._assemble(left, right, b_rows, p_rows)
            else:
                b_rows, p_rows = hidx.pairs(rcodes, rs, re)
                out = finish_join(
                    self.join_type, left, right,
                    b_rows.astype(np.int64), p_rows.astype(np.int64),
                )
        ctx.metrics.add(self.op_id(), "output_rows", out.num_rows)
        ctx.metrics.add(self.op_id(), "input_rows", m)
        return out

    def _fused_host_inner(self, hidx, left: Table, right: Table,
                          rcodes, rs, re, offs=None, probe_slice=None):
        """Inner-join output assembled by the fused native emission
        (si_emit_gather): the level runs gather every build column and
        broadcast every probe column DIRECTLY into the output buffers —
        the (build_row, probe_row) index arrays and the per-column take
        never exist (the reference's emit materializes index vectors and
        take-gathers per column, interval_join.rs:1593-1632).  Returns a
        Table, or None when a column shape disqualifies (the pair + take
        path then runs).  Chunked callers pass ``offs`` (exclusive-scan
        offsets for THIS probe slice), already-sliced
        ``rcodes``/``rs``/``re``, and ``probe_slice=(lo, hi)`` so the
        probe SOURCE columns are sliced to match the chunk-local query
        indices."""
        if _os.environ.get("SEQUILA_FUSED_EMIT", "1") == "0":
            return None
        if not hasattr(hidx, "emit_gather"):
            return None  # NumPy fallback index
        lv, rv, order = self._gather_views(left, right)
        lsrc = lv.fused_take_sources()
        rsrc = rv.fused_take_sources()
        if lsrc is None or rsrc is None:
            return None
        (l_cols, l_plans), (r_cols, r_plans) = lsrc, rsrc
        if offs is None:
            _, offs = hidx.counts_offsets(rcodes, rs, re)
        total = int(offs[-1])
        # total == 0 falls through: empty buffers wrap into a schema-
        # correct empty table (returning None would make the fallback
        # re-run the whole counts pass just to emit nothing)
        b_cols, out_specs = [], []
        for ty, src in l_cols:
            out = np.empty(total, src.dtype)
            b_cols.append((src, out))
            out_specs.append((ty, out))
        q_cols = []
        for ty, src in r_cols:
            if probe_slice is not None:
                src = src[probe_slice[0] : probe_slice[1]]
            out = np.empty(total, src.dtype)
            q_cols.append((src, out))
            out_specs.append((ty, out))
        if total:
            wrote = hidx.emit_gather(rcodes, rs, re, offs, b_cols, q_cols)
            assert wrote == total, f"fused emit wrote {wrote} of {total}"
        arrays = [
            pa.Array.from_buffers(ty, total, [None, pa.py_buffer(out)])
            for ty, out in out_specs
        ]
        names = lv.column_names + rv.column_names
        t = pa.Table.from_arrays(arrays, names=names)
        plans = dict(l_plans)
        for i, d in r_plans.items():
            plans[len(l_cols) + i] = d
        if plans:
            from sequila_tpu_torch.models.table import _rewrap_dict_columns

            t = _rewrap_dict_columns(t, plans)
        if order is not None:
            t = t.select(order)
            if self.projection_names:
                t = t.rename_columns(self.projection_names)
        return Table(t)

    def _fused_host_batches(self, hidx, left, right, rcodes, rs, re, cap):
        """Generator of assembled output Tables via the fused emission
        (capped chunks), or None when the shape disqualifies — the
        streaming twin of _fused_host_inner, sharing one counts pass for
        both chunk sizing and emission offsets."""
        if _os.environ.get("SEQUILA_FUSED_EMIT", "1") == "0":
            return None
        if not hasattr(hidx, "emit_gather"):
            return None
        lv, rv, _ = self._gather_views(left, right)
        if lv.fused_take_sources() is None or rv.fused_take_sources() is None:
            return None
        _, cum = hidx.counts_offsets(rcodes, rs, re)

        def gen():
            m = len(rcodes)
            lo = 0
            while lo < m:
                hi = max(
                    int(np.searchsorted(cum, cum[lo] + cap, side="right")) - 1,
                    lo + 1,
                )
                offs_c = cum[lo : hi + 1] - cum[lo]
                if offs_c[-1] > 0:
                    out = self._fused_host_inner(
                        hidx, left, right,
                        rcodes[lo:hi], rs[lo:hi], re[lo:hi], offs=offs_c,
                        probe_slice=(lo, hi),
                    )
                    if out is None:  # safety net; qualification was checked
                        b, p = hidx.pairs_at(
                            rcodes[lo:hi], rs[lo:hi], re[lo:hi], offs_c
                        )
                        out = self._assemble(left, right, b, p + lo)
                    yield out
                lo = hi

        return gen()


    @staticmethod
    def _host_pair_chunks(hidx, rcodes, rs, re, cap: int):
        """Yield (probe_lo, build_rows, probe_rows_local) pair chunks from
        the host index, probe ranges sized so each chunk stays under the
        emission cap (the host twin of the device path's capped-emission
        continuation, reference interval_join.rs:1433-1579)."""
        m = len(rcodes)
        counts = hidx.counts(rcodes, rs, re)
        cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
        emit_at = getattr(hidx, "pairs_at", None)
        lo = 0
        while lo < m:
            # widest probe range whose pair total fits the cap (always
            # advance by at least one probe row)
            hi = int(np.searchsorted(cum, cum[lo] + cap, side="right")) - 1
            hi = max(hi, lo + 1)
            if emit_at is not None:
                # sizing already counted every probe: emit straight at the
                # chunk-local offsets instead of re-counting per chunk
                b_rows, p_rows = emit_at(
                    rcodes[lo:hi], rs[lo:hi], re[lo:hi],
                    cum[lo : hi + 1] - cum[lo],
                )
            else:
                b_rows, p_rows = hidx.pairs(rcodes[lo:hi], rs[lo:hi], re[lo:hi])
            if len(b_rows):
                yield lo, b_rows, p_rows
            lo = hi

    def _host_inner_chunked(self, ctx, hidx, left, right, rcodes, rs, re):
        """Low-memory host emission: concatenation of the capped chunks."""
        cap = max(4 * ctx.config.max_output_batch_size, 1)
        fused = self._fused_host_batches(hidx, left, right, rcodes, rs, re, cap)
        if fused is not None:
            parts = list(fused)
        else:
            parts = [
                self._assemble(left, right, b_rows, p_rows + lo)
                for lo, b_rows, p_rows in self._host_pair_chunks(
                    hidx, rcodes, rs, re, cap
                )
            ]
        if parts:
            return Table(pa.concat_tables([p.arrow for p in parts]))
        return self._assemble(
            left, right, np.empty(0, np.int64), np.empty(0, np.int64)
        )

    def _cached_key_codes(self, left: Table, right: Table):
        """Joint key codes from each table's cached dictionary encoding.

        Single plain-Column keys only; the per-table encodings are cached
        on the Tables, so repeated queries pay one tiny dictionary merge
        plus an O(n) remap instead of re-encoding the columns."""
        from sequila_tpu_torch.planner.expr import Column

        if len(self.on) != 1:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if (
            left.column(l_on.index).null_count
            or right.column(r_on.index).null_count
        ):
            return None  # null keys need the sentinel-code path
        from sequila_tpu_torch.models.table import merge_dictionaries

        def build():
            lcodes, lvals, _ = left.dict_codes(l_on.index)
            rcodes, rvals, _ = right.dict_codes(r_on.index)
            remap_l, remap_r = merge_dictionaries(lvals, rvals)
            return remap_l[lcodes], remap_r[rcodes]

        # the O(n + m) remap gathers are pair-deterministic: memoize so a
        # repeated query against a cached index skips them too
        return left.paired_memo(
            ("jointcodes", l_on.index, r_on.index, id(right)), right, build
        )

    @staticmethod
    def _bound_col_delta(expr, table: Table):
        """(column index, ±int delta) for a bound expr, or None."""
        from sequila_tpu_torch.planner.expr import BinaryExpr, Column, Literal

        if isinstance(expr, Column):
            return expr.index, 0
        if (
            isinstance(expr, BinaryExpr)
            and isinstance(expr.left, Column)
            and isinstance(expr.right, Literal)
            and expr.op in ("+", "-")
            and isinstance(expr.right.value, int)
        ):
            d = expr.right.value
            return expr.left.index, (-d if expr.op == "-" else d)
        return None

    def _sorted_count_inputs(self, left: Table, right: Table):
        """Shared preconditions + cached inputs for the sorted-view count
        backend; None when the plan shape doesn't qualify for BITS over
        cached sorted views."""
        from sequila_tpu_torch.models.table import merge_dictionaries
        from sequila_tpu_torch.planner.expr import Column

        if len(self.on) != 1:
            return None
        if left.num_rows == 0 or right.num_rows == 0:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if left.column(l_on.index).null_count or right.column(r_on.index).null_count:
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        qs_cd = self._bound_col_delta(self.intervals.right_interval.start, right)
        qe_cd = self._bound_col_delta(self.intervals.right_interval.end, right)
        if None in (bs_cd, be_cd, qs_cd, qe_cd):
            return None
        # degenerate probes (qs_adj > qe_adj) and inverted build intervals
        # break BITS: host min-gap checks (cached table statistics)
        if right.min_i32_diff(qe_cd[0], qs_cd[0]) + qe_cd[1] - qs_cd[1] < 0:
            return None
        if left.min_i32_diff(be_cd[0], bs_cd[0]) + be_cd[1] - bs_cd[1] < 0:
            return None

        lcodes, lvals, _ = left.dict_codes(l_on.index)
        rcodes, rvals, _ = right.dict_codes(r_on.index)
        if len(lvals) and len(rvals) and type(lvals[0]) is not type(rvals[0]):
            # merge_dictionaries would str-coerce, breaking the monotone
            # remap the cached sorted views depend on
            return None
        remap_b, remap_q = merge_dictionaries(lvals, rvals)
        return l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd, remap_b, remap_q

    def _merge_sorted_count(self, ctx, left: Table, right: Table):
        """Packed-u32 merge count over cached sorted views on
        ``self.device`` — the count(*) fast path, no device sort (see
        ops/cuda/merge_count.py).  None when the plan shape, the key dtypes
        or the 32-bit span budget disqualify it."""
        from sequila_tpu_torch.ops.cuda import merge_count as mc

        inputs = self._sorted_count_inputs(left, right)
        if inputs is None:
            return None
        l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd, remap_b, remap_q = inputs

        # device C tables are deterministic per (table pair, bound columns,
        # deltas, device): bounded paired memo on the table
        plan = left.paired_memo(
            ("mcount", l_on.index, r_on.index, bs_cd, be_cd, qs_cd, qe_cd,
             str(self.device), id(right)),
            right,
            lambda: self._merge_count_plan(
                left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
                remap_b, remap_q,
            ),
        )
        if plan is None:
            return None
        with ctx.timer(self.op_id(), "join_time"):
            total = int(mc.merge_count_passes(*plan))
        ctx.metrics.add(self.op_id(), "output_rows", total)
        return total

    def _merge_count_plan(
        self, left, right, l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd,
        remap_b, remap_q,
    ):
        """Device argument tuple for merge_count_passes, or None if the
        packing is infeasible (span > 32 bits)."""
        from sequila_tpu_torch.ops.cuda import merge_count as mc

        views = (
            left.per_key_minmax(l_on.index, bs_cd[0]),
            left.per_key_minmax(l_on.index, be_cd[0]),
            right.per_key_minmax(r_on.index, qs_cd[0]),
            right.per_key_minmax(r_on.index, qe_cd[0]),
        )
        deltas = (bs_cd[1], be_cd[1], qs_cd[1], qe_cd[1])
        ctabs = mc.plan_packing(remap_b, remap_q, views, deltas)
        if ctabs is None:
            return None
        c_be, c_qs, c_bs, c_qe = (mc.c_tab_tensor(c, self.device) for c in ctabs)
        # cached sorted views: pass 1 ranks build(k,end) in probe(k,qs);
        # pass 2 ranks build(k,start) in probe(k,qe)
        dev = self.device
        bl_k, bl_v, _, _, _ = left.sorted_interval_view(l_on.index, be_cd[0], dev)
        pq_k, pq_v, _, _, _ = right.sorted_interval_view(r_on.index, qs_cd[0], dev)
        bu_k, bu_v, _, _, _ = left.sorted_interval_view(l_on.index, bs_cd[0], dev)
        pe_k, pe_v, _, _, _ = right.sorted_interval_view(r_on.index, qe_cd[0], dev)
        return (
            bl_k, bl_v, c_be,
            pq_k, pq_v, c_qs,
            bu_k, bu_v, c_bs,
            pe_k, pe_v, c_qe,
        )

    # -- key/bound preparation ---------------------------------------------
    def _prepare(self, ctx, left: Table, right: Table):
        """Host key codes and i32 bounds: ((lcodes, ls, le), rcodes, rs, re)."""
        on = self.on
        synthetic_keys = all(
            isinstance(l, Literal) and isinstance(r, Literal) for l, r in on
        )
        if synthetic_keys:
            # Degenerate no-equi-key join (reference NLJ rewrite path,
            # sequila_physical_planner.rs:127-148): one global key segment.
            lcodes = np.zeros(left.num_rows, np.int32)
            rcodes = np.zeros(right.num_rows, np.int32)
        else:
            codes = self._cached_key_codes(left, right)
            if codes is not None:
                lcodes, rcodes = codes
            else:
                lkeys = _eval_keys([l for l, _ in on], left)
                rkeys = _eval_keys([r for _, r in on], right)
                lcodes, rcodes, _ = encode_join_keys(lkeys, rkeys)
        ls = _eval_as_i32(self.intervals.left_interval.start, left)
        le = _eval_as_i32(self.intervals.left_interval.end, left)
        rs = _eval_as_i32(self.intervals.right_interval.start, right)
        re = _eval_as_i32(self.intervals.right_interval.end, right)
        ctx.metrics.add(self.op_id(), "build_input_rows", left.num_rows)
        # Reserve the index estimate against the memory pool before
        # materializing (the reference's try_grow + size estimate,
        # interval_join.rs:624-660): ~9 int32 arrays over padded rows.
        build_bytes = max(left.num_rows, 1) * 4 * 9
        ctx.memory.try_grow(self.op_id(), build_bytes)
        ctx.metrics.add(self.op_id(), "build_mem_used", build_bytes)
        return (lcodes, ls, le), rcodes, rs, re

    def _index_cache_key(self, left: Table, right: Table):
        """Cache key for the host interval index, or None when the plan
        shape (multi-key, complex exprs, nullable keys) precludes it."""
        from sequila_tpu_torch.planner.expr import Column

        if len(self.on) != 1:
            return None
        l_on, r_on = self.on[0]
        if not (isinstance(l_on, Column) and isinstance(r_on, Column)):
            return None
        if left.column(l_on.index).null_count or right.column(r_on.index).null_count:
            return None
        bs_cd = self._bound_col_delta(self.intervals.left_interval.start, left)
        be_cd = self._bound_col_delta(self.intervals.left_interval.end, left)
        if bs_cd is None or be_cd is None:
            return None
        return ("devindex", l_on.index, r_on.index, bs_cd, be_cd, id(right))

    def _use_host(self, left: Table, right: Table) -> bool:
        return left.num_rows + right.num_rows <= _host_threshold()

    def _host_index(self, ctx, left: Table, right: Table):
        from sequila_tpu_torch.ops.host_join import make_host_index

        index, rcodes, rs, re = self._prepare(ctx, left, right)
        # memoized per table pair: the host index build
        # (native radix sort + level decomposition + hint grids) is
        # pair-deterministic and would dominate small repeated queries
        cache_key = self._index_cache_key(left, right)
        if cache_key is not None:
            def build():
                with ctx.timer(self.op_id(), "build_time"):
                    return make_host_index(*index)

            hidx = left.paired_memo(("hostidx",) + cache_key[1:], right, build)
            return hidx, rcodes, rs, re
        with ctx.timer(self.op_id(), "build_time"):
            hidx = make_host_index(*index)
        return hidx, rcodes, rs, re

    # -- execution ----------------------------------------------------------
    def _check_collect_left(self):
        if self.mode == "Partitioned":
            raise _not_ported("Partitioned mode (target_partitions > 1)", "A9")

    def execute(self, ctx):
        """Materializing join: the host route at or below the threshold."""
        self._check_collect_left()
        if self.algorithm.is_nearest:
            raise _not_ported("the nearest join", "A6")
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        if not self._use_host(left, right):
            raise _not_ported(
                "the materializing interval join above the host threshold", "A3"
            )
        return self._execute_host(ctx, left, right)

    def execute_batches(self, ctx):
        raise _not_ported("streamed interval-join output (sql_batches, COPY)", "A4")

    def count_rows(self, ctx) -> int:
        """Exact output cardinality without materializing pairs — the
        count(*) fast path (the BITS-style count; every databio benchmark
        query is answerable by this alone)."""
        self._check_collect_left()
        left = self.children[0].execute(ctx)
        right = self.children[1].execute(ctx)
        if self.algorithm.is_nearest:
            return right.num_rows
        if self._use_host(left, right):
            hidx, rcodes, rs, re = self._host_index(ctx, left, right)
            total = int(hidx.counts(rcodes, rs, re).sum())
            ctx.metrics.add(self.op_id(), "output_rows", total)
            return total
        backend = _os.environ.get("SEQUILA_COUNT_BACKEND", "merge")
        if backend != "merge":
            raise _not_ported(f"SEQUILA_COUNT_BACKEND={backend}", "A5")
        if left.num_rows == 0 or right.num_rows == 0:
            ctx.metrics.add(self.op_id(), "output_rows", 0)
            return 0
        total = self._merge_sorted_count(ctx, left, right)
        if total is None:
            # the JAX package falls back to its co-sort / level programs for
            # shapes the merge plan declines (multi-column or computed keys,
            # degenerate probes, inverted builds, spans beyond 32 bits)
            raise _not_ported(
                "the co-sort and level count fallbacks for this join shape", "A5"
            )
        return total

    def per_probe_counts(self, ctx, with_table: bool = False):
        raise _not_ported("per-probe counts (CountOverlaps, grouped count)", "A6")

    def statistics(self):
        """Join-cardinality estimate from the children's column statistics
        (the reference's statistics() surface, interval_join.rs:586-593,
        over joins/utils.rs:136-370 estimation): equi-key containment
        estimate x interval-overlap geometric selectivity.  Nearest emits
        exactly one row per probe row, so its estimate is the probe count."""
        from sequila_tpu_torch.exec.statistics import (
            ColumnStatistics,
            Precision,
            Statistics,
            estimate_join_statistics,
            interval_overlap_selectivity,
        )
        from sequila_tpu_torch.planner.expr import Column

        lstat = self.children[0].statistics()
        rstat = self.children[1].statistics()
        if self.algorithm.is_nearest:
            return Statistics(rstat.num_rows.to_inexact(), Precision.absent(), ())
        on = [
            (l.index, r.index)
            for l, r in self.on
            if isinstance(l, Column) and isinstance(r, Column)
        ]

        def col(stats, expr, table_side):
            cd = self._bound_col_delta(expr, table_side)
            if cd is None or cd[0] >= len(stats.column_statistics):
                return ColumnStatistics()
            return stats.column_statistics[cd[0]]

        sel = interval_overlap_selectivity(
            col(lstat, self.intervals.left_interval.start, None),
            col(lstat, self.intervals.left_interval.end, None),
            col(rstat, self.intervals.right_interval.start, None),
            col(rstat, self.intervals.right_interval.end, None),
        )
        return estimate_join_statistics(
            self.join_type, lstat, rstat, on, selectivity=sel
        )

    def display_line(self):
        jt = JOIN_TYPE_DISPLAY[self.join_type]
        mode = self.mode
        if mode == "Partitioned":
            # the configured distribution (reference Partitioned mode's
            # required HashPartitioned distribution display analog); auto
            # resolves per query at execute time — EXPLAIN ANALYZE metrics
            # record the chosen one (distribution_<name>=1)
            mode = f"Partitioned({self.distribution})"
        s = f"IntervalJoinExec: mode={mode}, join_type={jt}, {display_on(self.on)}"
        if self.filter is not None:
            s += f", filter={self.filter.display()}"
        s += f", alg={self.algorithm}"
        if self.projection is not None:
            s += f", projection={self.projection}"
        if self.low_memory:
            s += ", low_memory=true"
        return s

    def with_children(self, children):
        return IntervalJoinExec(
            children[0], children[1], self.on, self.filter, self.intervals,
            self.join_type, self.algorithm, self.low_memory, self.mode,
            self.projection, self.projection_names, self.distribution,
            device=self.device,
        )
