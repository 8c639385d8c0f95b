"""``SELECT b.contig, count(1) ... GROUP BY b.contig`` over the overlap join
of the traffic's two tables, ``join`` = [a, b]: one row a contig of ``b``
that has a pair, its name in the first column and its count in the last.
A contig with no pair has no row, as the inner join drops it.

A pair's two rows share their contig, so grouping either table's rows by
their own contig gives the same groups: the reference counts, for each row
of ``b`` (or of the fresh table's pool, where one table is registered
afresh), the rows of the other table that overlap it, and sums those
counts by the row's contig.

Every answer of the window is taken on the host (a few dozen rows) and
judged: ``groups_off`` is the largest count, over the queries, of groups
missing, extra (a name the reference has no pair for, a duplicate, a
null name or count) or misnamed (which counts as one missing and one extra);
``count_off`` is the largest gap of one group's count to the reference's.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from benchmark import reference


def take(result, keep: bool) -> dict:
    """In the window: (group, count) pairs, as Python values on the host."""
    t = result.arrow
    names, counts = t.column(0).to_pylist(), t.column(t.num_columns - 1).to_pylist()
    return {"groups": list(zip(names, counts))}


def _groups(t, per_row) -> dict:
    """{contig name: pairs} of the contigs of ``t`` that have a pair;
    ``per_row`` holds each row's pairs."""
    # float64 sums, exact: every count lies below 2**53
    sums = np.bincount(t.code, weights=per_row, minlength=len(t.names))
    return {t.names[i]: int(sums[i]) for i in np.flatnonzero(sums)}


def _references(run) -> list:
    """The reference's groups for each query of the run."""
    left, right = run.traffic["join"]
    fresh = run.inputs.fresh
    if fresh is not None and fresh in (left, right):
        # one pass over the pool, then each query's window of it
        pool = run.inputs.pool
        per_row = reference.per_row_counts(pool, run.inputs.tables[right if fresh == left
                                                                   else left])
        n = run.inputs.tables[fresh].rows
        return [_groups(pool.slice(q["offset"], n), per_row[q["offset"]:q["offset"] + n])
                for q in run.queries]
    b = run.inputs.tables[right]
    ref = _groups(b, reference.per_row_counts(b, run.inputs.tables[left]))
    return [ref] * len(run.queries)


def _offs(groups: list, ref: dict) -> tuple:
    """(groups missing, extra or misnamed; largest gap of a group's count)."""
    seen, extra, gap = set(), 0, 0
    for name, count in groups:
        if name not in ref or name in seen or count is None:
            extra += 1
            continue
        seen.add(name)
        gap = max(gap, abs(count - ref[name]))
    return len(ref) - len(seen) + extra, gap


def judge(run) -> dict:
    groups_off = count_off = 0
    for q, ref in zip(run.queries, _references(run)):
        q["pairs"] = sum(ref.values())
        if "answer" in q:
            g, c = _offs(q["answer"]["groups"], ref)
            q["wrong"] = g != 0 or c != 0
            groups_off, count_off = max(groups_off, g), max(count_off, c)
    return {"groups_off": (groups_off, 0), "count_off": (count_off, 0)}


def control_answer(a, b) -> pa.Table:
    """The answer, by the reference from ``a`` and ``b`` as given."""
    ref = _groups(b, reference.per_row_counts(b, a))
    return pa.table({"contig": pa.array(list(ref), pa.string()),
                     "count(1)": pa.array(list(ref.values()), pa.int64())})


def alter(table: pa.Table) -> pa.Table:
    """The answer with one group's count one higher."""
    i = table.num_columns - 1
    counts = table.column(i).to_pylist()
    counts[len(counts) // 2] += 1
    return table.set_column(i, table.field(i), pa.array(counts, table.field(i).type))
