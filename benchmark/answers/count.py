"""A count(*) of the overlap join of the traffic's two tables.

Every answer of the window is judged: ``count_off`` is the largest gap,
over the queries, between the count the program returned and the
reference's count of the same inputs.
"""

from __future__ import annotations

import numpy as np

from benchmark import reference


def take(result, keep: bool) -> dict:
    """In the window: the count, as a Python int on the host."""
    return {"value": int(result.column_np(0)[0])}


def judge(run) -> dict:
    left, right = run.traffic["join"]
    fresh = run.inputs.fresh
    if fresh is not None and fresh in (left, right):
        # one pass over the pool: each pool row's overlaps with the fixed
        # table, then each query's window is a difference of prefix sums
        fixed = run.inputs.tables[right if fresh == left else left]
        per_row = reference.per_row_counts(run.inputs.pool, fixed)
        prefix = np.concatenate([[0], np.cumsum(per_row)])
        n = run.inputs.tables[fresh].rows
        refs = [int(prefix[q["offset"] + n] - prefix[q["offset"]]) for q in run.queries]
    else:
        total = int(reference.per_row_counts(run.inputs.tables[left],
                                             run.inputs.tables[right]).sum())
        refs = [total] * len(run.queries)
    off = 0
    for q, ref in zip(run.queries, refs):
        q["pairs"] = ref
        if "answer" in q:
            gap = abs(q["answer"]["value"] - ref)
            q["wrong"] = gap != 0
            off = max(off, gap)
    return {"count_off": (off, 0)}
