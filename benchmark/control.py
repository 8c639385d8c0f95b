"""The control of a cell's correctness check: the reference put in the
program's place, with every position rounded through float32 (the step
below the exact integer coordinates the configurations state; float32
holds integers exactly only below 2**24).  Its answers go through the
same ``take`` and ``judge`` as the program's, and ``correct`` has to come
out false.

An answer kind (``benchmark/answers/<kind>.py``) brings its control as a
hook, ``control_answer(a, b) -> pyarrow.Table``: the answer worked out by
the reference from the traffic's two ``join`` tables in order, already
rounded here.  So a new kind is one new file.  ``count`` and
``coverage`` keep their controls here, since moving them into their
modules would change files that every run of their cells loads.

    python3 benchmark/control.py --workload <cell> --seed <n> [--queries 3]

Prints each number compared with its limit on standard error and one
JSON line.  It needs no card: the reference is NumPy.
"""

import argparse
import json
import os
import sys

if not __package__:  # run as a script: the checkout's root heads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from benchmark import harness, reference  # noqa: E402


class _Result:
    """What a session call returns, as far as the answers' ``take`` reads."""

    def __init__(self, table: pa.Table):
        self.arrow = table
        self.num_rows = table.num_rows

    def column_np(self, i):
        return self.arrow.column(i).to_numpy()


def control_answer(kind: str, a, b):
    ra, rb = reference.rounded(a), reference.rounded(b)
    hook = getattr(harness.answer_kind(kind), "control_answer", None)
    if hook is not None:
        return _Result(hook(ra, rb))
    if kind == "count":
        n = int(reference.per_row_counts(ra, rb).sum())
        return _Result(pa.table({"count": [n]}))
    if kind == "coverage":
        counts, bases = reference.coverage(ra, rb)
        t = a.arrow().append_column("count", pa.array(counts))
        return _Result(t.append_column("bases", pa.array(bases)))
    raise ValueError(f"no control for answers of kind {kind!r}: "
                     f"benchmark/answers/{kind}.py defines no control_answer(a, b)")


def control_run(name: str, seed: int, queries: int = 3, scale: int = 1,
                root: str = harness.ROOT) -> dict:
    c = harness.cell(name, root)
    inputs = harness.make_inputs(c.config, c.traffic, seed, scale)
    run = harness.Run(c, inputs, seed, False)
    answer = harness.answer_kind(c.traffic["answer"])
    offsets = np.random.default_rng([seed, 2])
    left, right = c.traffic["join"]
    for i in range(queries):
        q = {"i": i}
        tables = dict(inputs.tables)
        if inputs.fresh:
            n = inputs.tables[inputs.fresh].rows
            q["offset"] = int(offsets.integers(0, inputs.pool.rows - n + 1))
            tables[inputs.fresh] = inputs.pool.slice(q["offset"], n)
        q["answer"] = answer.take(control_answer(c.traffic["answer"], tables[left],
                                                 tables[right]), True)
        run.queries.append(q)
    checks = answer.judge(run)
    return {"workload": name, "seed": seed,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--queries", type=int, default=3)
    args = p.parse_args(argv)
    out = control_run(args.workload, args.seed, args.queries)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
