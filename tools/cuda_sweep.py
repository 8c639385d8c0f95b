"""Drive every device path of the port on the card and hold it to the
host route: the port's counterpart of tools/tpu_sweep.py.

Each check runs one query on ``SessionContext(device="cuda")`` with the
device path forced (SEQUILA_HOST_THRESHOLD=0, read per query), then on
the host route (SEQUILA_HOST_THRESHOLD=100000000), and holds the two
equal.  The device run must report no host route metric and the host run
one (``<kind>_route_host``); the DataFrame verbs must launch B1 on the
device and nothing on the host.

- At the JAX sweep's tables (3,000 x 4,000 rows for SQL, 2,000 x 2,500
  for the verbs, 4 contigs, seeds 1-4), sorted rows, exactly: inner
  ``SELECT *`` under coitrees, intervaltree, lapper and superintervals;
  LEFT, RIGHT and FULL joins; nearest (coitreesnearest); the strict
  operators; the grouped count; ``coverage`` and ``count_overlaps``.
- At the 15M pairing (``gen_chain_table(20_000, 13)`` x
  ``(300_000, 14)``, 14,729,736 rows): the row count and
  chip_smoke.checksum of inner ``SELECT *`` under the four algorithms,
  LEFT and FULL joins and the strict operators; the grouped count's rows.

    python3 tools/cuda_sweep.py

prints one line a check (``OK``/``FAIL``, the query, the algorithm, the
rows) and ``SWEEP PASSED`` or ``SWEEP FAILED``; it exits non-zero on a
failure or without a card.  chip_smoke.py phase 9 calls ``sweep``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DEVICE_ROUTE, HOST_ROUTE = "0", "100000000"
SQL_TABLES = ((3000, 1), (4000, 2))  # (rows, seed) of a and b
VERB_TABLES = ((2000, 3), (2500, 4))
MAT_PAIR = ((20_000, 13), (300_000, 14))
MAT_EXPECTED = 14_729_736
ALGORITHMS = ("coitrees", "intervaltree", "lapper", "superintervals")
JOIN = ("SELECT * FROM a JOIN b ON a.contig = b.contig"
        " AND a.pos_start <= b.pos_end AND a.pos_end >= b.pos_start")
STRICT = JOIN.replace("<=", "<").replace(">=", ">")
GROUPED = ("SELECT a.contig, count(1) AS n FROM a JOIN b ON a.contig = b.contig"
           " AND a.pos_start <= b.pos_end AND a.pos_end >= b.pos_start"
           " GROUP BY a.contig ORDER BY a.contig")


def table(n: int, seed: int, keys: int = 4, span: int = 50_000, ln: int = 800):
    """tools/tpu_sweep.py's tables: n intervals over ``keys`` contigs."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    contigs = [f"chr{k}" for k in r.integers(1, keys + 1, n)]
    s = r.integers(0, span, n)
    return pa.table({"contig": contigs, "pos_start": s, "pos_end": s + r.integers(0, ln, n)})


def rows_of(t) -> list:
    """Every row of a result, NULLs and NaNs marked, sorted."""
    cols = [t.column_np(i).tolist() for i in range(len(t.column_names))]
    return sorted(tuple((v is None or v != v, str(v)) for v in r) for r in zip(*cols))


def group_rows(t) -> list:
    """(contig, count) rows of the grouped count."""
    return sorted(zip(map(str, t.column_np(0)), map(int, t.column_np(1))))


def routes_of(ctx) -> list[str]:
    """The route metrics (``<kind>_route_<name>``) of the session's last
    query."""
    return sorted(k for c in ctx.last_metrics.counters.values() for k in c if "_route_" in k)


class Sweep:
    """The checks of one sweep; ``report`` takes each check's line."""

    def __init__(self, report=print):
        self.report = report
        self.checks: list[tuple] = []  # (name, algorithm, ok, rows)

    def record(self, name, alg, ok, rows, detail="") -> None:
        self.checks.append((name, alg, ok, rows))
        self.report(f"{'OK  ' if ok else 'FAIL'} {name} {alg} rows={rows}"
                    + (f" ({detail})" if detail else ""))

    def both_routes(self, ctx, query, result):
        """``result(ctx.sql(query))`` on the device route, then on the
        host route, with each run's route metrics; a device run that took
        a host route (or a host run that did not) is an error string."""
        out, problems = [], []
        for route in (DEVICE_ROUTE, HOST_ROUTE):
            os.environ["SEQUILA_HOST_THRESHOLD"] = route
            got = result(ctx.sql(query))
            names = routes_of(ctx)
            on_host = any(n.endswith("_route_host") for n in names)
            if not names or on_host != (route == HOST_ROUTE):
                problems.append(f"{'host' if route == HOST_ROUTE else 'device'} run took {names}")
            out.append(got)
        return out[0], out[1], "; ".join(problems)

    def check_sql(self, ctx, name, query, algorithms=("coitrees",), result=rows_of,
                  size=len, want_rows=None) -> None:
        for alg in algorithms:
            ctx.sql(f"SET sequila.interval_join_algorithm = {alg}")
            dev, host, problem = self.both_routes(ctx, query, result)
            rows = size(dev)
            ok = dev == host and not problem and want_rows in (None, rows)
            detail = problem or ("" if dev == host else "device and host differ")
            if want_rows not in (None, rows):
                detail = f"{rows} rows, expected {want_rows}"
            self.record(name, alg, ok, rows, detail)

    def check_verbs(self, a, b, device) -> None:
        from sequila_tpu_torch import dataframe as gdf
        from sequila_tpu_torch.ops.cuda import merge_count as mc

        for name, verb in (("coverage", gdf.coverage), ("count_overlaps", gdf.count_overlaps)):
            out, b1 = [], []
            for route in (DEVICE_ROUTE, HOST_ROUTE):
                os.environ["SEQUILA_HOST_THRESHOLD"] = route
                before = mc.merge_rank_sorted.launches
                out.append(verb(a, b, device=device))
                b1.append(mc.merge_rank_sorted.launches - before)
            dev, host = rows_of(out[0]), rows_of(out[1])
            # kernels launch on the card; on the CPU the plain versions run
            ok = dev == host and (b1[0] > 0) == (device == "cuda") and b1[1] == 0
            detail = "" if ok else f"equal {dev == host}, B1 launches device/host {b1}"
            self.record(name, "-", ok, len(dev), detail)

    def failed(self) -> list[tuple]:
        return [c for c in self.checks if not c[2]]


def session(tables, device):
    from sequila_tpu_torch.session import SessionContext

    ctx = SessionContext(device=device)
    for name, t in zip(("a", "b"), tables):
        ctx.register_table(name, t)
    ctx.sql("SET sequila.prefer_interval_join = true")
    return ctx


def sweep(report=print, device="cuda") -> Sweep:
    """Run every check on ``device``; the SEQUILA_HOST_THRESHOLD the
    caller had is restored."""
    import pyarrow as pa

    from chip_smoke import checksum
    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.models.table import Table

    sw = Sweep(report)
    saved = os.environ.get("SEQUILA_HOST_THRESHOLD")
    try:
        ctx = session([table(n, seed) for n, seed in SQL_TABLES], device)
        sw.check_sql(ctx, "inner SELECT *", JOIN, ALGORITHMS)
        for kind in ("LEFT", "RIGHT", "FULL"):
            sw.check_sql(ctx, f"{kind.lower()} outer", JOIN.replace("JOIN", f"{kind} JOIN"))
        sw.check_sql(ctx, "nearest", JOIN, ("coitreesnearest",))
        sw.check_sql(ctx, "strict ops", STRICT)
        sw.check_sql(ctx, "count group", GROUPED)
        sw.check_verbs(*(Table(table(n, seed)) for n, seed in VERB_TABLES), device)

        (n, seed_l), (m, seed_r) = MAT_PAIR
        ctx = session([pa.table(bd.gen_chain_table(n, seed_l)),
                       pa.table(bd.gen_chain_table(m, seed_r))], device)
        rows_sum = dict(result=lambda t: checksum([t]), size=lambda c: c[0])
        sw.check_sql(ctx, "15M inner SELECT *", JOIN, ALGORITHMS, want_rows=MAT_EXPECTED,
                     **rows_sum)
        for kind in ("LEFT", "FULL"):
            sw.check_sql(ctx, f"15M {kind.lower()} outer", JOIN.replace("JOIN", f"{kind} JOIN"),
                         **rows_sum)
        sw.check_sql(ctx, "15M strict ops", STRICT, **rows_sum)
        sw.check_sql(ctx, "15M count group", GROUPED, result=group_rows,
                     size=lambda r: sum(n for _, n in r), want_rows=MAT_EXPECTED)
    finally:
        if saved is None:
            os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
        else:
            os.environ["SEQUILA_HOST_THRESHOLD"] = saved
    return sw


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: the sweep needs a CUDA device",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    sw = sweep(lambda line: print(line, flush=True))
    bad = sw.failed()
    print(f"SWEEP {'PASSED' if not bad else f'FAILED ({len(bad)})'}: {len(sw.checks)} checks "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
