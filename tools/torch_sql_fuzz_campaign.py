"""Offline differential-fuzz campaign of the port: sweep fresh seed bases.

The port's twin of tools/sql_fuzz_campaign.py.  It runs the sqlite
differential suite through sequila_tpu_torch on the CPU
(tests/test_torch_sql_suite_fuzz_sqlite.py, the JAX package's
tests/test_fuzz_sqlite.py loaded against the port) repeatedly with
SEQUILA_FUZZ_SEED_BASE varied, so every case generates brand-new
queries each round.  Any divergence fails that round's pytest run and
the failing seed base is printed for reproduction:

    python tools/torch_sql_fuzz_campaign.py [rounds] [queries_per_case] [base ...]
    SEQUILA_FUZZ_SEED_BASE=<base> python -m pytest tests/test_torch_sql_suite_fuzz_sqlite.py

With no bases named, round i takes base SEQUILA_FUZZ_CAMPAIGN_START
(default 20000) + 1000 i, as the JAX package's campaign does.
"""

import os
import subprocess
import sys
import time

SUITE = "tests/test_torch_sql_suite_fuzz_sqlite.py"


def main(rounds: int = 10, n_queries: int = 40, bases: list[int] | None = None) -> int:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    t0 = time.time()
    if not bases:
        start = int(os.environ.get("SEQUILA_FUZZ_CAMPAIGN_START", "20000"))
        bases = [start + i * 1000 for i in range(rounds)]
    for base in bases:
        env = dict(
            os.environ,
            SEQUILA_FUZZ_SEED_BASE=str(base),
            SEQUILA_FUZZ_N=str(n_queries),
            JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
        )
        r = subprocess.run(
            [sys.executable, "-m", "pytest", SUITE, "-q", "--no-header", "-x",
             "-p", "no:cacheprovider"],
            cwd=root, env=env, capture_output=True, text=True,
        )
        tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        print(f"base={base}: {tail}", flush=True)
        if r.returncode != 0:
            print(r.stdout[-4000:])
            print(f"DIVERGENCE at SEQUILA_FUZZ_SEED_BASE={base}", flush=True)
            return 1
    print(f"CAMPAIGN PASSED: {len(bases)} rounds x ~21 cases x {n_queries} queries "
          f"in {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    nq = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    sys.exit(main(rounds, nq, [int(b) for b in sys.argv[3:]]))
