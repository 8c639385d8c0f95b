"""Multi-process dry run of Partitioned mode (the port's counterpart of
tools/multihost_dryrun.py).

Spawns ``--procs`` worker processes joined by one torch.distributed
group (parallel/distributed.initialize): Gloo over localhost on the CPU,
or on cards, Gloo (several ranks may share one card) or NCCL (one card a
rank).  Every worker holds the global tables and runs the JAX tool's
checks on the same seeds over a (procs, local devices) mesh, each shard
owned by one process: the hash-partitioned, collect-left, shuffle and
skew counts, the per-probe counts, and the hash and shuffle pairs, each
held against the brute-force oracles (ops/oracle.py); then the SQL layer
with ``target_partitions = 8``.  Each worker prints one JSON line of its
results (``RESULT {...}``).  The parent exits non-zero if a worker fails,
disagrees with another, or runs past the timeout, and kills the workers
still running then.  It writes no file.

Run from the repository root:

    python -m sequila_tpu_torch.parallel.multihost_dryrun --device cpu
    python -m sequila_tpu_torch.parallel.multihost_dryrun --procs 2 --backend gloo
    python -m sequila_tpu_torch.parallel.multihost_dryrun --procs 4 --backend nccl

The last line is ``MULTIHOST PASSED ...`` or ``MULTIHOST FAILED ...``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Test-only: the rank named here raises inside its first shard program.
FAULT_ENV = "SEQUILA_MH_FAULT_RANK"
SQL_ROWS = 4000
SQL_TARGET = 8
GRACE_S = 30.0


def digest(a) -> str:
    """sha256 of an array's int64 bytes: exact equality of large results."""
    return hashlib.sha256(np.ascontiguousarray(a, np.int64).tobytes()).hexdigest()


def pair_digest(b, p) -> str:
    """Digest of a pair set, sorted by (probe row, build row)."""
    b, p = np.asarray(b, np.int64), np.asarray(p, np.int64)
    order = np.lexsort((b, p))
    return digest(np.stack((p[order], b[order]), 1))


def datasets():
    """The JAX tool's two inputs, from default_rng(7):
    {label: (lk, ls, le, rk, rs, re)}."""
    rng = np.random.default_rng(7)
    out = {}
    for label, n, m, hot in (("toy", 512, 1024, 0.0), ("skewed", 20_000, 30_000, 0.9)):
        lk = rng.integers(0, 16, n).astype(np.int32)
        rk = rng.integers(0, 17, m).astype(np.int32)
        if hot:
            lk[rng.random(n) < hot] = 3
            rk[rng.random(m) < hot] = 3
        ls = rng.integers(0, 100_000, n).astype(np.int32)
        le = ls + rng.integers(0, 500, n).astype(np.int32)
        rs = rng.integers(0, 100_000, m).astype(np.int32)
        re = rs + rng.integers(0, 500, m).astype(np.int32)
        out[label] = (lk, ls, le, rk, rs, re)
    return out


def sql_table(seed: int):
    """One of the JAX tool's SQL tables: SQL_ROWS rows over 8 contigs."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    ctgs = np.array([f"chr{i}" for i in range(8)])
    s = r.integers(0, 50_000, SQL_ROWS)
    return pa.table({
        "contig": ctgs[r.integers(0, 8, SQL_ROWS)],
        "pos_start": s,
        "pos_end": s + r.integers(0, 400, SQL_ROWS),
    })


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def worker(args) -> dict:
    """One rank's checks; returns its results (the same on every rank)."""
    import torch

    from sequila_tpu_torch.ops import interval_join as ij
    from sequila_tpu_torch.ops.oracle import oracle_counts, oracle_pairs
    from sequila_tpu_torch.parallel import distributed, engine
    from sequila_tpu_torch.parallel import partitioned_join as pj
    from sequila_tpu_torch.parallel import shuffle, skew
    from sequila_tpu_torch.parallel.mesh import make_mesh
    from sequila_tpu_torch.session import SessionContext

    rank = args.worker
    distributed.initialize(args.init_method, args.procs, rank, args.backend,
                           device=args.device, timeout_s=args.timeout)
    if os.environ.get(FAULT_ENV) == str(rank):
        def fault(*a, **k):
            raise RuntimeError(f"fault injected on rank {rank} ({FAULT_ENV})")
        ij.counts_from_bounds = fault
    devs, owners = engine.global_devices(torch.device(args.device))
    mesh = make_mesh(devs, part=args.procs, owners=owners)
    print(f"rank {rank}: {mesh}", flush=True)
    results = {"mesh": mesh.shape, "owners": mesh.owners.tolist()}
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    for label, cols in datasets().items():
        oc = timed("oracle", oracle_counts, *cols).astype(np.int64)
        want = int(oc.sum())
        want_pairs = pair_digest(*timed("oracle", oracle_pairs, *cols))
        got = {
            "partitioned": timed("partitioned", pj.partitioned_count, mesh, *cols),
            "collect_left": timed("collect_left", pj.collect_left_count, mesh, *cols),
            "shuffle": timed("shuffle", shuffle.all_to_all_partitioned_count, mesh, *cols),
            "skew": timed("skew", skew.skew_partitioned_count_mesh, mesh, *cols),
        }
        for name, n in got.items():
            _check(n == want, f"{label}: {name} count {n} != oracle {want}")
        pc = timed("probe_counts", pj.partitioned_probe_counts, mesh, *cols)
        _check(np.array_equal(pc, oc), f"{label}: per-probe counts differ from the oracle")
        b, p = timed("pairs", pj.partitioned_pairs, mesh, *cols)
        _check(pair_digest(b, p) == want_pairs, f"{label}: hash pairs differ from the oracle")
        b2, p2 = timed("shuffle_pairs", shuffle.all_to_all_partitioned_pairs, mesh, *cols)
        _check(pair_digest(b2, p2) == want_pairs, f"{label}: shuffle pairs differ from the oracle")
        results[label] = {**got, "rows": want, "pairs": len(b), "probe_counts": digest(pc),
                          "pair_set": pair_digest(b, p), "shuffle_pair_set": pair_digest(b2, p2)}
        print(f"rank {rank}: {label} OK count={want} pairs={len(b)}", flush=True)

    t0 = time.perf_counter()
    ctx = SessionContext(device=args.device)
    ctx.register_table("s1", sql_table(1))
    ctx.register_table("s2", sql_table(2))
    ctx.sql(f"SET datafusion.execution.target_partitions = {SQL_TARGET}")
    q = ("SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
         "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
    plan = "\n".join(str(r) for r in ctx.sql("EXPLAIN " + q).to_pylist())
    _check("Partitioned" in plan, f"EXPLAIN shows no Partitioned join:\n{plan}")
    sql_count = int(ctx.sql(q).column_np(0)[0])
    mat_rows = ctx.sql(q.replace("count(1)", "*")).num_rows
    _check(mat_rows == sql_count, f"SELECT * gave {mat_rows} rows, count(1) {sql_count}")
    ctx.sql("SET datafusion.execution.target_partitions = 1")
    single = int(ctx.sql(q).column_np(0)[0])
    _check(single == sql_count, f"target_partitions = 1 counts {single}, partitioned {sql_count}")
    results["sql_partitioned"] = {"rows": sql_count, "n": SQL_ROWS, "m": SQL_ROWS,
                                  "engine_mesh": engine.get_engine_mesh(SQL_TARGET, args.device).shape}
    seconds["sql"] = time.perf_counter() - t0
    print(f"rank {rank}: SQL Partitioned OK rows={sql_count}", flush=True)
    results["seconds"] = seconds
    return results


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(args) -> dict:
    """The workers' environment: ``--local-devices`` host devices on the
    CPU, whatever the parent's XLA_FLAGS say, and the host's cores split
    among the ranks unless OMP_NUM_THREADS is set."""
    env = dict(os.environ)
    # the ranks share the host's cores: torch's threads split among them
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.procs)))
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count={args.local_devices}".strip()
    return env


def run_ranks(cmds, timeout_s: float, **popen) -> list[tuple[int, list[str], bool]]:
    """Run one process per command and wait for all of them.  Once one
    fails, the others get GRACE_S to fail as well (a failing rank makes
    its peers raise, parallel/distributed.agree); after that, or past
    ``timeout_s``, the ones still running are killed.  Returns each
    process's (return code, output lines, killed)."""
    procs, logs, readers = [], [], []
    deadline = time.monotonic() + timeout_s
    failed_at = None
    try:
        for cmd in cmds:
            p = subprocess.Popen(cmd, text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, **popen)
            log = []
            readers.append(threading.Thread(target=log.extend, args=(p.stdout,), daemon=True))
            readers[-1].start()
            procs.append(p)
            logs.append(log)
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + GRACE_S):
                break
            time.sleep(0.1)
    finally:
        killed = [p.poll() is None for p in procs]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=5)
    return [(p.returncode, log, k) for p, log, k in zip(procs, logs, killed)]


def parent(args) -> int:
    t0 = time.perf_counter()
    init = args.init_method or f"tcp://127.0.0.1:{free_port()}"
    cmd = [sys.executable, "-m", "sequila_tpu_torch.parallel.multihost_dryrun",
           "--procs", str(args.procs), "--local-devices", str(args.local_devices),
           "--device", args.device, "--init-method", init, "--timeout", str(args.timeout)]
    if args.backend:
        cmd += ["--backend", args.backend]
    ranks = run_ranks([cmd + ["--worker", str(r)] for r in range(args.procs)], args.timeout,
                      cwd=ROOT, env=child_env(args))
    results, rc = [], 0
    for r, (code, log, killed) in enumerate(ranks):
        tail = "".join(log[-12:]).rstrip()
        print(f"--- worker {r} (rc={code}{', killed' if killed else ''}) ---\n{tail}")
        lines = [ln for ln in log if ln.startswith("RESULT ")]
        if code != 0 or not lines:
            rc = 1
            continue
        results.append(json.loads(lines[-1][len("RESULT "):]))
    checks = [{k: v for k, v in res.items() if k not in ("rank", "collectives", "seconds")}
              for res in results]
    if rc == 0 and any(c != checks[0] for c in checks):
        print("the workers' results differ")
        rc = 1
    dt = time.perf_counter() - t0
    if rc:
        print(f"MULTIHOST FAILED in {dt:.1f} s")
    else:
        print(json.dumps(results[0]))
        print(f"MULTIHOST PASSED: {args.procs} ranks agree ({args.device}, "
              f"{args.backend or 'default backend'}) in {dt:.1f} s")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="host devices a CPU rank contributes (a CUDA rank owns one card)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (tcp://host:port or file://path); default: a free "
                         "localhost port")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the whole run, and for each collective")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is None:
        return parent(args)
    from sequila_tpu_torch.parallel import distributed

    try:
        res = worker(args)
        res["rank"] = args.worker
        res["collectives"] = vars(distributed.STATS)
        print("RESULT " + json.dumps(res), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
