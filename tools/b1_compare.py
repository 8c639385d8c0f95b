"""Time the rank kernels B1 (merge_rank_sorted and its callers), B2
(stream_rank_sorted) and B3 (rank_sorted_resident) of several source trees
of sequila_tpu_torch on one NVIDIA GPU, in turns, beside torch.searchsorted.

    python3 tools/b1_compare.py --tree local/parent --tree . --tree . --tree local/parent

Each tree runs in its own process from its own directory (its own kernel
build), in the order given, so a change is compared with its parent on the
same card within one call.  Each prints one JSON line: the card's name and
power limit, and CUDA-event times (ms, means over 20 launches, warm) at the
main path's shapes:
- the genome pair's count(*) (gen_genome_table(2_350_965, 21) x
  (7_684_066, 22)): B1 ranks and reduce on pass 1 (N=7,684,096 packed probe
  starts, M=2,351,104 packed build ends), torch.searchsorted on the same
  values XOR the sign bit (int32), and merge_count_passes whole (4 pack_view
  and the tree's B1 launches), and where the tree has the segmented B1,
  its bare launches (ranks, and both count passes);
- B2 on that pair's stream route (its own host windows): pass u in reduce
  mode through the wrapper, both passes (two wrapper calls, or where the
  tree has stream_count_launcher its one bare launch) and, where the tree
  has the pair merge path, pass u's bare launch; torch.searchsorted over
  int64 composites of pass u; the sums checked against it;
  stream_count_passes whole (its glue included), and the warm count(*)
  query on the merge and stream routes (host clock, medians of 10);
- B3 at its cap (a 2^20-row build, 2,351,104 queries, ranks, both sorted,
  seed 4): the wrapper, the bare launch where the tree has the pair merge
  path, and torch.searchsorted over int64 composites, ranks checked;
- the 15M SELECT * pairing (gen_chain_table(20_000, 13) x (300_000, 14)) on
  the device merge route: merge_level_bounds whole (and the segmented B1's
  bare level launch), and the pairs its bounds hold (14,729,736 when right);
- B1's verb mode on the genome pair in the verbs' direction (the probes
  enriched with the build): merge_verb_rank4 whole, held against
  merge_verb_rank4_plain, and a warm device coverage (host clock, median
  of 20, SEQUILA_HOST_THRESHOLD=0), its counts summing to 99,159,827;
- B1's per-probe mode in that direction: merge_probe_count_passes whole
  (the count_overlaps plan, plan_verb_ranks(want4=False)), its counts
  summing to 99,159,827, a warm device count_overlaps (host clock, median
  of 20) and the warm grouped count ``SELECT b.contig, count(*) ... GROUP
  BY b.contig`` on the merge route (host clock, median of 3, 24 groups);
with the B1, pack_view and un-permute launches of one call of each.  Needs a CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPS = 20


def worker() -> None:
    import pyarrow as pa
    import torch

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.session import SessionContext

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    def launches(fn) -> dict:
        # the un-permute kernels exist from the verb mode's and the
        # per-probe mode's redesigns on; the launches are counters of
        # utils/metrics from the tracing's introduction on, attributes of
        # the wrappers before it
        names = [k for k in ("merge_rank_sorted", "pack_view", "unpermute_ranks",
                             "unpermute_counts") if hasattr(mc, k)]
        try:
            from sequila_tpu_torch.utils.metrics import recording
        except ImportError:
            recording = None
        if recording is None:
            for k in names:
                getattr(mc, k).launches = 0
            fn()
            torch.cuda.synchronize()
            return {k: getattr(mc, k).launches for k in names}
        with recording() as rec:
            fn()
            torch.cuda.synchronize()
        got = rec.counts()
        counter = {"merge_rank_sorted": "launch.merge_path"}
        return {k: got[counter.get(k, f"launch.{k}")] for k in names}

    def session(t1, t2):
        ctx = SessionContext(device="cuda")
        ctx.register_table("s1", pa.table(t1))
        ctx.register_table("s2", pa.table(t2))
        return ctx

    out = {"tree": os.getcwd(), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    genome = bd.gen_genome_table(bd.GENOME_LEFT, 21), bd.gen_genome_table(bd.GENOME_RIGHT, 22)
    ctx = session(*genome)
    ctx.sql(bd.QUERY)
    join = ctx.plan_sql(bd.QUERY).children[0]
    left, right = ctx.table("s1"), ctx.table("s2")
    plan = join._merge_count_plan(left, right, *join._sorted_count_inputs(left, right))
    q1 = mc.pack_view(*plan[0:3], mc.BUILD_PAD)
    a1 = mc.pack_view(*plan[3:6], mc.PROBE_PAD)
    sign = torch.tensor(-(2**31), dtype=torch.int32, device=a1.device)
    a_s, q_s = a1 ^ sign, q1 ^ sign
    ranks = torch.empty(q1.numel(), dtype=torch.int32, device=q1.device)
    if not torch.equal(mc.merge_rank_sorted(a1, q1, strict=False),
                       torch.searchsorted(a_s, q_s, right=True, out_int32=True)):
        sys.exit("B1 ranks differ from torch.searchsorted")
    out["b1_ranks_ms"] = ms(lambda: mc.merge_rank_sorted(a1, q1, strict=False))
    out["b1_reduce_ms"] = ms(lambda: mc.merge_rank_sorted(a1, q1, strict=False, reduce=True))
    out["searchsorted_ms"] = ms(
        lambda: torch.searchsorted(a_s, q_s, right=True, out_int32=True, out=ranks))
    out["count_passes_ms"] = ms(lambda: mc.merge_count_passes(*plan))
    if hasattr(mc, "segments_launcher"):  # the bare launches of the segmented B1
        out["b1_ranks_launch_ms"] = ms(mc.segments_launcher(mc.plan_segments(
            [mc.Segment(a1.numel(), q1.numel(), q=(1, 0), strict=False, a=(0, 0), out=(2, 0))],
            a1.device), (a1, q1, ranks)))
        q2 = mc.pack_view(*plan[6:9], mc.BUILD_PAD)
        a2 = mc.pack_view(*plan[9:12], mc.PROBE_PAD)
        totals = torch.zeros(2, dtype=torch.int64, device=a1.device)
        out["count_launch_ms"] = ms(mc.segments_launcher(
            mc.plan_segments(mc.count_segments(a1.numel(), q1.numel(), a2.numel(), q2.numel()),
                             a1.device), (a1, q1, a2, q2, totals)))
    out["count_passes_launches"] = launches(lambda: mc.merge_count_passes(*plan))
    out["count"] = int(mc.merge_count_passes(*plan))
    del plan, q1, a1, a_s, q_s, ranks
    stream_and_resident(torch, ms, ctx, out)
    grouped(ctx, out)
    del ctx
    verbs(torch, ms, launches, *genome, out)

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    query = ("SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
             "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
    ctx = session(bd.gen_chain_table(20_000, 13), bd.gen_chain_table(300_000, 14))
    ctx.sql(query)
    stack = [ctx.plan_sql(query)]
    while not hasattr(stack[-1], "_merge_bounds_plan"):
        node = stack.pop()
        stack.extend(node.children)
    join = stack[-1]
    left, right = ctx.table("s1"), ctx.table("s2")
    from sequila_tpu_torch.exec.context import ExecContext

    index = join._prepare(ExecContext(ctx.config), left, right)[0]
    bplan = join._merge_bounds_plan(left, right, index)
    out["levels"] = index.num_levels
    lb, ub = mc.merge_level_bounds(bplan)
    out["level_pairs"] = int((ub.to(torch.int64) - lb).clamp(min=0).sum())
    out["level_bounds_ms"] = ms(lambda: mc.merge_level_bounds(bplan))
    if hasattr(mc, "segments_launcher"):
        q_e = mc.pack_view(*bplan[1:3], bplan[5], mc.BUILD_PAD)
        q_s = mc.pack_view(*bplan[3:5], bplan[6], mc.BUILD_PAD)
        bounds = torch.empty(2 * bplan[7] * bplan[8], dtype=torch.int32, device=q_e.device)
        out["level_launch_ms"] = ms(mc.segments_launcher(bplan[0], (q_e, q_s, bounds)))
    out["level_bounds_launches"] = launches(lambda: mc.merge_level_bounds(bplan))
    print(json.dumps(out), flush=True)


def stream_and_resident(torch, ms, ctx, out) -> None:
    """B2 at the genome pair's stream pass u and both passes, and B3 at its
    cap, each tree through its own entry points (see the module note)."""
    import numpy as np

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.cuda import stream_rank as sr
    from sequila_tpu_torch.ops.ranks import composite

    join = ctx.plan_sql(bd.QUERY).children[0]
    left, right = ctx.table("s1"), ctx.table("s2")
    inputs = join._sorted_count_inputs(left, right)
    bs_cd, be_cd, qs_cd, qe_cd = inputs[2:6]
    deltas = dict(d_bs=bs_cd[1], d_be=be_cd[1], d_qs=qs_cd[1], d_qe=qe_cd[1])
    splan = join._stream_count_plan(left, right, *inputs)
    pass_u, pass_l = sr.stream_pass_inputs(*splan, **deltas)
    u_a, u_q = composite(pass_u[0][0], pass_u[0][1]), composite(*pass_u[3:])
    want = int(torch.searchsorted(u_a, u_q, right=True).sum())
    if int(sr.stream_rank_sorted(*pass_u, strict=False, reduce=True)) != want:
        sys.exit("B2's pass u sum differs from torch.searchsorted's")
    out["b2_u_ms"] = ms(lambda: sr.stream_rank_sorted(*pass_u, strict=False, reduce=True))
    out["b2_searchsorted_ms"] = ms(lambda: torch.searchsorted(u_a, u_q, right=True))
    if hasattr(sr, "stream_count_launcher"):  # the pair merge path
        from sequila_tpu_torch.ops.cuda import pair_merge as pm

        total = torch.zeros(1, dtype=torch.int64, device=u_a.device)
        out["b2_u_launch_ms"] = ms(pm.segments_launcher(
            pm._rank_plan(pass_u[0].shape[1], pass_u[3].numel(), False, True, True, u_a.device),
            (pass_u[0][0], pass_u[0][1], *pass_u[3:], total, *pass_u[1:3])))
        out["b2_both_launch_ms"] = ms(sr.stream_count_launcher(pass_u, pass_l)[0])
    else:  # two launches, one a pass
        out["b2_both_launch_ms"] = ms(lambda: (
            sr.stream_rank_sorted(*pass_u, strict=False, reduce=True),
            sr.stream_rank_sorted(*pass_l, strict=True, reduce=True)))
    out["stream_passes_ms"] = ms(lambda: sr.stream_count_passes(*splan, **deltas))
    for backend in ("merge", "stream"):  # warm queries, host clock, medians of 10
        os.environ["SEQUILA_COUNT_BACKEND"] = backend
        ts = []
        for _ in range(11):
            t0 = time.perf_counter()
            if int(ctx.sql(bd.QUERY).column_np(0)[0]) != 99_159_827:
                sys.exit(f"the warm {backend} count(*) differs")
            ts.append(time.perf_counter() - t0)
        out[f"{backend}_query_ms"] = float(np.median(ts[1:])) * 1e3
    del os.environ["SEQUILA_COUNT_BACKEND"], pass_u, pass_l, u_a, u_q

    rng = np.random.default_rng(4)
    n, m = 1 << 20, 2_351_104
    cols = [torch.from_numpy(a).cuda() for a in (
        rng.integers(0, 24, n).astype(np.int32), rng.integers(0, 250_000_000, n).astype(np.int32),
        rng.integers(0, 25, m).astype(np.int32), rng.integers(0, 250_000_000, m).astype(np.int32))]
    a_k, a_v, _ = sr.sorted_padded(*cols[:2], n)
    r_k, r_v, _ = sr.sorted_padded(*cols[2:], m)
    r_a, r_q = composite(a_k, a_v), composite(r_k, r_v)
    ranks = torch.empty(m, dtype=torch.int32, device=a_k.device)
    if not torch.equal(rk.rank_sorted_resident(a_k, a_v, r_k, r_v, strict=True),
                       torch.searchsorted(r_a, r_q, out_int32=True)):
        sys.exit("B3's ranks differ from torch.searchsorted's")
    out["b3_ms"] = ms(lambda: rk.rank_sorted_resident(a_k, a_v, r_k, r_v, strict=True))
    out["b3_searchsorted_ms"] = ms(lambda: torch.searchsorted(r_a, r_q, out_int32=True, out=ranks))
    if hasattr(sr, "stream_count_launcher"):
        out["b3_launch_ms"] = ms(pm.segments_launcher(
            pm._rank_plan(n, m, True, False, False, a_k.device), (a_k, a_v, r_k, r_v, ranks)))


def grouped(ctx, out) -> None:
    """The warm grouped count over the genome pair on the merge route."""
    import numpy as np

    query = ("SELECT b.contig, count(*) FROM s1 a JOIN s2 b ON a.contig = b.contig "
             "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end GROUP BY b.contig")
    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    ts = []
    for _ in range(4):
        t0 = time.perf_counter()
        res = ctx.sql(query)
        ts.append(time.perf_counter() - t0)
        if res.num_rows != 24 or int(res.column_np(1).astype(np.int64).sum()) != 99_159_827:
            sys.exit("the grouped count differs")
    out["grouped_warm_ms"] = float(np.median(ts[1:])) * 1e3
    del os.environ["SEQUILA_HOST_THRESHOLD"]


def verbs(torch, ms, launches, t1, t2, out) -> None:
    """B1's verb and per-probe modes, a warm device coverage and a warm
    device count_overlaps over the genome pair, each tree through its own
    entry points."""
    import numpy as np
    import pyarrow as pa

    from sequila_tpu_torch import dataframe as df
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    a, b = Table(pa.table(t2)), Table(pa.table(t1))
    plan = mc.plan_verb_ranks(b, a, (0, 1, 2), (0, 1, 2), want4=True, device="cuda")
    if not torch.equal(mc.merge_verb_rank4(plan), mc.merge_verb_rank4_plain(plan)):
        sys.exit("merge_verb_rank4 differs from merge_verb_rank4_plain")
    out["verb_rank4_ms"] = ms(lambda: mc.merge_verb_rank4(plan))
    pplan = mc.plan_verb_ranks(b, a, (0, 1, 2), (0, 1, 2), want4=False, device="cuda")
    if int(mc.merge_probe_count_passes(pplan).sum()) != 99_159_827:
        sys.exit("merge_probe_count_passes' counts differ")
    out["probe_passes_ms"] = ms(lambda: mc.merge_probe_count_passes(pplan))
    out["probe_passes_launches"] = launches(lambda: mc.merge_probe_count_passes(pplan))
    del plan, pplan
    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    for verb in ("coverage", "count_overlaps"):
        ts = []
        for _ in range(21):
            t0 = time.perf_counter()
            counts = getattr(df, verb)(a, b, device="cuda").column_np("count")
            ts.append(time.perf_counter() - t0)
            if int(counts.sum()) != 99_159_827:
                sys.exit(f"the device {verb}'s counts differ")
        out[f"{verb}_warm_ms"] = float(np.median(ts[1:])) * 1e3
    del os.environ["SEQUILA_HOST_THRESHOLD"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="a source tree, in turn")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, os.getcwd())
        worker()
        return
    rc = 0
    for tree in args.tree or ["."]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                             cwd=os.path.abspath(tree), timeout=600)
        rc = rc or res.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
