"""Randomized fuzz of the port's device paths and hand kernels on the card:
the port's counterpart of tools/device_fuzz.py.

Two parts, both exact (integers):

1. Public paths on ``device="cuda"`` with the device forced
   (SEQUILA_HOST_THRESHOLD=0), held to sequila_tpu_torch/ops/oracle.py.
   Each trial draws 1-6 contigs, build and probe tables of 0 to 2^20 rows
   (sizes at the kernels' tile, block and chunk boundaries, or
   log-uniform), widths 0-60 over a 20,000 span (every fourth trial
   within 5,000 of INT32_MIN or INT32_MAX), and, every third trial, 10 %
   degenerate probes (start > end).  It checks the per-probe counts of
   ``count_overlaps`` on the merge backend (B1's per-probe mode and
   ``unpermute_counts``) and on the level index's ops, ``coverage`` (B1's
   verb mode and ``unpermute_ranks``), count(*) on the merge (B1,
   ``pack_view``), stream (B2) and cosort backends (degenerate trials take
   the level route) and the device ``SELECT *`` (B1's level mode) against
   ``oracle_counts`` / ``oracle_pairs`` (pairs sorted).  The oracle loops
   over probe rows, so a trial of more than FULL_PROBES probes or
   ORACLE_CELLS build x probe cells is held to it on SAMPLE random probe
   rows; every count(*) route must then equal the per-probe counts' sum,
   and the two per-probe routes each other on every row.  ``SELECT *``
   runs when the join has at most PAIR_CAP rows.
2. Each kernel entry against its plain version on the same inputs, at
   random ragged sizes up to KERNEL_ROWS: ``merge_rank_sorted``; one
   ``merge_rank_segments`` launch of random segments (empty tables, empty
   queries, 1-row tables, duplicate runs longer than a tile, packed or
   raw tables, ranks direct, through an order or not stored, sums, both
   ``strict`` values: the count, level, per-probe and verb modes'
   shapes); ``pack_view``; ``merge_probe_count_passes`` and
   ``merge_verb_rank4`` on random tables; ``unpermute_counts`` and
   ``unpermute_ranks`` on random permutations; B2 (``stream_rank_sorted``,
   exact and random windows), B3 (``rank_sorted_resident``) and one
   ``pair_merge_segments`` launch of random segments.

    python3 tools/cuda_fuzz.py [--seed S] [--trials T] [--rounds R] [--kernel-rows N]

Trial i draws from ``default_rng([S, i])`` and round r from
``default_rng([S, 10000 + r])``; a failure prints the trial's shapes and
the arguments that replay it.  It exits non-zero on a failure or without
a card.  chip_smoke.py phase 10 calls ``fuzz``; tools/cuda_sanitize.py
runs ``--trials 0`` at small shapes under compute-sanitizer.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SEED = 123
TRIALS = 80
ROUNDS = 24
MAX_ROWS = 1 << 20
KERNEL_ROWS = 1 << 20
SPAN, WIDTH, EXTREME = 20_000, 60, 5_000
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
FULL_PROBES = 4096
ORACLE_CELLS = 1 << 25
SAMPLE = 200
PAIR_CAP = 4_000_000
# sizes at the tile, block and chunk boundaries of B1 (TILE 2048, SPAN
# 14,336) and of the pair merge (BLOCK 256, CHUNK and TILE 2048, SPAN 8192)
EDGES = (0, 1, 2, 255, 256, 257, 2047, 2048, 2049, 8191, 8192, 8193, 14_335, 14_336,
         14_337, MAX_ROWS - 1, MAX_ROWS)
JOIN_ON = ("FROM a JOIN b ON a.contig = b.contig"
           " AND a.pos_start <= b.pos_end AND a.pos_end >= b.pos_start")


class FuzzFailure(AssertionError):
    pass


def draw_size(rng, cap: int) -> int:
    """A table size: a boundary size (40 %) or log-uniform in [1, cap]."""
    if rng.random() < 0.4:
        return min(int(rng.choice(EDGES)), cap)
    return int(np.exp(rng.uniform(0, np.log(cap))))


# ---------------------------------------------------------------------------
# 1. Public paths against the oracle
# ---------------------------------------------------------------------------


def draw_trial(rng, trial: int):
    """(build k, s, e, probe k, s, e, description) of one trial."""
    nk = int(rng.integers(1, 7))
    n, m = draw_size(rng, MAX_ROWS), draw_size(rng, MAX_ROWS)
    base, span, where = 0, SPAN, "0"
    if trial % 4 == 3:
        low = rng.random() < 0.5
        base = INT32_MIN if low else INT32_MAX - EXTREME - WIDTH - 10
        span, where = EXTREME, "INT32_MIN" if low else "INT32_MAX"

    bk, bs, be = side(rng, n, nk, base, span)
    qk, qs, qe = side(rng, m, nk + 1, base, span)  # one probe key no build row has
    n_deg = 0
    if trial % 3 == 0:
        deg = rng.random(m) < 0.1
        n_deg = int(deg.sum())
        qs[deg] = qe[deg] + rng.integers(1, 10, n_deg).astype(np.int32)
    desc = f"keys={nk} N={n} M={m} degenerate={n_deg} near {where}"
    return (bk, bs, be, qk, qs, qe), desc


def side(rng, rows: int, keys: int, base: int = 0, span: int = SPAN):
    """Int32 (key, start, end) of ``rows`` intervals of widths 0-WIDTH."""
    k = rng.integers(0, keys, rows).astype(np.int32)
    s = (base + rng.integers(0, span, rows)).astype(np.int32)
    e = (s.astype(np.int64) + rng.integers(0, WIDTH + 1, rows)).astype(np.int32)
    return k, s, e


def arrow_table(k, s, e, id_col):
    import pyarrow as pa

    names = np.array([f"c{i}" for i in range(7)])
    return pa.table({"contig": pa.array(names[k]), "pos_start": s.astype(np.int64),
                     "pos_end": e.astype(np.int64), id_col: np.arange(len(k), dtype=np.int64)})


def oracle_bases(bk, bs, be, qk, qs, qe) -> np.ndarray:
    """sum(min(end, qe) - max(start, qs)) over each probe row's matches
    (superintervals coverage), in int64."""
    out = np.zeros(len(qk), np.int64)
    for i in range(len(qk)):
        mask = (bk == qk[i]) & (bs <= qe[i]) & (be >= qs[i])
        out[i] = np.sum(np.minimum(be[mask], qe[i]).astype(np.int64)
                        - np.maximum(bs[mask], qs[i]))
    return out


def pair_keys(probe_rows, build_rows) -> np.ndarray:
    return np.sort((np.asarray(probe_rows, np.int64) << 21) | np.asarray(build_rows, np.int64))


def public_trial(ctx, rng, trial: int, device: str, stats: dict) -> str:
    from sequila_tpu_torch import dataframe as gdf
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.ops.oracle import oracle_counts, oracle_pairs

    cols, desc = draw_trial(rng, trial)
    bk, bs, be, qk, qs, qe = cols
    n, m = len(bk), len(qk)
    a, b = arrow_table(bk, bs, be, "aid"), arrow_table(qk, qs, qe, "bid")
    ctx.register_table("a", a)
    ctx.register_table("b", b)
    full = m <= FULL_PROBES and n * m <= ORACLE_CELLS
    rows = np.arange(m) if full else np.sort(rng.choice(m, SAMPLE, replace=False))
    sub = (qk[rows], qs[rows], qe[rows])
    want = oracle_counts(bk, bs, be, *sub).astype(np.int64)

    held = "every probe row" if full else f"{len(rows)} random probe rows"

    def expect(ok, what):
        if not ok:
            raise FuzzFailure(f"{what} differs ({desc}, oracle on {held})")

    probe, build = Table(b), Table(a)
    counts = {}
    for backend in ("merge", "cosort"):  # B1's per-probe mode; the level index's ops
        os.environ["SEQUILA_COUNT_BACKEND"] = backend
        got = gdf.count_overlaps(probe, build, device=device).column_np("count")
        expect(np.array_equal(got[rows], want), f"count_overlaps ({backend})")
        counts[backend] = got
    expect(np.array_equal(counts["merge"], counts["cosort"]), "count_overlaps merge vs level")
    total = int(counts["merge"].sum())

    os.environ["SEQUILA_COUNT_BACKEND"] = "merge"
    cov = gdf.coverage(probe, build, device=device)
    expect(np.array_equal(cov.column_np("count")[rows], want), "coverage counts")
    expect(np.array_equal(cov.column_np("bases")[rows], oracle_bases(bk, bs, be, *sub)),
           "coverage bases")

    for backend in ("merge", "stream", "cosort"):
        os.environ["SEQUILA_COUNT_BACKEND"] = backend
        got = int(ctx.sql(f"SELECT count(*) {JOIN_ON}").column_np(0)[0])
        route = [k for c in ctx.last_metrics.counters.values() for k in c
                 if k.startswith("count_route_")]
        stats["count_routes"].update(r[len("count_route_"):] for r in route)
        expect(got == total, f"count(*) under {backend} ({route}: {got} against {total})")
    os.environ["SEQUILA_COUNT_BACKEND"] = "merge"

    if total <= PAIR_CAP:
        out = ctx.sql(f"SELECT a.aid, b.bid {JOIN_ON}")
        aid, bid = out.column_np(0), out.column_np(1)
        if not full:
            keep = np.isin(bid, rows)
            aid, bid = aid[keep], bid[keep]
        ob, op = oracle_pairs(bk, bs, be, *sub)
        expect(np.array_equal(pair_keys(bid, aid), pair_keys(rows[op], ob)), "SELECT * pairs")
        stats["pairs"] += len(aid)
    stats["sizes"].append((n, m))
    stats["total"] += total
    return f"{desc}: total {total}, oracle on {held}"


# ---------------------------------------------------------------------------
# 2. Each kernel entry against its plain version
# ---------------------------------------------------------------------------


def kernel_round(rng, dev, cap: int, err: dict, place=None) -> str:
    """One round of every kernel entry at random ragged sizes up to
    ``cap``; ``err`` takes each entry's largest |difference|.  ``place``
    (default: as it is) takes each tensor handed to a kernel, input or
    caller-provided output, and returns the tensor the kernel gets
    (tools/cuda_sanitize.py puts it between guard bands)."""
    import torch

    P = place or (lambda t: t)

    from chip_smoke import max_diff, perm, sorted_pairs, sorted_u32
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.cuda import pair_merge as pm
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.cuda import stream_rank as sr

    shapes = []

    def same(name, got, want, what):
        d = max_diff(torch, got, want)
        err[name] = max(err.get(name, 0), d)
        if d:
            raise FuzzFailure(f"{name} {what}: max |diff| {d} against the plain version")

    # B1 alone, ranks and sums
    n, m = draw_size(rng, cap), draw_size(rng, cap)
    a, q = P(sorted_u32(rng, n, torch, dev)), P(sorted_u32(rng, m, torch, dev))
    for strict in (True, False):
        same("merge_rank_sorted", mc.merge_rank_sorted(a, q, strict=strict),
             mc.merge_rank_plain(a, q, strict=strict), f"N={n} M={m} strict={strict}")
        same("merge_rank_sorted", mc.merge_rank_sorted(a, q, strict=strict, reduce=True),
             mc.merge_rank_plain(a, q, strict=strict, reduce=True), f"sum N={n} M={m}")
    shapes.append(f"B1 {n}x{m}")

    # one segmented launch of random segments
    segs, tabs, qs, q_off, a_off, n_tot = [], [], [], 0, 0, 0
    for i in range(int(rng.integers(1, 11))):
        n, m = draw_size(rng, cap // 4 or 1), draw_size(rng, cap // 4 or 1)
        a = sorted_u32(rng, n, torch, dev)
        if n and rng.random() < 0.25:  # duplicate runs longer than a tile
            a = a[torch.arange(n, device=dev) // (3 * mc.TILE) * (3 * mc.TILE)]
        n_real = m if rng.random() < 0.6 else int(rng.integers(0, m + 1))
        store = rng.choice(["direct", "order", "none"])
        common = dict(q=(1, q_off), strict=bool(rng.random() < 0.5), total=(3, i))
        if store != "none":
            common.update(out=(2, q_off), n_real=n_real)
            if store == "order":
                common["ord"] = P(perm(torch, rng, n_real, dev))
        if rng.random() < 0.5:  # the same values as key codes and values packed on load
            k = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
            c = torch.tensor([7, -(2**31), 5], dtype=torch.int32, device=dev)
            v = (a.to(torch.int64) - c.to(torch.int64)[k.long()]) & 0xFFFFFFFF
            v = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
            segs.append(mc.Segment(n, m, raw=(P(k), P(v), P(c), mc.PROBE_PAD), **common))
        else:
            segs.append(mc.Segment(n, m, a=(0, a_off), **common))
            tabs.append(a)
            a_off += n
        qs.append(sorted_u32(rng, m, torch, dev))
        q_off += m
        n_tot += n
    tab = torch.cat(tabs) if tabs else torch.zeros(0, dtype=torch.int32, device=dev)
    slots = tuple(P(t) for t in (
        tab, torch.cat(qs), torch.full((q_off,), -1, dtype=torch.int32, device=dev),
        torch.zeros(len(segs), dtype=torch.int64, device=dev)))
    want = tuple(t.clone() for t in slots)
    mc.merge_rank_segments(mc.plan_segments(segs, dev), slots)
    mc.merge_rank_segments_plain(segs, want)
    for g, w in zip(slots, want):
        same("merge_rank_sorted", g, w, f"{len(segs)} segments {[(s.n, s.m) for s in segs]}")
    shapes.append(f"B1 {len(segs)} segments ({n_tot} table rows, {q_off} queries)")

    # pack_view
    n, nkeys = draw_size(rng, cap), int(rng.integers(1, 30))
    k_h = rng.integers(0, nkeys, n).astype(np.int32)
    k_h[rng.random(n) < 0.01] = INT32_MAX  # PAD rows
    k = P(torch.from_numpy(k_h).to(dev))
    v = P(torch.from_numpy(rng.integers(INT32_MIN, INT32_MAX, n).astype(np.int32)).to(dev))
    c = P(torch.from_numpy(rng.integers(0, 2**32, nkeys, dtype=np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev))
    for pad in (mc.BUILD_PAD, mc.PROBE_PAD):
        same("pack_view", mc.pack_view(k, v, c, pad), mc.pack_view_plain(k, v, c, pad),
             f"n={n} keys={nkeys}")
    shapes.append(f"pack_view {n}")

    # the un-permutes on random permutations
    n = draw_size(rng, cap)
    inv = [P(torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)) for _ in range(2)]
    r2 = P(torch.from_numpy(rng.integers(0, 2**30, (2, n)).astype(np.int32)).to(dev))
    r4 = P(torch.from_numpy(rng.integers(0, 2**31 - 1, (4, n)).astype(np.int32)).to(dev))
    same("unpermute_counts", mc.unpermute_counts(r2, *inv), mc.unpermute_counts_plain(r2, *inv),
         f"n={n}")
    same("unpermute_ranks", mc.unpermute_ranks(r4, *inv), mc.unpermute_ranks_plain(r4, *inv),
         f"n={n}")
    shapes.append(f"un-permutes {n}")

    # the per-probe and verb modes on random tables
    from sequila_tpu_torch.models.table import Table

    nk = int(rng.integers(1, 7))
    n, m = draw_size(rng, cap), draw_size(rng, cap)
    build = Table(arrow_table(*side(rng, n, nk), "aid"))
    probe = Table(arrow_table(*side(rng, m, nk + 1), "bid"))
    for want4, name, fn, plain in ((False, "merge_probe_ranks", mc.merge_probe_count_passes,
                                    mc.merge_probe_count_passes_plain),
                                   (True, "merge_verb_ranks", mc.merge_verb_rank4,
                                    mc.merge_verb_rank4_plain)):
        plan = mc.plan_verb_ranks(build, probe, (0, 1, 2), (0, 1, 2), want4=want4, device=dev)
        if plan is not None:
            same(name, fn(plan), plain(plan), f"N={n} M={m} keys={nk}")
    shapes.append(f"per-probe and verb modes {n}x{m}")

    # B2 with exact and random windows, B3
    n, m = draw_size(rng, cap), draw_size(rng, cap)
    a_k, a_v = sorted_pairs(rng, n, -(-n // sr.CHUNK) * sr.CHUNK, 24, torch, dev)
    q_k, q_v = sorted_pairs(rng, m, -(-m // sr.BLOCK) * sr.BLOCK, 25, torch, dev)
    c_lo, n_ch = sr.device_windows(a_k, a_v, q_k, q_v)
    if rng.random() < 0.3 and c_lo.numel():  # windows that may miss the rank
        c_lo = torch.from_numpy(rng.integers(0, max(a_k.numel() // sr.CHUNK, 1),
                                             c_lo.numel()).astype(np.int32)).to(dev)
        n_ch = torch.from_numpy(rng.integers(-1, 3, c_lo.numel()).astype(np.int32)).to(dev)
    args = tuple(P(t) for t in (torch.stack([a_k, a_v]), c_lo, n_ch, q_k[:m], q_v[:m]))
    for strict in (True, False):
        for reduce in (False, True):
            same("stream_rank_sorted", sr.stream_rank_sorted(*args, strict=strict, reduce=reduce),
                 sr.stream_rank_plain(*args, strict=strict, reduce=reduce),
                 f"n={n} m={m} strict={strict} reduce={reduce}")
    n_pad = int(rng.integers(1, max(min(cap, rk.MAX_RESIDENT_BUILD) // rk.CHUNK, 1) + 1)) * rk.CHUNK
    a_k, a_v = sorted_pairs(rng, n_pad - int(rng.integers(0, 6)), n_pad, 24, torch, dev)
    q_k, q_v = sorted_pairs(rng, m, m, 25, torch, dev)
    a_k, a_v, q_k, q_v = (P(t) for t in (a_k, a_v, q_k, q_v))
    for strict in (True, False):
        same("rank_sorted_resident", rk.rank_sorted_resident(a_k, a_v, q_k, q_v, strict=strict),
             rk.rank_resident_plain(a_k, a_v, q_k, q_v, strict=strict),
             f"n={n_pad} m={m} strict={strict}")
    shapes.append(f"B2 {n}x{m}, B3 {n_pad}x{m}")

    # one pair-merge launch of random segments
    cols = [[], [], [], [], [], []]  # a_k, a_v, q_k, q_v, c_lo, n_chunks
    segs, off = [], [0, 0, 0]
    for i in range(int(rng.integers(1, 9))):
        n, m = draw_size(rng, cap // 4 or 1), draw_size(rng, cap // 4 or 1)
        a_k, a_v = sorted_pairs(rng, n, n, 24, torch, dev)
        if n and rng.random() < 0.25:
            run = torch.arange(n, device=dev) // (3 * pm.TILE) * (3 * pm.TILE)
            a_k, a_v = a_k[run], a_v[run]
        q_k, q_v = sorted_pairs(rng, m, -(-m // pm.BLOCK) * pm.BLOCK, 25, torch, dev)
        kw = {}
        if rng.random() < 0.4:
            blocks = -(-m // pm.BLOCK)
            c_lo, n_ch = sr.device_windows(a_k, a_v, q_k, q_v)
            cols[4].append(c_lo)
            cols[5].append(n_ch)
            kw = dict(c_lo=(6, off[2]), n_chunks=(7, off[2]))
            off[2] += blocks
        store = rng.choice(["out", "total", "both"])
        if store != "total":
            kw["out"] = (4, off[1])
        if store != "out":
            kw["total"] = (5, i)
        segs.append(pm.PairSegment(n, m, a_k=(0, off[0]), a_v=(1, off[0]), q_k=(2, off[1]),
                                   q_v=(3, off[1]), strict=bool(rng.random() < 0.5), **kw))
        for col, t in zip(cols, (a_k, a_v, q_k[:m], q_v[:m])):
            col.append(t)
        off[0] += n
        off[1] += m

    def cat(ts):
        return torch.cat(ts) if ts else torch.zeros(0, dtype=torch.int32, device=dev)

    slots = tuple(P(t) for t in (
        *(cat(c) for c in cols[:4]), torch.full((off[1],), -1, dtype=torch.int32, device=dev),
        torch.zeros(len(segs), dtype=torch.int64, device=dev), *(cat(c) for c in cols[4:])))
    want = tuple(t.clone() for t in slots)
    pm.pair_merge_segments(pm.plan_pair_segments(segs, dev), slots)
    pm.pair_segments_plain(segs, want)
    for g, w in zip(slots, want):
        # B2's and B3's launch
        same("stream_rank_sorted", g, w, f"{len(segs)} pair segments "
             f"{[(s.n, s.m) for s in segs]}")
        same("rank_sorted_resident", g, w, f"{len(segs)} pair segments")
    shapes.append(f"pair merge {len(segs)} segments ({off[0]} table rows, {off[1]} queries)")
    return "; ".join(shapes)


# ---------------------------------------------------------------------------


def fuzz(seed=SEED, trials=TRIALS, rounds=ROUNDS, device="cuda", kernel_rows=KERNEL_ROWS,
         report=print) -> dict:
    """Run ``trials`` public-path trials and ``rounds`` kernel rounds,
    trial i from ``default_rng([seed, i])``; raise FuzzFailure, with the
    seed and shapes, at the first difference.  Returns what was covered
    and each kernel entry's largest |difference| (0)."""
    import torch

    from sequila_tpu_torch.session import SessionContext

    saved = {k: os.environ.get(k) for k in ("SEQUILA_HOST_THRESHOLD", "SEQUILA_COUNT_BACKEND")}
    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    stats = {"count_routes": set(), "sizes": [], "pairs": 0, "total": 0,
             "err": dict.fromkeys(("merge_rank_sorted", "pack_view", "merge_probe_ranks",
                                   "unpermute_counts", "merge_verb_ranks", "unpermute_ranks",
                                   "stream_rank_sorted", "rank_sorted_resident"), 0)}
    t0 = time.perf_counter()
    try:
        ctx = SessionContext(device=device)
        ctx.sql("SET sequila.prefer_interval_join = true")
        for i in range(trials):
            try:
                line = public_trial(ctx, np.random.default_rng([seed, i]), i, device, stats)
            except FuzzFailure as e:
                raise FuzzFailure(f"trial {i} (replay: --seed {seed} --trials {i + 1} "
                                  f"--rounds 0): {e}") from None
            report(f"trial {i}: {line} OK [{time.perf_counter() - t0:.1f} s]")
        for r in range(rounds):
            rng = np.random.default_rng([seed, 10_000 + r])
            try:
                line = kernel_round(rng, torch.device(device), kernel_rows, stats["err"])
            except FuzzFailure as e:
                raise FuzzFailure(f"kernel round {r} (replay: --seed {seed} --trials 0 "
                                  f"--rounds {r + 1}): {e}") from None
            report(f"kernel round {r}: {line}: equal to the plain versions "
                   f"[{time.perf_counter() - t0:.1f} s]")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    stats["seconds"] = time.perf_counter() - t0
    return stats


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--trials", type=int, default=TRIALS)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--kernel-rows", type=int, default=KERNEL_ROWS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: the fuzz needs a CUDA device",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    try:
        stats = fuzz(args.seed, args.trials, args.rounds, kernel_rows=args.kernel_rows,
                     report=lambda s: print(s, flush=True))
    except FuzzFailure as e:
        print(f"FUZZ FAILED: {e}", flush=True)
        return 1
    print(f"FUZZ PASSED: {len(stats['sizes'])} trials, {args.rounds} kernel rounds in "
          f"{stats['seconds']:.1f} s; count routes {sorted(stats['count_routes'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
