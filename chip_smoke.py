"""Smoke run of the PyTorch / CUDA port (sequila_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
1. toolchain: torch, CUDA, the card's name and power limit, nvcc, g++,
   triton, pyarrow;
2. build: the CUDA kernels from sequila_tpu_torch/csrc with nvcc for sm_90a
   (one nvcc a source, in parallel), printing ``-Xptxas -v``;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, exact integer equality.  merge_rank_sorted and pack_view on random
   sorted u32 tables with duplicate runs, both sentinels, both ``strict``
   values, ragged lengths and an empty table, up to the genome shapes;
   stream_rank_sorted (B2) and rank_sorted_resident (B3), both one merge
   path over (key, value) pairs (pair_merge.cu), on random sorted builds
   with duplicate runs across chunks and PAD tails, both ``strict``
   values, B2 up to the genome shapes and B3 up to its 2^20-row cap with
   2.35 M queries, each also against one global torch.searchsorted rank
   (which a bad window would miss); one pair-merge launch of edge
   segments (empty table, empty queries, a 1-row table, tables far larger
   and far smaller than their queries, a duplicate run longer than a tile,
   exact and too-narrow windows), both ``strict`` values; B1's
   segmented launch (merge_rank_segments), one launch a case, with ranks
   through a random permutation and sums, both ``strict`` values: one
   segment at every B1 shape, two (inline) at the genome count shape, and
   ten edge segments (empty table, empty queries, a 1-row table, tables
   far larger and far smaller than their queries, duplicate runs longer
   than a tile, both sentinels, raw and packed tables);
4. main path: ``SessionContext(device="cuda").sql(count(*) overlap join)``
   on the synthetic databio chr1 pair and on the whole-genome pair, checked
   against the known counts and an independent numpy BITS count; the merge
   route must answer and its kernels' launch counters rise; a warm
   count(*) must launch B1 once (both BITS passes) and pack_view 4 times;
4b. the other count backends on both pairs: SEQUILA_COUNT_BACKEND=stream
   (B2's counter must rise, and a warm stream count(*) launch B2 exactly
   once for both passes) and =cosort (no B1 or B2 launch), the same
   counts, each route asserted through the operator's route metric;
4c. the level loop at full size: the genome pair with 1 % zero-length probe
   rows under the half-open query (degenerate after the planner's end - 1),
   under Coitrees (sort) and IntervalTree (bsearch), against the native C++
   host index over the same columns;
4d. B3's entry point ``rank_lex_resident`` at its cap (2^20-row build,
   2.35 M queries) against ``rank_lex_sort``;
4e. the warm time of every route on the genome pair and each kernel's
   time against its plain version (CUDA events, turns plain, kernel,
   kernel, plain; B1, B2 and B3 as bare launches, then through their
   wrappers; both stream passes in one B2 launch), then one PyTorch call
   of the same function where there is one (torch.searchsorted), and the
   kernel's bound (the bytes it must move over 3.35 TB/s), beside the
   card's name and power limit;
4f. the grouped count(*) ``SELECT b.contig, count(*) ... GROUP BY
   b.contig`` over the genome pair (per-probe counts): on the merge route
   (SEQUILA_HOST_THRESHOLD=0) 24 groups summing to 99,159,827, a warm query
   launching B1 exactly once (both passes, ranks stored in view order),
   pack_view twice and the un-permute unpermute_counts once; the 7,684,066
   per-probe counts equal to the native host index's and the level route's
   element by element; the host route's groups equal; first and warm times
   of both routes; B1's per-probe mode: the launch split two ways (ranks
   through the probe views' int64 orders, the first port's design, or
   direct, in view order), each against its plain version and timed; the
   launch against merge_rank_segments_plain and the un-permute against its
   plain version, both together against merge_probe_count_passes_plain and the native
   host index's counts; each timed as a bare launch beside its bound, B1
   beside two torch.searchsorted calls, the un-permute beside two
   torch.index_select and a subtraction, the two together beside both
   bounds (with int64 orders and with int32 inverse orders) and two
   torch.searchsorted with two index_copy_ and a subtraction, and
   merge_probe_count_passes whole;
5a. the materializing ``SELECT *`` at the 15M-row pairing
   (``gen_chain_table(20_000, 13)`` x ``gen_chain_table(300_000, 14)``):
   the host route for reference, then the device route on the merge
   emission bounds (exactly 1 B1 and 2 pack_view launches), whose
   rows must number the join's count(*) and whose order-independent
   checksum must equal the host route's; SEQUILA_EMIT_BACKEND=cosort and
   the low-memory capped chunks must equal it row for row, Lapper (window)
   and IntervalTree (bsearch) must give its checksum, and a LEFT JOIN the
   host route's checksum; each route asserted through the operator's
   route metric (``emit_route_<name>``); warm times of both routes;
5a'. the three emission strategies on that join's merge bounds (equal
   pairs, each timed), its level-bounds pass: the 2 probe-view pack_view
   launches and the one B1 launch for every level and both bounds, each
   equal to its plain version on the same inputs, the launch timed against
   its plain version and its bound, with its ranks stored direct beside
   one batched torch.searchsorted over the padded levels (the same ranks),
   and against that searchsorted followed by one index_copy_ through the
   int64 orders (the launch's own function, its library call), and
   merge_level_bounds as a whole;
5b. ``sql_batches`` of ``SELECT *`` over the chr1 pair with
   max_output_batch_size = 1,000,000 on the device and host routes:
   153,690,858 rows, batches of at most 4,000,000 rows unless one probe
   row alone has more, equal checksums, rows/s of each;
5c. ``COPY`` of the 15M-row join to a parquet directory, read back with
   the same row count and checksum;
5d. where the time of the 15M-row warm ``SELECT *`` goes: each stage of
   the device and host routes timed on the host clock with the device
   synchronised, and the device route's busy share under torch.profiler;
5e. ``SELECT *`` of the genome pair's 2.35 M-row build table against
   100,000 and 1,000,000 probe rows on the host and device routes, each
   from a fresh session (first query and warm median), with equal
   checksums: the shapes where materialize_route_host's build term counts;
5f. nearest ``SELECT *`` (CoitreesNearest) on the host route (the
   default) and the device route (SEQUILA_HOST_THRESHOLD=0), each from a
   fresh session, row for row equal: the genome build against
   ``gen_genome_table(1_000_000, 23)`` (most probes overlap) and
   ``gen_genome_table(100_000, 24)`` against the genome probes (most take
   the upstream or downstream pick); the overlap, nearest and NULL picks
   and each route's first and warm times;
5g. the warm 15M host-route ``SELECT *`` in this process (allocator tuned
   at import) and in a child with SEQUILA_MALLOC_TUNE=0, both printed;
   nothing is asserted on speed;
5h. the genomic verbs over the genome pair in 4f's direction (the
   7,684,066 genome probes enriched with the 2,350,965-row build):
   ``count_overlaps`` and ``coverage`` through the DataFrame API and
   through SQL (``FROM coverage('a', 'b')``), on the host route (the
   default) and the device route (SEQUILA_HOST_THRESHOLD=0), from fresh
   tables; every count and covered-bases value equal to the native host
   index's (counts summing to 99,159,827); a warm device coverage launching
   B1, pack_view 4 times and the un-permute once, a warm count_overlaps
   B1 once, pack_view twice and unpermute_counts once, the host route
   nothing; first and warm
   times; ``closest(k=3)``, ``subtract`` and ``merge`` timed at that
   shape; B1's verb mode: the launch through the orders split four ways
   (build views packed on load or pre-packed, ranks through the orders or
   direct), each against its plain version and timed; the redesigned
   launch (coverage's four rank passes as four segments, ranks in view
   order) against its plain version, the un-permute kernel against its
   own, both together against merge_verb_rank4_plain and the native host
   index's counts on every probe; each timed as a bare launch beside its
   bound, B1 beside four torch.searchsorted calls, the un-permute beside
   torch.gather, the two together beside four torch.searchsorted with
   four index_copy_, and merge_verb_rank4 whole;
6. the q1 fixture through the port's CLI (host route), expecting 16;
6b. queries/q2-genomic-verbs.sql through the port's CLI with ``--device
   cuda`` (at the default threshold and at SEQUILA_HOST_THRESHOLD=0) and
   ``--device cpu``: the same tables once the query times are removed;
7. Partitioned mode: sessions on the card with ``SET
   datafusion.execution.target_partitions = 4`` (the mesh printed: one
   shard a card) under each ``sequila.partitioned_distribution`` (auto,
   hash, shuffle, skew): count(*) of the chr1 and genome pairs, ``SELECT
   *`` of the 15M-row pairing with the host route's checksum (and once
   through sql_batches), nearest at 5f's genome build x 1,000,000 probes
   row for row equal to the single-device device route, and the grouped
   count's 24 groups, each timed beside the single-device warm time (first
   and warm; one run where the program is another's: the grouped count
   outside hash, nearest under shuffle) with its ``distribution_<name>``
   metric; the verbs count_overlaps and coverage with ``partitions=4``
   over 5h's pair equal to the single-device verbs.  Then the same
   queries, one run each, and nearest over the chr1 pair (its one contig
   split by skew), on a (2, 2) mesh that repeats the card (as the CPU
   mesh repeats the host device), so that one card runs every
   multi-shard path: the shuffle's exchange, split hot keys and their
   ownership filter, the nearest fringe, LPT packing and the probe-order
   restore.  It fails if a hand kernel launched in the phase.  Last, each
   shard's level bounds by the 'sort' and 'bsearch' rank strategies,
   equal and timed;
8. Partitioned mode across OS processes (parallel/distributed.py): the
   script starts ranks of itself joined by one torch.distributed group,
   8a two ranks on the one card over Gloo, 8b one rank a card
   (torch.cuda.device_count() ranks) over NCCL.  Every rank holds the
   global tables and runs, on sessions with ``target_partitions = 4`` (the
   engine's mesh spans the ranks' cards, each shard owned by one rank),
   the genome count(*) under hash, shuffle and skew (first and warm),
   ``collect_left_count`` over that mesh, the 15M-row ``SELECT *`` under
   each distribution (one run) and the grouped count (one run).  Every
   rank must give 99,159,827, the host route's rows and checksum, and the
   single-process grouped count's 24 groups, launch no hand kernel, and
   agree with the other ranks; each time is printed with the share spent
   in the collectives.  A rank that fails or runs past its timeout fails
   the phase, and its peers are stopped;
9. the device sweep (tools/cuda_sweep.py): each query on the forced device
   route (SEQUILA_HOST_THRESHOLD=0) and on the host route, equal, the
   device run with no host route metric: at tools/tpu_sweep.py's tables
   (sorted rows) inner ``SELECT *`` under coitrees, intervaltree, lapper
   and superintervals, LEFT, RIGHT and FULL joins, nearest, the strict
   operators, the grouped count, ``coverage`` and ``count_overlaps``
   (which must launch B1 on the device route); at the 15M pairing the
   row count and checksum of inner ``SELECT *`` under the four
   algorithms, LEFT and FULL joins and the strict operators, and the
   grouped count's rows;
10. the device fuzz (tools/cuda_fuzz.py, a fixed seed): random tables of
   0 to 2^20 rows through count_overlaps, coverage, count(*) on the
   merge, stream and cosort backends (the level route on degenerate
   trials) and the device ``SELECT *``, against ops/oracle.py; then each
   kernel entry against its plain version at random ragged sizes; the
   public paths must have taken the merge, stream and level routes and
   launched B1, pack_view, both un-permutes and B2;
11. the kernels' memory checks (tools/cuda_sanitize.py): compute-sanitizer
   (memcheck, racecheck, synccheck, initcheck) over the kernel rounds at
   small shapes, each tool's error count printed, or why the sanitizer
   could not run; and guard bands of junk around every tensor a kernel
   reads or a caller's output slot, which must keep their bytes while
   every result equals its plain version.

``python3 chip_smoke.py --multiprocess-only`` builds the references and
runs phase 8b alone (for a call on several cards: one NCCL rank a card);
``python3 chip_smoke.py --checks-only`` builds the kernels and runs
phases 9-11 alone.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CHR1_EXPECTED = 153_690_858
GENOME_EXPECTED = 99_159_827
Q1_EXPECTED = 16
WARM_QUERIES = 10
LEVEL_WARM_QUERIES = 2
TIMED_LAUNCHES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ZERO_LENGTH_SHARE = 0.01
HALF_OPEN_QUERY = (
    "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
    "AND a.pos_start < b.pos_end AND a.pos_end > b.pos_start"
)
# phase 3 shapes: B1 (table rows N, query rows M): an empty table, ragged
# M, the chr1 and genome padded view shapes in both directions; pack_view
# (rows, keys); B2 (real build rows, real queries): the pairs' own sizes in
# both directions; B3 (build rows, queries) up to its cap
B1_SHAPES = [(0, 300), (1, 1), (2048, 1000), (5000, 257), (65_536, 303_104),
             (303_104, 208_896), (7_684_096, 2_351_104), (2_351_104, 7_684_096)]
PACK_SHAPES = [(0, 1), (1000, 3), (1_000_003, 24), (7_684_096, 24)]
B2_SHAPES = [(0, 300), (1, 1), (5000, 257), (207_146, 302_381),
             (2_350_965, 7_684_066), (7_684_066, 2_350_965)]
B3_SHAPES = [(2048, 1000), (6144, 257), (303_104, 208_896), (1 << 20, 2_351_104)]
# phases 5a-5c: the 15M-row SELECT * pairing and the chr1 stream
MAT_PAIR = ((20_000, 13), (300_000, 14))
SELECT_STAR = (
    "SELECT * FROM s1 a JOIN s2 b ON a.contig = b.contig "
    "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
)
LEFT_JOIN = SELECT_STAR.replace(" JOIN ", " LEFT JOIN ", 1)
MAT_WARM_QUERIES = 3
STREAM_BATCH = 1_000_000
# phase 5e: probe tables (rows, seed) joined to the genome pair's build table
ROUTE_PROBES = [(100_000, 23), (1_000_000, 23)]
HOST_ROUTE = str(10**12)  # SEQUILA_HOST_THRESHOLD that keeps every join on the host
# phase 4f: the grouped count(*) over the genome pair (per-probe counts)
GROUPED_QUERY = (
    "SELECT b.contig, count(*) FROM s1 a JOIN s2 b ON a.contig = b.contig "
    "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end GROUP BY b.contig"
)
GENOME_CONTIGS = 24
GROUPED_WARM_QUERIES = 3
# phase 5f: nearest probe table (rows, seed) against the genome build, and
# the sparse build table (rows, seed) against the genome probes
NEAREST_PROBES = (1_000_000, 23)
NEAREST_SPARSE = (100_000, 24)
NEAREST_WARM_QUERIES = 2
# phase 5g: warm 15M host-route SELECT * queries with and without the
# allocator tuning
MALLOC_WARM_QUERIES = 5
# phase 5h: the genomic verbs over the genome pair in phase 4f's direction
# (the genome probes enriched with the genome build's overlaps)
VERB_WARM_CALLS = 3
VERB_CLOSEST_K = 3
# phase 6b: q2 through the port's CLI, (device, SEQUILA_HOST_THRESHOLD)
Q2_RUNS = (("cuda", None), ("cuda", "0"), ("cpu", None))
STRATEGIES = ("runs", "bounds", "emit")
# phase 7: Partitioned mode at target_partitions = 4 under each distribution
PART_TARGET = 4
PART_DISTS = ("auto", "hash", "shuffle", "skew")
BOUNDS_REPS = 3
# phase 8: Partitioned mode across processes
MP_SHAPES = (("8a", "gloo"), ("8b", "nccl"))
MP_DISTS = ("hash", "shuffle", "skew")
MP_TIMEOUT_S = 300  # one shape's ranks, start to end
MP_COLLECTIVE_TIMEOUT_S = 120
KERNELS = {  # name: (source, TPU kernel it replaces)
    "merge_rank_sorted": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:110"),
    # B1's level mode: every level's pair of Pallas launches in one
    "merge_level_ranks": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:615"),
    "pack_view": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:158"),
    # B1's per-probe mode: merge_probe_count_passes' two Pallas launches in one
    "merge_probe_ranks": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:229"),
    # merge_probe_count_passes' XLA scatters and subtraction
    "unpermute_counts": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:237"),
    # B1's verb mode: merge_verb_rank4's four Pallas launches in one
    "merge_verb_ranks": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:323"),
    # merge_verb_rank4's XLA scatter to probe row order
    "unpermute_ranks": ("merge_rank.cu", "sequila_tpu/ops/pallas/merge_count.py:345"),
    # B2 and B3: one merge path over (key, value) pairs
    "stream_rank_sorted": ("pair_merge.cu", "sequila_tpu/ops/pallas/stream_rank.py:86"),
    "rank_sorted_resident": ("pair_merge.cu", "sequila_tpu/ops/pallas/rank_kernel.py:126"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (res.stdout + res.stderr).strip()


def phase_toolchain(torch) -> str:
    print("== phase 1: toolchain", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print(f"device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"nvidia-smi: {card}")
    from sequila_tpu_torch.ops.cuda import _lib

    print(run([_lib._nvcc(), "--version"]).splitlines()[-1])
    print(run(["g++", "--version"]).splitlines()[0])
    for mod in ("triton", "pyarrow"):
        try:
            m = __import__(mod)
            print(f"{mod} {m.__version__}")
        except ImportError as e:
            print(f"{mod}: not importable ({e})")
    return card


def phase_build():
    print("== phase 2: build", flush=True)
    from sequila_tpu_torch.ops.cuda import _lib

    t0 = time.perf_counter()
    so_path, log = _lib.build()
    _lib.lib()
    print(f"built {os.path.relpath(so_path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_lib.NVCC_FLAGS)})")
    print(log.strip())


def sorted_u32(rng, n, torch, dev):
    """Sorted u32 values with duplicate runs and both sentinels, as the
    int32 bit patterns the kernels read."""
    base = rng.integers(0, 2**32 - 2, max(n // 4, 1), dtype=np.uint64)
    vals = rng.choice(base, n) if n else np.empty(0, np.uint64)
    if n >= 8:
        vals[-3:] = 0xFFFFFFFE
        vals[-1:] = 0xFFFFFFFF
        vals[:2] = 0
    vals = np.sort(vals.astype(np.uint32))
    return torch.from_numpy(vals.view(np.int32).copy()).to(dev)


def sorted_pairs(rng, n, size, nkeys, torch, dev):
    """(keys, values) sorted lexicographically on the card, padded with
    (PAD, PAD) to ``size`` rows: a few keys, half the values from a narrow
    range (duplicate runs longer than a chunk), the rest over all of int32."""
    from sequila_tpu_torch.ops.cuda.stream_rank import sorted_padded

    k = rng.integers(-1, nkeys, n).astype(np.int32)
    v = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    v[: n // 2] = rng.integers(-40, 40, n // 2)
    ks, vs, _ = sorted_padded(torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev), size)
    return ks, vs


def max_diff(torch, got, want) -> int:
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def global_rank(torch, a_k, a_v, q_k, q_v, strict):
    from sequila_tpu_torch.ops.ranks import composite

    return torch.searchsorted(composite(a_k, a_v), composite(q_k, q_v), right=not strict)


def phase_kernels(torch, dev) -> dict:
    print("== phase 3: kernels vs plain (exact)", flush=True)
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.cuda import stream_rank as sr

    rng = np.random.default_rng(0)
    err = dict.fromkeys(KERNELS, 0)
    for n, m in B1_SHAPES:
        a = sorted_u32(rng, n, torch, dev)
        q = sorted_u32(rng, m, torch, dev)
        for strict in (True, False):
            got = mc.merge_rank_sorted(a, q, strict=strict)
            want = mc.merge_rank_plain(a, q, strict=strict)
            d = max_diff(torch, got, want)
            s_got = int(mc.merge_rank_sorted(a, q, strict=strict, reduce=True))
            s_want = int(mc.merge_rank_plain(a, q, strict=strict, reduce=True))
            err["merge_rank_sorted"] = max(err["merge_rank_sorted"], d, abs(s_got - s_want))
            if d or s_got != s_want:
                fail(f"merge_rank_sorted N={n} M={m} strict={strict}: "
                     f"max |diff| {d}, sums {s_got} vs {s_want}")
        print(f"merge_rank_sorted N={n} M={m}: ranks and sums equal for strict=True/False")
    for n, nkeys in PACK_SHAPES:
        k_h = rng.integers(0, nkeys, n).astype(np.int32)
        k_h[rng.random(n) < 0.01] = 2**31 - 1  # PAD rows
        k = torch.from_numpy(k_h)
        v = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))
        c = torch.from_numpy(
            rng.integers(0, 2**32, nkeys, dtype=np.uint64).astype(np.uint32).view(np.int32)
        )
        k, v, c = k.to(dev), v.to(dev), c.to(dev)
        for pad in (mc.BUILD_PAD, mc.PROBE_PAD):
            got = mc.pack_view(k, v, c, pad)
            want = mc.pack_view_plain(k, v, c, pad)
            d = int((mc.as_u32(got) - mc.as_u32(want)).abs().max()) if n else 0
            err["pack_view"] = max(err["pack_view"], d)
            if d:
                fail(f"pack_view n={n} pad={pad:#x}: max |diff| {d}")
        print(f"pack_view n={n} keys={nkeys}: equal for both sentinels")

    # B2: builds pad to CHUNK, queries to BLOCK for the windows, and the
    # kernel gets the queries ragged
    for n, m in B2_SHAPES:
        a_k, a_v = sorted_pairs(rng, n, -(-n // sr.CHUNK) * sr.CHUNK, 24, torch, dev)
        q_k, q_v = sorted_pairs(rng, m, -(-m // sr.BLOCK) * sr.BLOCK, 25, torch, dev)
        c_lo, n_ch = sr.device_windows(a_k, a_v, q_k, q_v)
        a2 = torch.stack([a_k, a_v])
        q_k, q_v = q_k[:m], q_v[:m]
        for strict in (True, False):
            args = (a2, c_lo, n_ch, q_k, q_v)
            got = sr.stream_rank_sorted(*args, strict=strict)
            want = sr.stream_rank_plain(*args, strict=strict)
            d = max(max_diff(torch, got, want),
                    max_diff(torch, got, global_rank(torch, a_k, a_v, q_k, q_v, strict)))
            s_got = int(sr.stream_rank_sorted(*args, strict=strict, reduce=True))
            s_want = int(sr.stream_rank_plain(*args, strict=strict, reduce=True))
            err["stream_rank_sorted"] = max(err["stream_rank_sorted"], d, abs(s_got - s_want))
            if d or s_got != s_want:
                fail(f"stream_rank_sorted n={n} m={m} strict={strict}: "
                     f"max |diff| {d}, sums {s_got} vs {s_want}")
        print(f"stream_rank_sorted n={n} m={m} (windows of up to {int(n_ch.max()) if m else 0} "
              f"chunks): ranks, sums and the global rank equal for strict=True/False")

    for n_pad, m in B3_SHAPES:
        a_k, a_v = sorted_pairs(rng, n_pad - 5, n_pad, 24, torch, dev)
        q_k, q_v = sorted_pairs(rng, m, m, 25, torch, dev)
        for strict in (True, False):
            args = (a_k, a_v, q_k, q_v)
            got = rk.rank_sorted_resident(*args, strict=strict)
            want = rk.rank_resident_plain(*args, strict=strict)
            d = max(max_diff(torch, got, want),
                    max_diff(torch, got, global_rank(torch, *args, strict)))
            s_got = int(rk.rank_sorted_resident(*args, strict=strict, reduce=True))
            s_want = int(rk.rank_resident_plain(*args, strict=strict, reduce=True))
            err["rank_sorted_resident"] = max(err["rank_sorted_resident"], d, abs(s_got - s_want))
            if d or s_got != s_want:
                fail(f"rank_sorted_resident n={n_pad} m={m} strict={strict}: "
                     f"max |diff| {d}, sums {s_got} vs {s_want}")
        print(f"rank_sorted_resident n={n_pad} m={m}: ranks and sums equal the global "
              f"rank for strict=True/False")
    pair_edge_cases(torch, dev, rng, err)
    segmented_cases(torch, dev, rng, err)
    torch.cuda.synchronize()
    return err


def pair_edge_cases(torch, dev, rng, err):
    """One launch of the pair merge path (B2 and B3's kernel) over edge
    segments, for both strict values: an empty table, empty queries, a
    1-row table, tables far larger and far smaller than their queries, a
    duplicate run longer than a tile, B2's exact windows and too-narrow
    ones; each segment writes its ranks and adds its sum, held against the
    plain version on copies of the same slots, exact."""
    from sequila_tpu_torch.ops.cuda import pair_merge as pm
    from sequila_tpu_torch.ops.cuda import stream_rank as sr

    cases = [  # (table rows, queries, windows: None, "exact" or "narrow")
        (0, 3000, None), (0, 257, "exact"), (4000, 0, None), (1, 70_000, "exact"),
        (1, 1, None), (1_000_003, 37, None), (37, 1_000_003, "exact"),
        (50_000, 20_011, "exact"), (20_011, 50_000, None),
        (7 * pm.TILE + 3, 5 * pm.TILE, None), (6 * pm.CHUNK, 3000, "narrow"),
    ]
    for flip in (False, True):
        cols = [[], [], [], [], [], []]  # a_k, a_v, q_k, q_v, c_lo, n_chunks
        segs, off = [], [0, 0, 0]  # table, queries, windows
        for i, (n, m, win) in enumerate(cases):
            a_k, a_v = sorted_pairs(rng, n, n, 24, torch, dev)
            if i == 9:  # duplicate runs longer than a tile
                run = torch.arange(n, device=dev) // (3 * pm.TILE) * (3 * pm.TILE)
                a_k, a_v = a_k[run], a_v[run]
            q_k, q_v = sorted_pairs(rng, m, -(-m // pm.BLOCK) * pm.BLOCK, 25, torch, dev)
            kw = {}
            if win is not None:
                blocks = -(-m // pm.BLOCK)
                if win == "exact":
                    c_lo, n_ch = sr.device_windows(a_k, a_v, q_k, q_v)
                else:
                    c_lo = torch.from_numpy(rng.integers(0, n // pm.CHUNK, blocks)).to(dev)
                    n_ch = torch.from_numpy(rng.integers(-1, 2, blocks)).to(dev)
                cols[4].append(c_lo.to(torch.int32))
                cols[5].append(n_ch.to(torch.int32))
                kw = dict(c_lo=(6, off[2]), n_chunks=(7, off[2]))
                off[2] += blocks
            segs.append(pm.PairSegment(
                n, m, a_k=(0, off[0]), a_v=(1, off[0]), q_k=(2, off[1]), q_v=(3, off[1]),
                strict=(i % 2 == 1) != flip, out=(4, off[1]), total=(5, i), **kw))
            for c, t in zip(cols, (a_k, a_v, q_k[:m], q_v[:m])):
                c.append(t)
            off[0] += n
            off[1] += m
        slots = (*(torch.cat(c) for c in cols[:4]),
                 torch.full((off[1],), -1, dtype=torch.int32, device=dev),
                 torch.zeros(len(cases), dtype=torch.int64, device=dev),
                 *(torch.cat(c) for c in cols[4:]))
        want = tuple(t.clone() for t in slots)
        before = pm.pair_merge_segments.launches
        pm.pair_merge_segments(pm.plan_pair_segments(segs, dev), slots)
        torch.cuda.synchronize()
        if pm.pair_merge_segments.launches != before + 1:
            fail(f"pair merge edge segments: {pm.pair_merge_segments.launches - before} "
                 "launches, not 1")
        pm.pair_segments_plain(segs, want)
        d = max(max_diff(torch, g, w) for g, w in zip(slots, want))
        err["stream_rank_sorted"] = max(err["stream_rank_sorted"], d)
        err["rank_sorted_resident"] = max(err["rank_sorted_resident"], d)
        if d:
            fail(f"pair merge edge segments (flip={flip}): max |diff| {d} against plain")
        print(f"pair merge: {len(segs)} edge segments (flip={flip}) in one launch, ranks "
              "and sums equal plain")


def perm(torch, rng, n, dev):
    return torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)


def check_segments(torch, label, segs, slots, err):
    """One launch of ``segs`` over ``slots`` against the plain version on
    copies of the same slots, exact."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    want = tuple(t.clone() for t in slots)
    before = mc.merge_rank_sorted.launches
    mc.merge_rank_segments(mc.plan_segments(segs, slots[0].device), slots)
    torch.cuda.synchronize()
    if mc.merge_rank_sorted.launches != before + 1:
        fail(f"segmented {label}: {mc.merge_rank_sorted.launches - before} launches, not 1")
    mc.merge_rank_segments_plain(segs, want)
    d = max(max_diff(torch, g, w) for g, w in zip(slots, want))
    err["merge_rank_sorted"] = max(err["merge_rank_sorted"], d)
    if d:
        fail(f"segmented {label}: max |diff| {d} against the plain version")
    print(f"segmented {label}: one launch, ranks through the orders and sums equal plain")


def segmented_cases(torch, dev, rng, err):
    """The segmented launch: S = 1 at every B1 shape, S = 2 at the genome
    count shape, and one launch of many edge segments (empty table, empty
    queries, a 1-row table, tables far larger and far smaller than their
    queries, duplicate runs longer than a tile, both sentinels, raw and
    packed tables), each segment with ranks through a random permutation
    and a sum, both strict values."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    for n, m in B1_SHAPES:
        a, q = sorted_u32(rng, n, torch, dev), sorted_u32(rng, m, torch, dev)
        for strict in (True, False):
            s = mc.Segment(n, m, q=(1, 0), strict=strict, a=(0, 0), out=(2, 0),
                           ord=perm(torch, rng, m, dev), total=(3, 0))
            slots = (a, q, torch.full((m,), -1, dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int64, device=dev))
            check_segments(torch, f"S=1 N={n} M={m} strict={strict}", [s], slots, err)

    n, m = B1_SHAPES[-2]
    a1, q1, a2, q2 = (sorted_u32(rng, x, torch, dev) for x in (n, m, n, m))
    for flip in (False, True):
        segs = [s._replace(strict=s.strict != flip, out=(5, i * m), ord=perm(torch, rng, m, dev))
                for i, s in enumerate(mc.count_segments(n, m, n, m))]
        slots = (a1, q1, a2, q2, torch.zeros(2, dtype=torch.int64, device=dev),
                 torch.full((2 * m,), -1, dtype=torch.int32, device=dev))
        check_segments(torch, f"S=2 (inline) N={n} M={m} strict={[s.strict for s in segs]}",
                       segs, slots, err)

    cases = [  # (table rows, queries, raw table)
        (0, 3000, False), (0, 257, True), (4000, 0, False), (1, 70_000, True),
        (1, 1, False), (1_000_003, 37, False), (37, 1_000_003, True),
        (50_000, 20_011, True), (20_011, 50_000, False), (7 * mc.TILE + 3, 5 * mc.TILE, False),
    ]
    for flip in (False, True):
        tabs, qs, segs = [], [], []
        a_off = q_off = 0
        for i, (n, m, raw) in enumerate(cases):
            a = sorted_u32(rng, n, torch, dev)
            if i == len(cases) - 1 and n:  # duplicate runs longer than a tile
                a = a[torch.arange(n, device=dev) // (3 * mc.TILE) * (3 * mc.TILE)]
            q = sorted_u32(rng, m, torch, dev)
            strict = (i % 2 == 1) != flip
            common = dict(q=(1, q_off), strict=strict, out=(2, q_off), ord=perm(torch, rng, m, dev),
                          total=(3, i))
            if raw:  # the same packed values, as key codes and values through a C table
                k = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
                c = torch.tensor([7, -(2**31), 5], dtype=torch.int32, device=dev)
                v = ((a.to(torch.int64) - c.to(torch.int64)[k.long()]) & 0xFFFFFFFF)
                v = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
                segs.append(mc.Segment(n, m, raw=(k, v, c, mc.PROBE_PAD), **common))
            else:
                segs.append(mc.Segment(n, m, a=(0, a_off), **common))
                tabs.append(a)
                a_off += n
            qs.append(q)
            q_off += m
        slots = (torch.cat(tabs), torch.cat(qs),
                 torch.full((q_off,), -1, dtype=torch.int32, device=dev),
                 torch.zeros(len(cases), dtype=torch.int64, device=dev))
        check_segments(torch, f"S={len(segs)} edge segments (flip={flip})", segs, slots, err)


def joint_codes(t1: dict, t2: dict):
    """Joint contig codes of two tables (int64 numpy)."""
    keys = np.unique(np.concatenate([t1["contig"], t2["contig"]]))
    return np.searchsorted(keys, t1["contig"]), np.searchsorted(keys, t2["contig"])


def bits_count(t1: dict, t2: dict) -> int:
    """Independent numpy BITS count of the overlap join t1 x t2 on contig:
    sum over build rows of #{probe start <= end} - #{probe end < start}
    within the same contig, on int64 (contig, value) composites."""
    c1, c2 = joint_codes(t1, t2)
    kb = c1.astype(np.int64) << 32
    kq = c2.astype(np.int64) << 32
    qs = np.sort(kq | (t2["pos_start"] + 2**31))
    qe = np.sort(kq | (t2["pos_end"] + 2**31))
    ub = np.searchsorted(qs, kb | (t1["pos_end"] + 2**31), side="right")
    lb = np.searchsorted(qe, kb | (t1["pos_start"] + 2**31), side="left")
    lo = np.searchsorted(qe, kb, side="left")  # same-key segment starts
    lo_s = np.searchsorted(qs, kb, side="left")
    return int((ub - lo_s).sum() - (lb - lo).sum())


def time_events(torch, fn, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the least time an H100 SXM could take for the
    work, the larger of the bytes over 3.35 TB/s and the operations over
    67 T/s (the float32 rate outside the tensor cores in NVIDIA's data
    sheet, taken for the integer compares and adds of these kernels)."""
    t_bytes, t_ops = nbytes_ / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(torch, name, plain, kern, library, nbytes_, ops, shape, card) -> dict:
    """CUDA-event times in turns plain, kernel, kernel, plain, then the
    library call; with the bound of the same work."""
    p1 = time_events(torch, plain, TIMED_LAUNCHES)
    k1 = time_events(torch, kern, TIMED_LAUNCHES)
    k2 = time_events(torch, kern, TIMED_LAUNCHES)
    p2 = time_events(torch, plain, TIMED_LAUNCHES)
    lib = time_events(torch, library, TIMED_LAUNCHES) if library is not None else None
    b_ms, b_by = bound(nbytes_, ops)
    k = (k1 + k2) / 2
    print(f"{name} ({shape}): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
          f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes_} bytes), {100 * b_ms / k:.1f} % of the bound [{card}]",
          flush=True)
    return {"ms": k, "plain_ms": (p1 + p2) / 2, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by}


def reset_launches():
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.cuda import stream_rank as sr

    wrappers = {
        "merge_rank_sorted": mc.merge_rank_sorted, "pack_view": mc.pack_view,
        "unpermute_ranks": mc.unpermute_ranks, "unpermute_counts": mc.unpermute_counts,
        "stream_rank_sorted": sr.stream_rank_sorted,
        "rank_sorted_resident": rk.rank_sorted_resident,
    }
    for w in wrappers.values():
        w.launches = 0
    return lambda: {name: w.launches for name, w in wrappers.items()}


def route_of(session, kind: str = "count") -> str:
    """The route the session's last query took, from its route metric
    ``<kind>_route_<name>`` (kind: count, emit, probe_count, nearest)."""
    prefix = f"{kind}_route_"
    routes = [k for c in session.last_metrics.counters.values() for k in c
              if k.startswith(prefix)]
    if len(routes) != 1:
        fail(f"expected one {kind} route metric, got {routes}")
    return routes[0][len(prefix):]


def count(session, query: str) -> int:
    return int(session.sql(query).column_np(0)[0])


def warm_ms(torch, session, query, expected, n, label, card) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        got = count(session, query)
        ts.append(time.perf_counter() - t0)
        if got != expected:
            fail(f"{label}: warm query returned {got}, expected {expected}")
    med = float(np.median(ts)) * 1e3
    print(f"{label}: warm median {med:.3f} ms/query over {n} queries, "
          f"min {min(ts) * 1e3:.3f} ms [{card}]", flush=True)
    return med


def phase_main_path(torch, card):
    print("== phase 4: main path through SessionContext(device='cuda').sql", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.session import SessionContext

    pairs = [
        ("chr1", bd.gen_chain_table(bd.N_LEFT, seed=1),
         bd.gen_chain_table(bd.N_RIGHT, seed=2), CHR1_EXPECTED),
        ("genome", bd.gen_genome_table(bd.GENOME_LEFT, 21),
         bd.gen_genome_table(bd.GENOME_RIGHT, 22), GENOME_EXPECTED),
    ]
    sessions = []
    for name, t1, t2, expected in pairs:
        ref = bits_count(t1, t2)
        if ref != expected:
            fail(f"{name}: numpy BITS reference {ref} != expected {expected}")
        ctx = SessionContext(device="cuda")
        ctx.register_table("s1", pa.table(t1))
        ctx.register_table("s2", pa.table(t2))
        sessions.append((name, ctx, expected, t1, t2))
        print(f"{name}: {len(t1['contig'])} x {len(t2['contig'])} rows, "
              f"numpy BITS reference {ref}")

    launches = reset_launches()
    for name, ctx, expected, _, _ in sessions:
        got = count(ctx, bd.QUERY)
        if got != expected:
            fail(f"{name}: port returned {got}, expected {expected}")
        if route_of(ctx) != "merge":
            fail(f"{name}: the default backend answered on route {route_of(ctx)}")
    torch.cuda.synchronize()
    merge_launches = launches()
    print(f"main path counts correct on the merge route; kernel launches: {merge_launches}")
    for kname in ("pack_view", "merge_rank_sorted"):
        if merge_launches[kname] <= 0:
            fail(f"kernel {kname} was not launched by the main path")
    # a warm count(*): both BITS passes in one segmented B1 launch
    name, ctx, expected, _, _ = sessions[1]
    launches = reset_launches()
    if count(ctx, bd.QUERY) != expected:
        fail(f"{name}: the warm query's count differs")
    torch.cuda.synchronize()
    warm = launches()
    if (warm["merge_rank_sorted"], warm["pack_view"]) != (1, 4):
        fail(f"a warm merge count(*) launched {warm}, expected B1 once and pack_view 4 times")
    print(f"warm {name} count(*): B1 launched once, pack_view 4 times")
    return sessions, merge_launches


def phase_backends(torch, sessions):
    print("== phase 4b: the stream and cosort count backends", flush=True)
    from sequila_tpu_torch import bench_data as bd

    out = {}
    for backend in ("stream", "cosort"):
        os.environ["SEQUILA_COUNT_BACKEND"] = backend
        launches = reset_launches()
        for name, ctx, expected, _, _ in sessions:
            t0 = time.perf_counter()
            got = count(ctx, bd.QUERY)
            cold = time.perf_counter() - t0
            if got != expected:
                fail(f"{name} backend={backend}: port returned {got}, expected {expected}")
            if route_of(ctx) != backend:
                fail(f"{name} backend={backend}: answered on route {route_of(ctx)}")
            print(f"{name} backend={backend}: {got} on route {backend}, first query "
                  f"{cold:.3f} s")
        torch.cuda.synchronize()
        out[backend] = launches()
        print(f"backend={backend}: kernel launches {out[backend]}")
        if backend == "stream":  # a warm stream count(*): both passes in one B2 launch
            name, ctx, expected, _, _ = sessions[1]
            warm = reset_launches()
            if count(ctx, bd.QUERY) != expected:
                fail(f"{name} backend=stream: the warm query's count differs")
            torch.cuda.synchronize()
            warm = warm()
            if warm != {**dict.fromkeys(warm, 0), "stream_rank_sorted": 1}:
                fail(f"a warm stream count(*) launched {warm}, expected B2 once and nothing else")
            print(f"warm {name} stream count(*): B2 launched once (both passes)")
    del os.environ["SEQUILA_COUNT_BACKEND"]
    if out["stream"]["stream_rank_sorted"] <= 0:
        fail("kernel stream_rank_sorted was not launched by the stream route")
    if out["cosort"]["merge_rank_sorted"] or out["cosort"]["stream_rank_sorted"]:
        fail(f"the cosort route launched a rank kernel: {out['cosort']}")
    return out["stream"]


def phase_level(torch, sessions, card):
    print("== phase 4c: the level loop at full size (degenerate probes)", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch.exec.context import ExecContext
    from sequila_tpu_torch.native.loader import available
    from sequila_tpu_torch.ops.host_join import make_host_index
    from sequila_tpu_torch.session import SessionContext

    _, _, _, t1, t2 = sessions[1]
    rng = np.random.default_rng(3)
    ends = t2["pos_end"].copy()
    zero = rng.random(len(ends)) < ZERO_LENGTH_SHARE
    ends[zero] = t2["pos_start"][zero]  # zero-length rows (insertions)
    t2z = dict(t2, pos_end=ends)
    if not available():
        fail("the native host library did not build: no independent level check")
    t0 = time.perf_counter()
    c1, c2 = joint_codes(t1, t2z)
    # the half-open predicate, normalized as the planner does: end - 1
    hidx = make_host_index(c1.astype(np.int32), t1["pos_start"].astype(np.int32),
                           (t1["pos_end"] - 1).astype(np.int32))
    want = int(hidx.counts(c2.astype(np.int32), t2z["pos_start"].astype(np.int32),
                           (ends - 1).astype(np.int32)).sum())
    print(f"genome pair, {int(zero.sum())} zero-length probe rows: native host index "
          f"counts {want} in {time.perf_counter() - t0:.2f} s")
    ctx = SessionContext(device="cuda")
    ctx.register_table("s1", pa.table(t1))
    ctx.register_table("s2", pa.table(t2z))
    times = {}
    for alg, method in (("Coitrees", "sort"), ("IntervalTree", "bsearch")):
        ctx.sql(f"SET sequila.interval_join_algorithm = {alg}")
        t0 = time.perf_counter()
        got = count(ctx, HALF_OPEN_QUERY)
        cold = time.perf_counter() - t0
        if got != want:
            fail(f"level loop ({alg}): port returned {got}, native host index {want}")
        if route_of(ctx) != "level":
            fail(f"level query ({alg}) answered on route {route_of(ctx)}")
        join = ctx.plan_sql(HALF_OPEN_QUERY).children[0]
        index = join._prepare(ExecContext(ctx.config), ctx.table("s1"), ctx.table("s2"))[0]
        print(f"level loop {alg} ({method}): {got} == native host index; "
              f"{index.num_levels} levels {index.level_sizes}; first query {cold:.3f} s")
        times[f"level_{method}"] = warm_ms(torch, ctx, HALF_OPEN_QUERY, want,
                                           LEVEL_WARM_QUERIES, f"level loop {alg}", card)
    return times


def phase_resident(torch, dev):
    print("== phase 4d: rank_lex_resident (B3's entry point) at its cap", flush=True)
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.ranks import rank_lex_sort

    rng = np.random.default_rng(4)
    n, m = B3_SHAPES[-1]
    cols = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 24, n).astype(np.int32),
        rng.integers(0, 250_000_000, n).astype(np.int32),
        rng.integers(0, 25, m).astype(np.int32),
        rng.integers(0, 250_000_000, m).astype(np.int32),
    )]
    launches = reset_launches()
    out = {}
    for side in ("left", "right"):
        got = rk.rank_lex_resident(cols[:2], cols[2:], side)
        torch.cuda.synchronize()
        out[side] = got
    ran = launches()
    for side, got in out.items():
        d = max_diff(torch, got, rank_lex_sort(cols[:2], cols[2:], side))
        if d:
            fail(f"rank_lex_resident side={side}: max |diff| {d} against rank_lex_sort")
    print(f"rank_lex_resident n={n} m={m}: equal to rank_lex_sort on both sides; "
          f"launches {ran}")
    if ran["rank_sorted_resident"] <= 0:
        fail("kernel rank_sorted_resident was not launched by rank_lex_resident")
    return ran, cols


def phase_times(torch, sessions, card, err, resident_cols):
    print("== phase 4e: warm route times and kernel vs plain times", flush=True)
    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.cuda import pair_merge as pm
    from sequila_tpu_torch.ops.cuda import rank_kernel as rk
    from sequila_tpu_torch.ops.cuda import stream_rank as sr
    from sequila_tpu_torch.ops.cuda.stream_rank import sorted_padded
    from sequila_tpu_torch.ops.ranks import composite

    times = {}
    for name, ctx, expected, _, _ in sessions:
        times[f"{name}_merge"] = warm_ms(torch, ctx, bd.QUERY, expected, WARM_QUERIES,
                                         f"{name} merge", card)
    name, ctx, expected, _, _ = sessions[1]
    for backend in ("stream", "cosort"):
        os.environ["SEQUILA_COUNT_BACKEND"] = backend
        times[f"{name}_{backend}"] = warm_ms(torch, ctx, bd.QUERY, expected, WARM_QUERIES,
                                             f"{name} {backend}", card)
    del os.environ["SEQUILA_COUNT_BACKEND"]

    # kernel vs plain at the genome main-path shapes: the plans' own device
    # tensors, turns plain, kernel, kernel, plain
    join = ctx.plan_sql(bd.QUERY).children[0]
    left, right = ctx.table("s1"), ctx.table("s2")
    inputs = join._sorted_count_inputs(left, right)
    plan = join._merge_count_plan(left, right, *inputs)
    bq_k, bq_v, c_bq, pq_k, pq_v, c_pq = plan[:6]
    q1 = mc.pack_view(bq_k, bq_v, c_bq, mc.BUILD_PAD)
    a1 = mc.pack_view(pq_k, pq_v, c_pq, mc.PROBE_PAD)
    q2 = mc.pack_view(*plan[6:9], mc.BUILD_PAD)
    a2 = mc.pack_view(*plan[9:12], mc.PROBE_PAD)
    l_on, r_on, bs_cd, be_cd, qs_cd, qe_cd = inputs[:6]
    deltas = dict(d_bs=bs_cd[1], d_be=be_cd[1], d_qs=qs_cd[1], d_qe=qe_cd[1])
    splan = join._stream_count_plan(left, right, *inputs)
    pass_u, pass_l = sr.stream_pass_inputs(*splan, **deltas)
    d = max(max_diff(torch, sr.stream_rank_sorted(*pass_u, strict=False),
                     sr.stream_rank_plain(*pass_u, strict=False)),
            max_diff(torch, sr.stream_rank_sorted(*pass_u, strict=False),
                     global_rank(torch, pass_u[0][0], pass_u[0][1], *pass_u[3:], False)))
    err["stream_rank_sorted"] = max(err["stream_rank_sorted"], d)
    if d:
        fail(f"stream_rank_sorted at the genome pair's own windows: max |diff| {d}")
    print(f"stream_rank_sorted at the genome pair's own stream windows: equal to plain "
          f"and to the global rank (windows of up to {int(pass_u[2].max())} chunks)")
    # both stream passes in one launch, as stream_count_passes makes it
    count_launch, totals = sr.stream_count_launcher(pass_u, pass_l)
    count_launch()
    want = [int(sr.stream_rank_plain(*pass_u, strict=False, reduce=True)),
            int(sr.stream_rank_plain(*pass_l, strict=True, reduce=True))]
    if totals.tolist() != want:
        fail(f"the stream count's launch: sums {totals.tolist()} != plain {want}")
    print(f"stream_count_passes' launch (both passes): sums {want} equal plain")
    a_k, a_v, _ = sorted_padded(*resident_cols[:2], resident_cols[0].numel())
    r_k, r_v, _ = sorted_padded(*resident_cols[2:], resident_cols[2].numel())
    # the library yardsticks' inputs, built outside the timed window: u32
    # bit patterns XOR the sign bit (signed order = unsigned order), and
    # int64 (key, value) composites
    a1_s, q1_s = (t ^ torch.tensor(-(2**31), dtype=torch.int32, device=t.device) for t in (a1, q1))
    u_a, u_q = composite(pass_u[0][0], pass_u[0][1]), composite(*pass_u[3:])
    l_a, l_q = composite(pass_l[0][0], pass_l[0][1]), composite(*pass_l[3:])
    r_a, r_q = composite(a_k, a_v), composite(r_k, r_v)
    ranks1 = torch.empty(q1.numel(), dtype=torch.int32, device=q1.device)
    # B2 and B3 alone: their wrappers' one-segment plans, launched bare
    u_total = torch.zeros(1, dtype=torch.int64, device=a1.device)
    b2_launch = pm.segments_launcher(
        pm._rank_plan(pass_u[0].shape[1], pass_u[3].numel(), False, True, True, a1.device),
        (pass_u[0][0], pass_u[0][1], *pass_u[3:], u_total, *pass_u[1:3]), sr.stream_rank_sorted)
    r_ranks = torch.empty(r_k.numel(), dtype=torch.int32, device=r_k.device)
    b3_launch = pm.segments_launcher(
        pm._rank_plan(a_k.numel(), r_k.numel(), True, False, False, a_k.device),
        (a_k, a_v, r_k, r_v, r_ranks), rk.rank_sorted_resident)
    cases = {  # name: (plain, kernel, library or None, bytes moved, operations, shape)
        "pack_view": (
            lambda: mc.pack_view_plain(pq_k, pq_v, c_pq, mc.PROBE_PAD),
            lambda: mc.pack_view(pq_k, pq_v, c_pq, mc.PROBE_PAD),
            None, nbytes(pq_k, pq_v, c_pq) + 4 * pq_k.numel(), pq_k.numel(),
            f"n={pq_k.numel()}",
        ),
        "merge_rank_sorted": (  # the launch alone; the wrapper is timed below
            lambda: mc.merge_rank_plain(a1, q1, strict=False),
            mc.segments_launcher(mc.plan_segments(
                [mc.Segment(a1.numel(), q1.numel(), q=(1, 0), strict=False, a=(0, 0),
                            out=(2, 0))], a1.device), (a1, q1, ranks1)),
            lambda: torch.searchsorted(a1_s, q1_s, right=True, out_int32=True, out=ranks1),
            nbytes(a1, q1, ranks1), a1.numel() + q1.numel(),
            f"N={a1.numel()} M={q1.numel()} ranks",
        ),
        "stream_rank_sorted": (  # the launch alone
            lambda: sr.stream_rank_plain(*pass_u, strict=False, reduce=True),
            b2_launch,
            lambda: torch.searchsorted(u_a, u_q, right=True),
            nbytes(*pass_u) + 8, pass_u[0].shape[1] + pass_u[3].numel(),
            f"N={pass_u[0].shape[1]} M={pass_u[3].numel()} reduce=True, the genome "
            "pair's stream pass u, bare launch",
        ),
        "rank_sorted_resident": (  # the launch alone
            lambda: rk.rank_resident_plain(a_k, a_v, r_k, r_v, strict=True),
            b3_launch,
            lambda: torch.searchsorted(r_a, r_q, out_int32=True, out=r_ranks),
            nbytes(a_k, a_v, r_k, r_v, r_ranks), a_k.numel() + r_k.numel(),
            f"N={a_k.numel()} M={r_k.numel()} ranks, bare launch",
        ),
    }
    kernel_ms = {name: time_kernel(torch, name, *case, card) for name, case in cases.items()}
    # B2 and B3 through their wrappers, host work included
    time_kernel(
        torch, "stream_rank_sorted wrapper",
        lambda: sr.stream_rank_plain(*pass_u, strict=False, reduce=True),
        lambda: sr.stream_rank_sorted(*pass_u, strict=False, reduce=True), None,
        nbytes(*pass_u) + 8, pass_u[0].shape[1] + pass_u[3].numel(), "reduce=True", card)
    time_kernel(
        torch, "rank_sorted_resident wrapper",
        lambda: rk.rank_resident_plain(a_k, a_v, r_k, r_v, strict=True),
        lambda: rk.rank_sorted_resident(a_k, a_v, r_k, r_v, strict=True), None,
        nbytes(a_k, a_v, r_k, r_v, r_ranks), a_k.numel() + r_k.numel(), "ranks", card)
    # both stream passes in one launch; the library yardstick is two calls
    time_kernel(
        torch, "stream_count_passes' B2 launch (both passes)",
        lambda: (sr.stream_rank_plain(*pass_u, strict=False, reduce=True)
                 - sr.stream_rank_plain(*pass_l, strict=True, reduce=True)),
        count_launch,
        lambda: (torch.searchsorted(u_a, u_q, right=True), torch.searchsorted(l_a, l_q)),
        nbytes(*pass_u, *pass_l) + 16,
        sum(p[0].shape[1] + p[3].numel() for p in (pass_u, pass_l)),
        "S=2, sums; library: two torch.searchsorted calls", card)
    whole = time_events(torch, lambda: sr.stream_count_passes(*splan, **deltas), TIMED_LAUNCHES)
    print(f"stream_count_passes whole (its glue and 1 B2 launch, host work included): "
          f"{whole:.4f} ms [{card}]", flush=True)
    # beside them: the wrapper with its host work, as the main path calls
    # it, in ranks and (for continuity with the first design's records)
    # reduce mode, and the count's two passes in one segmented launch
    for reduce in (False, True):
        time_kernel(
            torch, f"merge_rank_sorted wrapper, reduce={reduce}",
            lambda: mc.merge_rank_plain(a1, q1, strict=False, reduce=reduce),
            lambda: mc.merge_rank_sorted(a1, q1, strict=False, reduce=reduce),
            None, nbytes(a1, q1) + (8 if reduce else 4 * q1.numel()), a1.numel() + q1.numel(),
            f"N={a1.numel()} M={q1.numel()}", card)
    segs = mc.count_segments(a1.numel(), q1.numel(), a2.numel(), q2.numel())
    totals = torch.zeros(2, dtype=torch.int64, device=a1.device)
    time_kernel(
        torch, "merge_count_passes' B1 launch (both passes)",
        lambda: mc.merge_rank_segments_plain(segs, (a1, q1, a2, q2, totals)),
        mc.segments_launcher(mc.plan_segments(segs, a1.device), (a1, q1, a2, q2, totals)),
        None, nbytes(a1, q1, a2, q2) + 16, a1.numel() + q1.numel() + a2.numel() + q2.numel(),
        "S=2, sums", card)
    whole = time_events(torch, lambda: mc.merge_count_passes(*plan[:12]), TIMED_LAUNCHES)
    print(f"merge_count_passes whole (4 pack_view and 1 B1 launch, host work included): "
          f"{whole:.4f} ms [{card}]", flush=True)
    return kernel_ms, times


def phase_grouped(torch, sessions, card, err):
    print("== phase 4f: grouped count(*) over the genome pair (per-probe counts)", flush=True)
    from sequila_tpu_torch.exec.context import ExecContext
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.host_join import make_host_index

    name, ctx, expected, t1, t2 = sessions[1]

    def grouped(route):
        out, dt = timed_select(torch, ctx, GROUPED_QUERY)
        if route_of(ctx, "probe_count") != route:
            fail(f"grouped count: answered on route {route_of(ctx, 'probe_count')}, "
                 f"expected {route}")
        total = int(out.column_np(1).astype(np.int64).sum())
        if total != expected or out.num_rows != GENOME_CONTIGS:
            fail(f"grouped count on route {route}: {out.num_rows} groups summing to "
                 f"{total}, expected {GENOME_CONTIGS} summing to {expected}")
        return out, dt

    def warm(route, *done):
        ts = [*done, *(grouped(route)[1] for _ in range(GROUPED_WARM_QUERIES - len(done)))]
        return float(np.median(ts)) * 1e3, min(ts) * 1e3

    def probe_counts_ms():
        """(per-probe counts, warm ms) of the join alone, outside the
        grouping (the counts land on the host)."""
        join.per_probe_counts(ectx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = join.per_probe_counts(ectx)
        return counts, (time.perf_counter() - t0) * 1e3

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    kernels = ("merge_rank_sorted", "pack_view", "unpermute_counts")
    launches = reset_launches()
    merge_out, cold = grouped("merge")
    torch.cuda.synchronize()
    ran = launches()
    if not all(ran[k] > 0 for k in kernels):
        fail(f"the grouped count's merge route launched {ran}")
    launches = reset_launches()
    _, warm1 = grouped("merge")
    torch.cuda.synchronize()
    one = launches()
    if tuple(one[k] for k in kernels) != (1, 2, 1):
        fail(f"a warm grouped count launched {one}, expected B1 once, pack_view twice and "
             "unpermute_counts once")
    med, low = warm("merge", warm1)
    join = interval_join_of(ctx.plan_sql(GROUPED_QUERY))
    left, right = ctx.table("s1"), ctx.table("s2")
    ectx = ExecContext(ctx.config)
    got, probe_ms = probe_counts_ms()
    print(f"{name} grouped count, merge route: {GENOME_CONTIGS} groups summing to {expected}; "
          f"first query {cold * 1e3:.3f} ms (launches {ran}), warm B1 once, pack_view "
          f"twice and unpermute_counts once, warm median {med:.3f} ms over "
          f"{GROUPED_WARM_QUERIES}, min {low:.3f} ms; the per-probe counts alone "
          f"{probe_ms:.3f} ms [{card}]", flush=True)

    # every per-probe count: merge route == the native host index == level
    c1, c2 = joint_codes(t1, t2)
    hidx = make_host_index(c1.astype(np.int32), t1["pos_start"].astype(np.int32),
                           t1["pos_end"].astype(np.int32))
    want = hidx.counts(c2.astype(np.int32), t2["pos_start"].astype(np.int32),
                       t2["pos_end"].astype(np.int32))
    level = join._level_probe_counts(ectx, left, right)
    for label, counts in (("merge", got), ("level", level)):
        if counts.shape != want.shape or not np.array_equal(counts, want):
            bad = int((counts != want).sum()) if counts.shape == want.shape else "all"
            fail(f"per-probe counts on the {label} route differ from the native host "
                 f"index's in {bad} of {len(want)} rows")
    print(f"{len(want)} per-probe counts: merge and level routes equal the native host "
          "index's element by element")

    os.environ["SEQUILA_HOST_THRESHOLD"] = HOST_ROUTE
    host_out, host_cold = grouped("host")
    if not host_out.arrow.equals(merge_out.arrow):
        fail("the grouped count's host and merge routes differ")
    med, low = warm("host")
    probe_ms = probe_counts_ms()[1]
    print(f"{name} grouped count, host route: the same groups; first query "
          f"{host_cold * 1e3:.3f} ms, warm median {med:.3f} ms over {GROUPED_WARM_QUERIES}, "
          f"min {low:.3f} ms; the per-probe counts alone {probe_ms:.3f} ms [{card}]",
          flush=True)
    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"

    kernel_ms = probe_mode(torch, join, left, right, want, card, err)
    return ran, kernel_ms


def probe_split(torch, plan, packed, orders, want, card) -> None:
    """Where the time of the per-probe launch goes: its two segments in two
    variants, each one launch held against merge_rank_segments_plain and
    timed bare: (1) ranks through the probe views' int64 orders (the
    first port's design); (2) ranks stored direct, in view order (the
    plan's own).  The ranks of (1) equal ``want`` (the (2, n) probe-row
    ranks); those of (2) equal it through the inverse orders."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    segs, n, dev = plan.segplan.segs, plan.n, packed[0].device
    out = torch.empty(2 * n, dtype=torch.int32, device=dev)
    ref = torch.empty_like(out)
    for label, direct in (("1: through the int64 orders", False),
                          ("2: direct, in view order", True)):
        vsegs = [s._replace(ord=None if direct else orders[i]) for i, s in enumerate(segs)]
        launch = mc.segments_launcher(mc.plan_segments(vsegs, dev), (*packed, out))
        out.fill_(-1)
        launch()
        ref.fill_(-1)
        mc.merge_rank_segments_plain(vsegs, (*packed, ref))
        d = max_diff(torch, out, ref)
        got = out.view(2, n)
        if direct:
            got = torch.stack([got[0][plan.inv_qe], got[1][plan.inv_qs]])
        if d or not torch.equal(got, want):
            fail(f"B1's per-probe split, variant {label}: max |diff| {d} against plain, or "
                 "ranks that differ from the library calls'")
        ms = time_events(torch, launch, TIMED_LAUNCHES)
        print(f"B1 per-probe split, variant {label}: {ms:.4f} ms a launch, equal to plain "
              f"[{card}]", flush=True)


def probe_mode(torch, join, left, right, want_counts, card, err) -> dict:
    """B1's per-probe mode on the genome pair: the split of the launch
    (probe_split); the redesigned launch (ranks in view order) against
    merge_rank_segments_plain and the un-permute against its plain
    version, both together against merge_probe_count_passes_plain and the
    native host index's counts; each timed bare beside its bound, the mode
    as a whole beside both bounds and the library calls, and
    merge_probe_count_passes whole."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    inputs = join._sorted_count_inputs(left, right)
    plan = join._merge_probe_plan(left, right, *inputs)
    segs, n = plan.segplan.segs, plan.n
    packed = (mc.pack_view(*plan.pqe, mc.BUILD_PAD), mc.pack_view(*plan.pqs, mc.BUILD_PAD))
    dev = packed[0].device
    r_on, qs_cd, qe_cd = inputs[1], inputs[4], inputs[5]
    orders = [torch.from_numpy(right.sorted_interval_order(r_on.index, c).astype(np.int64))
              .to(dev) for c in (qe_cd[0], qs_cd[0])]
    invs = (plan.inv_qe, plan.inv_qs)

    # the yardsticks: torch.searchsorted on the same packed values widened
    # to int64 (u32 order), the tables packed outside the timed window; two
    # calls give the view-order ranks, two index_copy_ through the int64
    # orders the probe-row ranks, and a subtraction the counts
    tabs = [mc.as_u32(mc.pack_view_plain(*s.raw)) for s in segs]
    qrys = [mc.as_u32(p) for p in packed]
    view_ranks = torch.empty((2, segs[0].m), dtype=torch.int32, device=dev)
    lib = torch.empty((2, n), dtype=torch.int32, device=dev)

    def searchsorted2():
        for i, s in enumerate(segs):
            torch.searchsorted(tabs[i], qrys[i], right=not s.strict, out_int32=True,
                               out=view_ranks[i])
        return view_ranks

    def library_rows():
        for i, r in enumerate(searchsorted2()):
            lib[i].index_copy_(0, orders[i], r[:n])
        return lib

    want_rows = library_rows().clone()
    probe_split(torch, plan, packed, orders, want_rows, card)

    ranks = torch.full((2, n), -1, dtype=torch.int32, device=dev)
    launch = mc.segments_launcher(plan.segplan, (*packed, ranks.view(-1)))
    launch()
    ref = torch.full_like(ranks, -1)
    mc.merge_rank_segments_plain(segs, (*packed, ref.view(-1)))
    err["merge_probe_ranks"] = d = max_diff(torch, ranks, ref)
    if d:
        fail(f"B1's per-probe launch: max |diff| {d} against merge_rank_segments_plain")
    got = mc.unpermute_counts(ranks, *invs)
    err["unpermute_counts"] = d = max_diff(torch, got, mc.unpermute_counts_plain(ranks, *invs))
    if d:
        fail(f"unpermute_counts: max |diff| {d} against its plain version")
    if not torch.equal(got, mc.merge_probe_count_passes_plain(plan)):
        fail("B1's per-probe launch and the un-permute differ from "
             "merge_probe_count_passes_plain")
    if not np.array_equal(got.cpu().numpy(), want_counts):
        fail("B1's per-probe ranks do not give the native host index's counts")
    if not torch.equal(searchsorted2()[:, :n], ranks):
        fail("the library calls differ from B1's view-order ranks")
    print(f"B1's per-probe launch (2 segments, tables of {segs[0].n} rows packed on load, "
          f"{segs[0].m} queries each, ranks in view order) and the un-permute of {n} rows: "
          "equal to their plain versions, to merge_probe_count_passes_plain and to the native "
          "host index's counts", flush=True)

    tables = [t for s in segs for t in s.raw[:3]]
    kernel_ms = {"merge_probe_ranks": time_kernel(
        torch, "merge_probe_ranks (B1's per-probe mode, ranks in view order)",
        lambda: mc.merge_rank_segments_plain(segs, (*packed, ref.view(-1))), launch,
        searchsorted2, unique_nbytes(*packed, ranks, *tables), sum(s.n + s.m for s in segs),
        f"2 segments, N={segs[0].n} M={segs[0].m}, ranks direct", card)}
    # two torch.index_select and a subtraction compute the same function
    if not torch.equal(torch.index_select(ranks[0], 0, invs[0])
                       - torch.index_select(ranks[1], 0, invs[1]), got):
        fail("torch.index_select differs from unpermute_counts")
    kernel_ms["unpermute_counts"] = time_kernel(
        torch, "unpermute_counts", lambda: mc.unpermute_counts_plain(ranks, *invs),
        lambda: mc.unpermute_counts(ranks, *invs),
        lambda: torch.index_select(ranks[0], 0, invs[0]) - torch.index_select(ranks[1], 0, invs[1]),
        nbytes(ranks, *invs, got), 2 * n, f"2 planes of n={n}, int32 inverse orders", card)
    both = time_events(torch, lambda: (launch(), mc.unpermute_counts(ranks, *invs)),
                       TIMED_LAUNCHES)
    library = time_events(torch, lambda: library_rows()[0] - lib[1], TIMED_LAUNCHES)
    if not torch.equal(library_rows()[0] - lib[1], got):
        fail("the library calls differ from the per-probe counts")
    old_bytes = unique_nbytes(*packed, ranks, *tables, *orders)
    # the redesign's bound: the launch's bytes, then the un-permute's (the
    # view-order ranks written once and read once)
    new_bytes = unique_nbytes(*packed, ranks, *tables) + nbytes(ranks, *invs, got)
    (old_ms, _), (new_ms, _) = bound(old_bytes, 0), bound(new_bytes, 0)
    print(f"B1's per-probe mode (B1 launch and un-permute): {both:.4f} ms; bound {old_ms:.4f} "
          f"ms ({old_bytes} bytes, the first port's design through int64 orders, "
          f"{100 * old_ms / both:.1f} %), {new_ms:.4f} ms ({new_bytes} bytes, ranks in view "
          f"order and the un-permute through int32 inverse orders, {100 * new_ms / both:.1f} "
          f"%); two torch.searchsorted, two index_copy_ and a subtraction {library:.4f} ms "
          f"[{card}]", flush=True)
    whole = time_events(torch, lambda: mc.merge_probe_count_passes(plan), TIMED_LAUNCHES)
    print(f"merge_probe_count_passes whole (2 pack_view, 1 B1 and 1 un-permute launch): "
          f"{whole:.4f} ms [{card}]", flush=True)
    del tabs, qrys, view_ranks, lib, want_rows, ranks, ref, orders
    return kernel_ms


def checksum(batches) -> tuple[int, int]:
    """(rows, order-independent checksum) of join output batches: a
    uint64 wrap-around sum over rows of a mix of the four bound columns
    (SELECT * positions 1, 2, 4, 5; NULLs of an outer join count as -1)."""
    import pyarrow.compute as pc

    rows, acc = 0, np.uint64(0)
    keys = [np.uint64(k) for k in (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                                   0x165667B19E3779F9, 0xD6E8FEB86659FD93)]
    for t in batches:
        t = getattr(t, "arrow", t)
        rows += t.num_rows
        if not t.num_rows:
            continue
        h = np.zeros(t.num_rows, np.uint64)
        for i, k in zip((1, 2, 4, 5), keys):
            col = pc.fill_null(t.column(i), -1).to_numpy().astype(np.int64)
            h ^= col.view(np.uint64) * k
        h ^= h >> np.uint64(31)
        acc += np.sum(h * keys[0], dtype=np.uint64)
    return rows, int(acc)


def interval_join_of(plan):
    """The IntervalJoinExec of a physical plan."""
    from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec

    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, IntervalJoinExec):
            return node
        stack.extend(node.children)
    fail("the plan holds no IntervalJoinExec")


def default_route(n: int, m: int) -> str:
    """The route materialize_route_host picks for n build and m probe rows
    at its defaults (no SEQUILA_HOST_THRESHOLD)."""
    from sequila_tpu_torch.exec.joins.interval_join import materialize_route_host

    saved = os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    try:
        return "host" if materialize_route_host(n, m) else "device"
    finally:
        if saved is not None:
            os.environ["SEQUILA_HOST_THRESHOLD"] = saved


def timed(torch, fn):
    """(result, seconds) of one call, the device synchronised."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_select(torch, ctx, query):
    """(result table, seconds) of one ctx.sql, the device synchronised."""
    return timed(torch, lambda: ctx.sql(query))


def phase_materialize(torch, card):
    print("== phase 5a: materializing SELECT * at the 15M-row pairing", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.session import SessionContext

    (n, seed_l), (m, seed_r) = MAT_PAIR
    ctx = SessionContext(device="cuda")
    ctx.register_table("s1", pa.table(bd.gen_chain_table(n, seed_l)))
    ctx.register_table("s2", pa.table(bd.gen_chain_table(m, seed_r)))
    expected = count(ctx, bd.QUERY)
    print(f"{n} x {m} rows: count(*) {expected} on route {route_of(ctx)}; "
          f"materialize_route_host picks the {default_route(n, m)} route by default")

    def select(label, route, query=SELECT_STAR, warm=0):
        out, cold = timed_select(torch, ctx, query)
        if route_of(ctx, "emit") != route:
            fail(f"{label}: answered on route {route_of(ctx, 'emit')}, expected {route}")
        ts = [timed_select(torch, ctx, query)[1] for _ in range(warm)]
        line = f"{label}: {out.num_rows} rows on route {route}, first query {cold:.3f} s"
        if ts:
            med = float(np.median(ts))
            line += (f", warm median {med * 1e3:.3f} ms over {warm} "
                     f"({out.num_rows / med:.0f} rows/s) [{card}]")
        print(line, flush=True)
        return out

    os.environ["SEQUILA_HOST_THRESHOLD"] = HOST_ROUTE
    host = select("select * host", "host", warm=MAT_WARM_QUERIES)
    ref = checksum([host])
    if ref[0] != expected:
        fail(f"host route: {ref[0]} rows, count(*) says {expected}")
    host_left = checksum([select("left join host", "host", LEFT_JOIN)])
    del host

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    launches = reset_launches()
    merge = select("select * device merge", "merge")
    torch.cuda.synchronize()
    ran = launches()
    print(f"device merge route: kernel launches {ran}")
    if (ran["merge_rank_sorted"], ran["pack_view"]) != (1, 2):
        fail(f"the device merge SELECT * launched {ran}, expected B1 once (every level, "
             "both bounds) and pack_view twice (the probe views)")
    if checksum([merge]) != ref:
        fail(f"device merge route: (rows, checksum) {checksum([merge])} != host {ref}")
    select("select * device merge", "merge", warm=MAT_WARM_QUERIES)

    def same_rows(label, out):
        if not out.arrow.equals(merge.arrow):
            fail(f"{label}: rows differ from the merge route's")
        print(f"{label}: equal to the merge route row for row")

    os.environ["SEQUILA_EMIT_BACKEND"] = "cosort"
    same_rows("cosort", select("select * device cosort", "sort", warm=MAT_WARM_QUERIES))
    del os.environ["SEQUILA_EMIT_BACKEND"]
    ctx.sql("SET sequila.interval_join_low_memory = true")
    ctx.sql(f"SET sequila.max_output_batch_size = {STREAM_BATCH}")
    same_rows("low memory", select("select * device low memory", "merge"))
    ctx.sql("SET sequila.interval_join_low_memory = false")
    for alg, route in (("Lapper", "window"), ("IntervalTree", "bsearch")):
        ctx.sql(f"SET sequila.interval_join_algorithm = {alg}")
        got = checksum([select(f"select * device {alg}", route)])
        if got != ref:
            fail(f"{alg} ({route}): (rows, checksum) {got} != host {ref}")
        print(f"{alg} ({route}): checksum equals the host route's")
    ctx.sql("SET sequila.interval_join_algorithm = Coitrees")
    got = checksum([select("left join device", "merge", LEFT_JOIN)])
    if got != host_left:
        fail(f"left join: (rows, checksum) {got} != host {host_left}")
    print(f"left join: {got[0]} rows, checksum equals the host route's")
    return ctx, expected, ref, ran


def phase_emission_parts(torch, ctx, card, err):
    print("== phase 5a': emission strategies and the level-bounds pass", flush=True)
    from sequila_tpu_torch.exec.context import ExecContext
    from sequila_tpu_torch.ops import interval_join as ij
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    join = interval_join_of(ctx.plan_sql(SELECT_STAR))
    left, right = ctx.table("s1"), ctx.table("s2")
    index = join._prepare(ExecContext(ctx.config), left, right)[0]
    plan = join._merge_bounds_plan(left, right, index)
    lb, ub = mc.merge_level_bounds(plan)
    packed = ij._counts_and_nnz(lb, ub).cpu().numpy()
    total, nnz = int(packed[:-2].astype(np.int64).sum()), int(packed[-2])
    chosen = ij.emission_strategy(total, nnz, *lb.shape)
    print(f"{index.num_levels} levels {index.level_sizes}; {total} pairs, {nnz} runs, "
          f"bounds {tuple(lb.shape)}: the rule picks '{chosen}'")
    first = None
    rule = ij.emission_strategy
    for strategy in STRATEGIES:
        ij.emission_strategy = lambda *a, s=strategy: s
        try:
            ij.materialize_pairs_from_bounds(index, lb, ub)
            ts = []
            for _ in range(MAT_WARM_QUERIES):
                t0 = time.perf_counter()
                b, p, _ = ij.materialize_pairs_from_bounds(index, lb, ub)
                ts.append(time.perf_counter() - t0)
        finally:
            ij.emission_strategy = rule
        med = float(np.median(ts))
        if first is None:
            first = (b, p)
        elif not (np.array_equal(b, first[0]) and np.array_equal(p, first[1])):
            fail(f"emission strategy {strategy} gives other pairs than {STRATEGIES[0]}")
        print(f"strategy {strategy}: {med * 1e3:.3f} ms (median of "
              f"{MAT_WARM_QUERIES}) [{card}]", flush=True)

    # the level-bounds pass: its two probe-view pack_view launches, each
    # held against the plain version on the same inputs, then the one B1
    # launch for every level and both bounds, held element by element
    # against its plain version and timed with merge_level_bounds whole
    def pack(k, v, c, label):
        got = mc.pack_view(k, v, c, mc.BUILD_PAD)
        d = max_diff(torch, got, mc.pack_view_plain(k, v, c, mc.BUILD_PAD))
        err["pack_view"] = max(err["pack_view"], d)
        if d:
            fail(f"pack_view on {label} of {k.numel()} rows: max |diff| {d}")
        return got

    segplan, pqe_k, pqe_v, pqs_k, pqs_v, c_qe, c_qs, L, n = plan
    q_e = pack(pqe_k, pqe_v, c_qe, "the probe end view")
    q_s = pack(pqs_k, pqs_v, c_qs, "the probe start view")
    got = torch.full((2, L, n), -1, dtype=torch.int32, device=q_e.device)
    want = got.clone()
    mc.merge_rank_segments(segplan, (q_e, q_s, got.view(-1)))
    mc.merge_rank_segments_plain(segplan.segs, (q_e, q_s, want.view(-1)))
    d = max_diff(torch, got, want)
    err["merge_level_ranks"] = d
    if d:
        fail(f"the level launch: max |diff| {d} against its plain version")
    sizes = [s.n for s in segplan.segs[::2]]
    print(f"pack_view: the 2 probe views equal plain; the level launch ({len(segplan.segs)} "
          f"segments, levels of {min(sizes)} to {max(sizes)} rows, M={q_e.numel()}): "
          f"bounds [2, {L}, {n}] equal plain", flush=True)
    out = got.view(-1)
    level_bytes = (nbytes(q_e, q_s, *(s.ord for s in segplan.segs[:2]), out)
                   + 12 * sum(sizes) + nbytes(*(s.raw[2] for s in segplan.segs[:2])))
    level_ms = time_kernel(
        torch, "merge_level_ranks (the level launch)",
        lambda: mc.merge_rank_segments_plain(segplan.segs, (q_e, q_s, out)),
        mc.segments_launcher(segplan, (q_e, q_s, out)),
        None, level_bytes, len(sizes) * q_e.numel() * 2 + 2 * sum(sizes),
        f"{len(segplan.segs)} segments, ranks through the orders", card)
    # the same segments with the ranks stored direct (sorted order, no
    # order): the difference is what the scattered stores cost
    direct = mc.plan_segments([s._replace(ord=None) for s in segplan.segs], q_e.device)
    direct_launch = mc.segments_launcher(direct, (q_e, q_s, out))
    t_direct = time_events(torch, direct_launch, TIMED_LAUNCHES)
    print(f"the level launch with its ranks stored direct, not through the orders: "
          f"{t_direct:.4f} ms [{card}]", flush=True)
    # the library yardstick: one batched torch.searchsorted over the levels
    # padded to [2L, longest level] (u32 values as int64, padding 2^32)
    # gives the direct launch's ranks in sorted probe order; a strict bound
    # ranks q - 1, as #{a < q} = #{a <= q - 1}
    lev = torch.full((2 * L, max(sizes)), 2**32, dtype=torch.int64, device=q_e.device)
    qry = torch.empty((2 * L, q_e.numel()), dtype=torch.int64, device=q_e.device)
    for s in segplan.segs:
        row = s.out[1] // n
        lev[row, :s.n] = mc.as_u32(mc.pack_view_plain(*s.raw))
        qry[row] = mc.as_u32((q_e, q_s)[s.q[0]]) - int(s.strict)
    lib_out = torch.empty(qry.shape, dtype=torch.int32, device=q_e.device)
    direct_launch()
    torch.searchsorted(lev, qry, right=True, out_int32=True, out=lib_out)
    if not torch.equal(lib_out[:, :n], out.view(2 * L, n)):
        fail("the batched torch.searchsorted differs from the direct level launch")
    t_sorted = time_events(
        torch, lambda: torch.searchsorted(lev, qry, right=True, out_int32=True, out=lib_out),
        TIMED_LAUNCHES)
    print(f"one batched torch.searchsorted over the [{2 * L}, {max(sizes)}] padded levels, "
          f"the same ranks as the direct launch: {t_sorted:.4f} ms [{card}]", flush=True)
    # the launch's own function, its library call: that searchsorted, then
    # one index_copy_ puts each row's real ranks through its int64 order
    # (one flat index over the [2, L, n] bounds, built outside the window)
    index = torch.cat([s.ord + s.out[1] for s in sorted(segplan.segs, key=lambda s: s.out)])
    lib_bounds = torch.empty_like(out)

    def library():
        torch.searchsorted(lev, qry, right=True, out_int32=True, out=lib_out)
        return lib_bounds.index_copy_(0, index, lib_out[:, :n].reshape(-1))

    if not torch.equal(library(), want.view(-1)):
        fail("torch.searchsorted with index_copy_ differs from the level launch")
    t_lib = time_events(torch, library, TIMED_LAUNCHES)
    level_ms["library_ms"] = t_lib
    print(f"that torch.searchsorted and one index_copy_ through the orders, the level "
          f"launch's own function: {t_lib:.4f} ms against the launch's {level_ms['ms']:.4f} "
          f"[{card}]", flush=True)
    del lev, qry, lib_out, index, lib_bounds
    whole = time_events(torch, lambda: mc.merge_level_bounds(plan), TIMED_LAUNCHES)
    print(f"merge_level_bounds whole (2 pack_view + 1 B1 launch): {whole:.4f} ms [{card}]",
          flush=True)
    return level_ms


def stage_ms(torch, fn):
    """(last result, median ms) of ``fn`` over MAT_WARM_QUERIES calls after
    one warm call, host clock, the device synchronised."""
    out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(MAT_WARM_QUERIES):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3


def phase_stages(torch, ctx, card):
    print("== phase 5d: where the 15M-row SELECT * time goes", flush=True)
    from torch.profiler import ProfilerActivity, profile

    from sequila_tpu_torch.exec.context import ExecContext
    from sequila_tpu_torch.ops import interval_join as ij
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    join = interval_join_of(ctx.plan_sql(SELECT_STAR))
    left, right = ctx.table("s1"), ctx.table("s2")
    ectx = ExecContext(ctx.config)

    def stage(label, fn):
        out, ms = stage_ms(torch, fn)
        print(f"{label}: median {ms:.3f} ms [{card}]", flush=True)
        return out

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    index = stage("device: _prepare (keys, bounds, index memo)",
                  lambda: join._prepare(ectx, left, right))[0]
    plan = stage("device: bounds plan (memo hit)",
                 lambda: join._merge_bounds_plan(left, right, index))
    lb, ub = stage("device: merge_level_bounds (1 B1 and 2 pack_view launches)",
                   lambda: mc.merge_level_bounds(plan))
    packed = stage("device: counts and nnz to the host",
                   lambda: ij._counts_and_nnz(lb, ub).cpu().numpy())
    b, p, total = stage("device: pairs to the host (the rule's strategy, probe ids included)",
                        lambda: ij.materialize_pairs_from_bounds(index, lb, ub))
    stage("device: probe ids alone (host RLE)", lambda: ij._probe_ids(packed[:-2], total))
    stage("device: output assembly (arrow take of both sides)",
          lambda: join._assemble(left, right, b, p))
    stage("device: whole ctx.sql", lambda: ctx.sql(SELECT_STAR))
    os.environ["SEQUILA_HOST_THRESHOLD"] = HOST_ROUTE
    hidx, hr, hs, he = stage("host: _host_index (memo hit, keys, bounds)",
                             lambda: join._host_index(ectx, left, right))
    stage("host: counts_offsets", lambda: hidx.counts_offsets(hr, hs, he))
    stage("host: fused emission (counts included)",
          lambda: join._fused_host_inner(hidx, left, right, hr, hs, he))
    stage("host: whole ctx.sql", lambda: ctx.sql(SELECT_STAR))

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(MAT_WARM_QUERIES):
                ctx.sql(SELECT_STAR)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA") / 1e3
    except RuntimeError as e:  # a measurement, not a check: no tracer, no share
        print(f"device busy share: not measured ({e})")
        return
    if not dev:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"device route under torch.profiler: {MAT_WARM_QUERIES} queries, wall "
          f"{wall:.3f} ms, device time {dev:.3f} ms, busy share "
          f"{100 * dev / wall:.2f} % [{card}]", flush=True)


def phase_routing(torch, sessions, card):
    print("== phase 5e: both materialization routes with a large build side", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.session import SessionContext

    t1 = sessions[1][3]  # the genome pair's build table
    n = len(t1["contig"])
    for m, seed in ROUTE_PROBES:
        t2 = bd.gen_genome_table(m, seed)
        got = {}
        for route, thr in (("host", HOST_ROUTE), ("merge", "0")):
            os.environ["SEQUILA_HOST_THRESHOLD"] = thr
            # a fresh session: the first query pays the route's own index build
            ctx = SessionContext(device="cuda")
            ctx.register_table("s1", pa.table(t1))
            ctx.register_table("s2", pa.table(t2))
            out, cold = timed_select(torch, ctx, SELECT_STAR)
            if route_of(ctx, "emit") != route:
                fail(f"{n} x {m}: answered on route {route_of(ctx, 'emit')}, expected {route}")
            warm = float(np.median([timed_select(torch, ctx, SELECT_STAR)[1]
                                    for _ in range(MAT_WARM_QUERIES)]))
            got[route] = checksum([out])
            print(f"{n} x {m} select * route {route}: {out.num_rows} rows, first query "
                  f"{cold * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms over "
                  f"{MAT_WARM_QUERIES} [{card}]", flush=True)
            del out, ctx
        if got["merge"] != got["host"]:
            fail(f"{n} x {m}: device (rows, checksum) {got['merge']} != host {got['host']}")
        print(f"{n} x {m}: checksums equal; materialize_route_host picks the "
              f"{default_route(n, m)} route by default")


def nearest_picks(out) -> tuple[int, int, int]:
    """(overlap, nearest, NULL) picks of a nearest SELECT * output (build
    bounds at positions 1, 2, probe bounds at 4, 5)."""
    a_s = out.arrow.column(1)
    null = a_s.null_count
    a_s, a_e, b_s, b_e = (
        out.arrow.column(i).fill_null(0).to_numpy().astype(np.int64) for i in (1, 2, 4, 5)
    )
    valid = ~np.asarray(out.arrow.column(1).is_null())
    overlap = int((valid & (a_s <= b_e) & (a_e >= b_s)).sum())
    return overlap, int(valid.sum()) - overlap, null


def phase_nearest(torch, sessions, card):
    print("== phase 5f: nearest SELECT * (CoitreesNearest) on the host and device routes",
          flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.native.loader import available
    from sequila_tpu_torch.session import SessionContext

    if not available():
        fail("the native host library did not build: nearest has no host route")
    t1, t2 = sessions[1][3], sessions[1][4]
    cases = [
        (f"genome build x gen_genome_table{NEAREST_PROBES}", t1,
         bd.gen_genome_table(*NEAREST_PROBES)),
        (f"gen_genome_table{NEAREST_SPARSE} x genome probes",
         bd.gen_genome_table(*NEAREST_SPARSE), t2),
    ]
    for label, build, probe in cases:
        outs = {}
        for route, thr in (("host", None), ("device", "0")):
            # the default routing, then SEQUILA_HOST_THRESHOLD=0; a fresh
            # session: the first query pays the route's own index build
            os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
            if thr is not None:
                os.environ["SEQUILA_HOST_THRESHOLD"] = thr
            ctx = SessionContext(device="cuda")
            ctx.register_table("s1", pa.table(build))
            ctx.register_table("s2", pa.table(probe))
            ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
            out, cold = timed_select(torch, ctx, SELECT_STAR)
            if route_of(ctx, "nearest") != route:
                fail(f"nearest {label}: answered on route {route_of(ctx, 'nearest')}, "
                     f"expected {route}")
            warm = float(np.median([timed_select(torch, ctx, SELECT_STAR)[1]
                                    for _ in range(NEAREST_WARM_QUERIES)]))
            print(f"nearest {label}, route {route}: {out.num_rows} rows, first query "
                  f"{cold * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms over "
                  f"{NEAREST_WARM_QUERIES} [{card}]", flush=True)
            outs[route] = out
            del ctx
        m = len(probe["contig"])
        if outs["host"].num_rows != m or not outs["device"].arrow.equals(outs["host"].arrow):
            fail(f"nearest {label}: the device route's rows differ from the host route's")
        overlap, near, null = nearest_picks(outs["host"])
        print(f"nearest {label}: device equals host row for row; {overlap} overlap, "
              f"{near} nearest and {null} NULL picks of {m} probes", flush=True)
        del outs
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)


def malloc_warm_ms() -> dict:
    """The warm 15M host-route SELECT * in this process: median ms over
    MALLOC_WARM_QUERIES after one query, and whether the allocator tuning
    was applied."""
    import pyarrow as pa

    from sequila_tpu_torch import _malloc
    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.session import SessionContext

    (n, seed_l), (m, seed_r) = MAT_PAIR
    os.environ["SEQUILA_HOST_THRESHOLD"] = HOST_ROUTE
    ctx = SessionContext(device="cuda")
    ctx.register_table("s1", pa.table(bd.gen_chain_table(n, seed_l)))
    ctx.register_table("s2", pa.table(bd.gen_chain_table(m, seed_r)))
    rows = ctx.sql(SELECT_STAR).num_rows
    ts = []
    for _ in range(MALLOC_WARM_QUERIES):
        t0 = time.perf_counter()
        ctx.sql(SELECT_STAR)
        ts.append(time.perf_counter() - t0)
    return {"rows": rows, "ms": float(np.median(ts)) * 1e3, "min_ms": min(ts) * 1e3,
            "tuned": _malloc._applied}


def malloc_child() -> None:
    """Phase 5g's child process (SEQUILA_MALLOC_TUNE=0): one JSON line."""
    print(json.dumps(malloc_warm_ms()))


def phase_malloc(card):
    print("== phase 5g: the warm 15M host-route SELECT * with and without the allocator "
          "tuning", flush=True)
    tuned = malloc_warm_ms()
    res = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.malloc_child()"],
        env=dict(os.environ, SEQUILA_MALLOC_TUNE="0"),
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        fail(f"the untuned child exited {res.returncode}: {res.stderr.strip()[-2000:]}")
    untuned = json.loads(res.stdout.strip().splitlines()[-1])
    if not tuned["tuned"] or untuned["tuned"]:
        fail(f"allocator tuning: parent {tuned['tuned']}, SEQUILA_MALLOC_TUNE=0 child "
             f"{untuned['tuned']}")
    if untuned["rows"] != tuned["rows"]:
        fail(f"the untuned child returned {untuned['rows']} rows, the parent {tuned['rows']}")
    for label, r in (("tuned (this process)", tuned), ("SEQUILA_MALLOC_TUNE=0 (child)", untuned)):
        print(f"warm 15M host SELECT *, {label}: median {r['ms']:.3f} ms, min "
              f"{r['min_ms']:.3f} ms over {MALLOC_WARM_QUERIES} ({r['rows']} rows) [{card}]",
              flush=True)
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)


def unique_nbytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (by address): each
    input read once, however many segments read it."""
    return sum({t.data_ptr(): t.numel() * t.element_size() for t in tensors}.values())


def phase_verbs(torch, sessions, card, err):
    print("== phase 5h: the genomic verbs over the genome pair (count_overlaps, coverage)",
          flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import dataframe as df
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.ops.cuda import merge_count as mc
    from sequila_tpu_torch.ops.host_join import make_host_index
    from sequila_tpu_torch.session import SessionContext

    _, _, expected, t1, t2 = sessions[1]
    m = len(t2["contig"])
    c1, c2 = joint_codes(t1, t2)

    def i32(x):
        return np.ascontiguousarray(x, np.int32)

    hidx = make_host_index(i32(c1), i32(t1["pos_start"]), i32(t1["pos_end"]))
    q = (i32(c2), i32(t2["pos_start"]), i32(t2["pos_end"]))
    want_counts = hidx.counts(*q)
    want_cov = hidx.coverage(*q)
    if int(want_counts.sum()) != expected or not np.array_equal(want_cov[0], want_counts):
        fail(f"native host index: counts sum to {int(want_counts.sum())}, expected {expected}")
    print(f"native host index: {m} per-probe counts summing to {expected}, covered bases "
          f"summing to {int(want_cov[1].sum())}")

    def check(label, out, verb):
        got = [out.column_np("count")]
        want = [want_counts]
        if verb == "coverage":
            got.append(out.column_np("bases"))
            want = list(want_cov)
        if out.num_rows != m or not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"{label}: {verb} differs from the native host index")

    # warm device launches (B1, pack_view, un-permute) of each verb
    verbs = {"count_overlaps": (1, 2, 0, 1), "coverage": (1, 4, 1, 0)}
    kernels = ("merge_rank_sorted", "pack_view", "unpermute_ranks", "unpermute_counts")
    # B1 and un-permute launches of the device coverage calls (the kernels line)
    verb_b1 = verb_unpermute = 0

    def calls(label, route, verb, fn):
        """First and warm calls of one verb on one route, each checked."""
        nonlocal verb_b1, verb_unpermute
        launches = reset_launches()
        out, first = timed(torch, fn)
        ran = launches()
        check(f"{label} first call, route {route}", out, verb)
        if route == "device" and not all(ran[k] > 0 for k, x in zip(kernels, verbs[verb]) if x):
            fail(f"{label} {verb} on the device route launched {ran}")
        total = dict(ran)
        ts = []
        for _ in range(VERB_WARM_CALLS):
            launches = reset_launches()
            out, dt = timed(torch, fn)
            one = launches()
            ts.append(dt)
            total = {k: total[k] + one[k] for k in total}
            if route == "device" and tuple(one[k] for k in kernels) != verbs[verb]:
                fail(f"a warm device {verb} ({label}) launched {one}, expected "
                     f"{dict(zip(kernels, verbs[verb]))}")
            if route == "host" and any(one.values()):
                fail(f"the host route's {verb} ({label}) launched {one}")
        check(f"{label} warm call, route {route}", out, verb)
        if route == "device" and verb == "coverage" and label == "DataFrame":
            verb_b1, verb_unpermute = total["merge_rank_sorted"], total["unpermute_ranks"]
        warm = float(np.median(ts)) * 1e3
        print(f"{verb} ({label}), route {route}: equal to the native host index; first call "
              f"{first * 1e3:.3f} ms (launches {ran}), warm median {warm:.3f} ms over "
              f"{VERB_WARM_CALLS}, min {min(ts) * 1e3:.3f} ms [{card}]", flush=True)

    for route, thr in (("host", None), ("device", "0")):
        os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
        if thr is not None:
            os.environ["SEQUILA_HOST_THRESHOLD"] = thr
        # fresh tables and sessions: each route's first call pays its own caches
        a, b = Table(pa.table(t2)), Table(pa.table(t1))
        for verb in verbs:
            calls("DataFrame", route, verb, lambda: getattr(df, verb)(a, b, device="cuda"))
        ctx = SessionContext(device="cuda")
        ctx.register_table("a", pa.table(t2))
        ctx.register_table("b", pa.table(t1))
        for verb in verbs:
            calls("SQL", route, verb, lambda: ctx.sql(f"SELECT * FROM {verb}('a', 'b')"))
        del ctx

    # the host-only verbs at the same shape
    for label, fn, rows in (
        (f"closest k={VERB_CLOSEST_K}", lambda: df.closest(a, b, k=VERB_CLOSEST_K, device="cuda"),
         VERB_CLOSEST_K * m),
        ("subtract", lambda: df.subtract(a, b), None),
        ("merge (probes)", lambda: df.merge(a), None),
    ):
        out, first = timed(torch, fn)
        out, warm = timed(torch, fn)
        if rows is not None and out.num_rows != rows:
            fail(f"{label}: {out.num_rows} rows, expected {rows}")
        print(f"{label}: {out.num_rows} rows, first call {first * 1e3:.3f} ms, warm "
              f"{warm * 1e3:.3f} ms [{card}]", flush=True)

    kernel_ms = verb_mode(torch, a, b, want_counts, card, err)
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    return {"merge_rank_sorted": verb_b1, "unpermute_ranks": verb_unpermute}, kernel_ms


def verb_split(torch, plan, packed, orders, want, card) -> None:
    """Where the time of the verb-mode launch through the orders goes: the
    four segments in four variants the descriptor offers, each one launch
    held against merge_rank_segments_plain and timed bare: (1) build views
    packed on load, ranks through the probe views' int64 orders (the first
    port's design); (2) ranks stored direct, in view order; (3) build views
    pre-packed by pack_view; (4) both.  The ranks of (1) and (3) equal ``want`` (the
    (4, n) probe-row ranks); those of (2) and (4) equal it through the
    inverse orders."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    segs, n, dev = plan.segplan.segs, plan.n, packed[0].device
    tabs = [mc.pack_view(*s.raw) for s in segs]
    offs = np.cumsum([0] + [t.numel() for t in tabs])
    slots = (*packed, torch.empty(4 * n, dtype=torch.int32, device=dev), torch.cat(tabs))
    ref = torch.empty_like(slots[4])
    invs = (plan.inv_qe, plan.inv_qs, plan.inv_qe, plan.inv_qs)
    for label, direct, prepacked in (("1: packed on load, through the orders", False, False),
                                     ("2: packed on load, direct", True, False),
                                     ("3: pre-packed, through the orders", False, True),
                                     ("4: pre-packed, direct", True, True)):
        vsegs = [
            mc.Segment(s.n, s.m, q=s.q, strict=s.strict, out=(4, i * n), n_real=n,
                       ord=None if direct else orders[i],
                       **({"a": (5, int(offs[i]))} if prepacked else {"raw": s.raw}))
            for i, s in enumerate(segs)
        ]
        launch = mc.segments_launcher(mc.plan_segments(vsegs, dev), slots)
        slots[4].fill_(-1)
        launch()
        ref.fill_(-1)
        mc.merge_rank_segments_plain(vsegs, (*slots[:4], ref, slots[5]))
        d = max_diff(torch, slots[4], ref)
        got = slots[4].view(4, n)
        if direct:
            got = torch.stack([row[inv] for row, inv in zip(got, invs)])
        if d or not torch.equal(got, want):
            fail(f"B1's verb split, variant {label}: max |diff| {d} against plain, or "
                 "ranks that differ from merge_verb_rank4_plain")
        ms = time_events(torch, launch, TIMED_LAUNCHES)
        print(f"B1 verb split, variant {label}: {ms:.4f} ms a launch, equal to plain "
              f"[{card}]", flush=True)


def verb_mode(torch, a, b, want_counts, card, err) -> dict:
    """B1's verb mode on the genome pair (probe ``a``, build ``b``): the
    split of the launch through the orders (verb_split); the redesigned
    launch (ranks in view order) against merge_rank_segments_plain and the
    un-permute kernel against its plain version, both together against
    merge_verb_rank4_plain and the native host index's counts; each timed
    bare beside its bound, the verb mode as a whole beside the bound with
    int64 orders and the library calls, and merge_verb_rank4 whole."""
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    plan = mc.plan_verb_ranks(b, a, (0, 1, 2), (0, 1, 2), want4=True, device="cuda")
    segs, n = plan.segplan.segs, plan.n
    packed = [mc.pack_view(*p, mc.BUILD_PAD) for p in plan.packs]
    dev = packed[0].device
    want = mc.merge_verb_rank4_plain(plan)
    ord_qe, ord_qs = (torch.from_numpy(a.sorted_interval_order(0, c).astype(np.int64)).to(dev)
                      for c in (2, 1))
    orders = (ord_qe, ord_qs, ord_qe, ord_qs)
    verb_split(torch, plan, packed, orders, want, card)

    ranks = torch.full((4, n), -1, dtype=torch.int32, device=dev)
    launch = mc.segments_launcher(plan.segplan, (*packed, ranks.view(-1)))
    launch()
    ref = torch.full_like(ranks, -1)
    mc.merge_rank_segments_plain(segs, (*packed, ref.view(-1)))
    err["merge_verb_ranks"] = d = max_diff(torch, ranks, ref)
    if d:
        fail(f"B1's verb-mode launch: max |diff| {d} against merge_rank_segments_plain")
    invs = (plan.inv_qe, plan.inv_qs)
    got = mc.unpermute_ranks(ranks, *invs)
    err["unpermute_ranks"] = d = max_diff(torch, got, mc.unpermute_ranks_plain(ranks, *invs))
    if d:
        fail(f"unpermute_ranks: max |diff| {d} against its plain version")
    if not torch.equal(got, want):
        fail("B1's verb launch and the un-permute differ from merge_verb_rank4_plain")
    if not np.array_equal((got[0] - got[1]).cpu().numpy(), want_counts):
        fail("B1's verb-mode ranks do not give the native host index's counts")
    print(f"B1's verb-mode launch (4 segments, tables of {segs[0].n} rows packed on load, "
          f"{segs[0].m} queries each, ranks in view order) and the un-permute of {n} rows: "
          "equal to their plain versions, to merge_verb_rank4_plain and to the native host "
          "index's counts", flush=True)

    # the yardsticks: torch.searchsorted on the same packed values widened
    # to int64 (u32 order), the tables packed outside the timed window;
    # four calls give the view-order ranks, four index_copy_ through the
    # int64 orders the probe-row ranks
    tabs = [mc.as_u32(mc.pack_view_plain(*s.raw)) for s in segs]
    qrys = [mc.as_u32(p) for p in packed]
    view_ranks = torch.empty((4, segs[0].m), dtype=torch.int32, device=dev)
    lib = torch.empty((4, n), dtype=torch.int32, device=dev)

    def searchsorted4():
        for i, s in enumerate(segs):
            torch.searchsorted(tabs[i], qrys[i], right=not s.strict, out_int32=True,
                               out=view_ranks[i])
        return view_ranks

    def library_whole():
        for i, r in enumerate(searchsorted4()):
            lib[i].index_copy_(0, orders[i], r[:n])
        return lib

    if not torch.equal(searchsorted4()[:, :n], ranks):
        fail("the library calls differ from B1's view-order ranks")
    if not torch.equal(library_whole(), want):
        fail("the library calls differ from merge_verb_rank4_plain")
    tables = [t for s in segs for t in s.raw[:3]]
    kernel_ms = {"merge_verb_ranks": time_kernel(
        torch, "merge_verb_ranks (B1's verb mode, ranks in view order)",
        lambda: mc.merge_rank_segments_plain(segs, (*packed, ref.view(-1))), launch,
        searchsorted4, unique_nbytes(*packed, ranks, *tables), sum(s.n + s.m for s in segs),
        f"4 segments, N={segs[0].n} M={segs[0].m}, ranks direct", card)}
    # one torch.gather computes the same function from a (4, n) int64 index
    index = torch.stack([*invs, *invs]).to(torch.int64)
    if not torch.equal(torch.gather(ranks, 1, index), got):
        fail("torch.gather differs from unpermute_ranks")
    kernel_ms["unpermute_ranks"] = time_kernel(
        torch, "unpermute_ranks", lambda: mc.unpermute_ranks_plain(ranks, *invs),
        lambda: mc.unpermute_ranks(ranks, *invs), lambda: torch.gather(ranks, 1, index),
        nbytes(ranks, *invs, got), 0, f"4 planes of n={n}, int32 inverse orders", card)
    del index
    both = time_events(torch, lambda: (launch(), mc.unpermute_ranks(ranks, *invs)),
                       TIMED_LAUNCHES)
    library = time_events(torch, library_whole, TIMED_LAUNCHES)
    old_bytes = unique_nbytes(*packed, want, *tables, ord_qe, ord_qs)
    new_bytes = unique_nbytes(*packed, want, *tables, *invs)
    (old_ms, _), (new_ms, _) = bound(old_bytes, 0), bound(new_bytes, 0)
    print(f"B1's verb mode (B1 launch and un-permute): {both:.4f} ms; bound {old_ms:.4f} ms "
          f"({old_bytes} bytes with int64 orders, {100 * old_ms / both:.1f} %), {new_ms:.4f} "
          f"ms ({new_bytes} bytes with int32 inverse orders, {100 * new_ms / both:.1f} %); "
          f"four torch.searchsorted and four index_copy_ {library:.4f} ms [{card}]",
          flush=True)
    whole = time_events(torch, lambda: mc.merge_verb_rank4(plan), TIMED_LAUNCHES)
    print(f"merge_verb_rank4 whole (4 pack_view, 1 B1 and 1 un-permute launch): "
          f"{whole:.4f} ms [{card}]", flush=True)
    return kernel_ms


def stream_pass(ctx, query, check):
    """(rows, checksum or None, largest batch, seconds) of one sql_batches
    run; with ``check`` every batch is checksummed, and a batch above the
    cap must hold the matches of one probe row."""
    cap = 4 * STREAM_BATCH
    rows, acc, biggest = 0, 0, 0
    t0 = time.perf_counter()
    for b in ctx.sql_batches(query):
        rows += b.num_rows
        biggest = max(biggest, b.num_rows)
        if check:
            acc = (acc + checksum([b])[1]) % 2**64
            if b.num_rows > cap:
                probe = b.arrow.select([4, 5]).group_by(["pos_start", "pos_end"]).aggregate([])
                if probe.num_rows > 1:
                    fail(f"a batch of {b.num_rows} rows > {cap} spans "
                         f"{probe.num_rows} probe intervals")
    return rows, (acc if check else None), biggest, time.perf_counter() - t0


def phase_stream(sessions, card):
    print("== phase 5b: sql_batches of SELECT * over the chr1 pair", flush=True)
    name, ctx, expected, t1, t2 = sessions[0]
    print(f"materialize_route_host picks the "
          f"{default_route(len(t1['contig']), len(t2['contig']))} route by default")
    ctx.sql(f"SET sequila.max_output_batch_size = {STREAM_BATCH}")
    sums = {}
    for route, thr in (("merge", "0"), ("host", HOST_ROUTE)):
        os.environ["SEQUILA_HOST_THRESHOLD"] = thr
        rows, acc, biggest, dt = stream_pass(ctx, SELECT_STAR, check=True)
        if route_of(ctx, "emit") != route:
            fail(f"{name} sql_batches: answered on route {route_of(ctx, 'emit')}, expected {route}")
        if rows != expected:
            fail(f"{name} sql_batches on route {route}: {rows} rows, expected {expected}")
        sums[route] = acc
        warm, _, _, wdt = stream_pass(ctx, SELECT_STAR, check=False)
        print(f"{name} sql_batches route {route}: {rows} rows, largest batch {biggest}; "
              f"checked run {dt:.3f} s, warm run {wdt:.3f} s ({warm / wdt:.0f} rows/s) "
              f"[{card}]", flush=True)
    if sums["merge"] != sums["host"]:
        fail(f"{name} sql_batches: device checksum {sums['merge']} != host {sums['host']}")
    print(f"{name} sql_batches: device and host checksums equal")


def phase_copy(mat_ctx, expected, ref):
    print("== phase 5c: COPY of the 15M-row join to a parquet directory", flush=True)
    import shutil
    import tempfile

    import pyarrow.parquet as pq

    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    out_dir = tempfile.mkdtemp(prefix="sequila_copy_")
    try:
        t0 = time.perf_counter()
        wrote = int(mat_ctx.sql(
            f"COPY ({SELECT_STAR}) TO '{out_dir}/' STORED AS PARQUET").column_np(0)[0])
        dt = time.perf_counter() - t0
        if route_of(mat_ctx, "emit") != "merge":
            fail(f"COPY answered on route {route_of(mat_ctx, 'emit')}")
        back = checksum([pq.read_table(out_dir)])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if wrote != expected or back != ref:
        fail(f"COPY wrote {wrote} rows, read back (rows, checksum) {back}, "
             f"expected {expected} rows and {ref}")
    print(f"COPY: {wrote} rows written in {dt:.3f} s, read back with the same checksum")


def phase_q1():
    print("== phase 6: q1 fixture through the port's CLI", flush=True)
    res = subprocess.run(
        [sys.executable, "-m", "sequila_tpu_torch.cli",
         "--file", "queries/q1-coitrees.sql"],
        capture_output=True, text=True, timeout=300,
    )
    print((res.stdout + res.stderr).strip())
    if res.returncode != 0:
        fail(f"q1 CLI exited {res.returncode}")
    if f"| {Q1_EXPECTED} " not in res.stdout:
        fail(f"q1 did not return {Q1_EXPECTED}")


def phase_q2():
    print("== phase 6b: q2-genomic-verbs.sql through the port's CLI on cuda and on cpu",
          flush=True)
    import re

    outs = {}
    for device, thr in Q2_RUNS:
        env = {k: v for k, v in os.environ.items() if k != "SEQUILA_HOST_THRESHOLD"}
        if thr is not None:
            env["SEQUILA_HOST_THRESHOLD"] = thr
        res = subprocess.run(
            [sys.executable, "-m", "sequila_tpu_torch.cli", "--device", device,
             "--file", "queries/q2-genomic-verbs.sql"],
            capture_output=True, text=True, timeout=300, env=env,
        )
        if res.returncode != 0:
            fail(f"q2 CLI --device {device} exited {res.returncode}: {res.stderr.strip()[-2000:]}")
        outs[(device, thr)] = re.sub(r"Query took [0-9.]+ seconds\.", "", res.stdout)
    first = outs[Q2_RUNS[0]]
    for run, text in outs.items():
        if text != first:
            fail(f"q2 through the CLI with (device, SEQUILA_HOST_THRESHOLD) {run} printed "
                 f"another table than {Q2_RUNS[0]}")
    print(first.strip())
    print(f"q2 printed the same tables for every (device, SEQUILA_HOST_THRESHOLD) in {Q2_RUNS}")


def distribution_of(session) -> str:
    """The distribution the session's last Partitioned-mode query took,
    from the operator's ``distribution_<name>`` metric."""
    names = [k for c in session.last_metrics.counters.values() for k in c
             if k.startswith("distribution_")]
    if len(names) != 1:
        fail(f"expected one distribution metric, got {names}")
    return names[0][len("distribution_"):]


def phase_partitioned(torch, sessions, mat_ctx, mat_expected, mat_ref, card):
    print(f"== phase 7: Partitioned mode (target_partitions = {PART_TARGET}) on "
          "SessionContext(device='cuda')", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch import dataframe as df
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.parallel import engine
    from sequila_tpu_torch.parallel import partitioned_join as pj
    from sequila_tpu_torch.parallel.engine import get_engine_mesh
    from sequila_tpu_torch.parallel.mesh import make_mesh
    from sequila_tpu_torch.session import SessionContext

    mesh = get_engine_mesh(PART_TARGET, "cuda")
    print(f"{torch.cuda.device_count()} card(s): {mesh}")
    if any(d.type != "cuda" for d in mesh.devices.reshape(-1)):
        fail(f"the partitioned mesh holds a device that is not a card: {mesh}")
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    t1, t2 = sessions[1][3], sessions[1][4]
    tables = {
        "chr1": {n: sessions[0][1].table(n) for n in ("s1", "s2")},
        "genome": {n: sessions[1][1].table(n) for n in ("s1", "s2")},
        "mat": {n: mat_ctx.table(n) for n in ("s1", "s2")},
        "nearest": {"s1": Table(pa.table(t1)), "s2": Table(pa.table(bd.gen_genome_table(*NEAREST_PROBES)))},
    }

    def session(pair, dist, target=PART_TARGET):
        ctx = SessionContext(device="cuda")
        for name, t in tables[pair].items():
            ctx.register_table(name, t)
        ctx.sql(f"SET datafusion.execution.target_partitions = {target}")
        ctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        return ctx

    # the single-device references and their warm times, from this call
    single = {}
    for label, ctx, fn in (
        ("count chr1", sessions[0][1], lambda c: count(c, bd.QUERY)),
        ("count genome", sessions[1][1], lambda c: count(c, bd.QUERY)),
        ("select * 15M", mat_ctx, lambda c: c.sql(SELECT_STAR)),
        ("grouped count", sessions[1][1], lambda c: c.sql(GROUPED_QUERY)),
    ):
        fn(ctx)
        single[label] = timed(torch, lambda: fn(ctx))[1]
    os.environ["SEQUILA_HOST_THRESHOLD"] = "0"
    # nearest over the chr1 pair too: its one contig is the hot key that
    # skew splits, so the split mesh runs the nearest fringe
    near_want = {}
    for pair, label in (("nearest", "nearest"), ("chr1", "nearest chr1")):
        near_ctx = session(pair, "auto", target=1)
        near_ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
        near_want[label] = near_ctx.sql(SELECT_STAR)
        single[label] = timed_select(torch, near_ctx, SELECT_STAR)[1]
        if route_of(near_ctx, "nearest") != "device":
            fail(f"the single-device {label} reference took route "
                 f"{route_of(near_ctx, 'nearest')}")
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    a, b = tables["genome"]["s2"], tables["genome"]["s1"]
    verb_want = {}
    for verb in ("count_overlaps", "coverage"):
        verb_want[verb] = getattr(df, verb)(a, b, device="cuda")
        single[verb] = timed(torch, lambda: getattr(df, verb)(a, b, device="cuda"))[1]

    def check_count(expected):
        def check(got):
            if got != expected:
                fail(f"count {got}, expected {expected}")
        return check

    def check_select(out):
        if checksum([out]) != mat_ref:
            fail(f"SELECT *: (rows, checksum) {checksum([out])} != host route {mat_ref}")

    def check_nearest(label):
        def check(out):
            if not out.arrow.equals(near_want[label].arrow):
                fail(f"{label}: rows differ from the single-device device route's")
        return check

    def check_grouped(out):
        total = int(out.column_np(1).astype(np.int64).sum())
        if out.num_rows != GENOME_CONTIGS or total != GENOME_EXPECTED:
            fail(f"grouped count: {out.num_rows} groups summing to {total}")

    def batches(ctx):
        rows, acc = 0, 0
        for bt in ctx.sql_batches(SELECT_STAR):
            rows += bt.num_rows
            acc = (acc + checksum([bt])[1]) % 2**64
        return rows, acc

    def check_batches(got):
        if got != mat_ref:
            fail(f"sql_batches: (rows, checksum) {got} != host route {mat_ref}")

    def timed_pair(label, dist, ctx, fn, check, single_label, want_dist, warm=True):
        out, first = timed(torch, lambda: fn(ctx))
        check(out)
        # per-probe counts have a hash program only and record no metric,
        # as in the JAX package
        got_dist = distribution_of(ctx) if want_dist != "hash only" else want_dist
        if want_dist not in (None, "hash only") and got_dist != want_dist:
            fail(f"{label} [{dist}]: distribution {got_dist}, expected {want_dist}")
        times = f"one run {first * 1e3:.3f} ms"
        if warm:
            out, dt = timed(torch, lambda: fn(ctx))
            check(out)
            times = f"first {first * 1e3:.3f} ms, warm {dt * 1e3:.3f} ms"
        print(f"{label} [{dist}]: distribution {got_dist}, {times}, single-device warm "
              f"{single[single_label] * 1e3:.3f} ms [{card}]", flush=True)

    def verb_check(verb, warm, tag):
        def call():
            return getattr(df, verb)(a, b, device="cuda", partitions=PART_TARGET)

        def same(out):
            want = verb_want[verb]
            cols = ("count", "bases") if verb == "coverage" else ("count",)
            if out.num_rows != want.num_rows or not all(
                    np.array_equal(out.column_np(c), want.column_np(c)) for c in cols):
                fail(f"{tag}{verb} with partitions={PART_TARGET} differs from the "
                     "single-device verb")
        out, first = timed(torch, call)
        same(out)
        times = f"one run {first * 1e3:.3f} ms"
        if warm:
            out, dt = timed(torch, call)
            same(out)
            times = f"first {first * 1e3:.3f} ms, warm {dt * 1e3:.3f} ms"
        print(f"{tag}{verb} partitions={PART_TARGET}: equal to the single-device verb, "
              f"{times}, single-device warm {single[verb] * 1e3:.3f} ms [{card}]", flush=True)

    one_part = mesh.shape["part"] <= 1
    t_phase = time.perf_counter()
    launches = reset_launches()
    for dist in PART_DISTS:
        # auto takes hash on a 1-part mesh; nearest has no shuffle program
        want = "hash" if dist == "auto" and one_part else None if dist == "auto" else dist
        for pair, expected in (("chr1", CHR1_EXPECTED), ("genome", GENOME_EXPECTED)):
            timed_pair(f"count {pair}", dist, session(pair, dist),
                       lambda c: count(c, bd.QUERY), check_count(expected), f"count {pair}", want)
        ctx = session("mat", dist)
        timed_pair("select * 15M", dist, ctx, lambda c: c.sql(SELECT_STAR), check_select,
                   "select * 15M", want)
        ctx.sql(f"SET sequila.max_output_batch_size = {STREAM_BATCH}")
        out, dt = timed(torch, lambda: batches(ctx))
        check_batches(out)
        print(f"sql_batches select * 15M [{dist}]: {out[0]} rows, checksum equal to the host "
              f"route's, one run {dt * 1e3:.3f} ms [{card}]", flush=True)
        ctx = session("nearest", dist)
        ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
        timed_pair("nearest", dist, ctx, lambda c: c.sql(SELECT_STAR), check_nearest("nearest"),
                   "nearest", "hash" if dist == "shuffle" else want, warm=dist != "shuffle")
        timed_pair("grouped count", dist, session("genome", dist),
                   lambda c: c.sql(GROUPED_QUERY), check_grouped, "grouped count", "hash only",
                   warm=dist == "hash")
    # the verbs take partitions= and no distribution
    verb_check("count_overlaps", True, "")
    verb_check("coverage", False, "")
    t_engine = time.perf_counter() - t_phase

    # every multi-shard path on the one card: the same checks over a
    # (2, 2) mesh of the card repeated, put where the operator and the
    # verbs take their mesh from
    card4 = make_mesh([torch.device("cuda", 0)] * PART_TARGET)
    print(f"the card repeated: {card4}", flush=True)
    engine_mesh = engine.get_engine_mesh
    engine.get_engine_mesh = lambda target, device: card4 if target > 1 else None
    try:
        for dist in PART_DISTS:
            want = None if dist == "auto" else dist
            for pair, expected in (("chr1", CHR1_EXPECTED), ("genome", GENOME_EXPECTED)):
                timed_pair(f"card x4: count {pair}", dist, session(pair, dist),
                           lambda c: count(c, bd.QUERY), check_count(expected), f"count {pair}",
                           want, warm=False)
            if dist == "auto":
                continue
            timed_pair("card x4: select * 15M", dist, session("mat", dist),
                       lambda c: c.sql(SELECT_STAR), check_select, "select * 15M", want,
                       warm=False)
            if dist == "shuffle":
                continue
            for pair, label in (("nearest", "nearest"), ("chr1", "nearest chr1")):
                ctx = session(pair, dist)
                ctx.sql("SET sequila.interval_join_algorithm TO CoitreesNearest")
                timed_pair(f"card x4: {label}", dist, ctx, lambda c: c.sql(SELECT_STAR),
                           check_nearest(label), label, want, warm=False)
        verb_check("count_overlaps", False, "card x4: ")
    finally:
        engine.get_engine_mesh = engine_mesh
    torch.cuda.synchronize()
    ran = launches()
    if any(ran.values()):
        fail(f"Partitioned mode launched a hand kernel: {ran}")
    print(f"Partitioned mode: every check passed in {time.perf_counter() - t_phase:.1f} s "
          f"({t_engine:.1f} s on the engine's mesh); hand-kernel launches {ran}", flush=True)

    # each shard's bounds by both rank strategies, at the genome count shape
    c1, c2 = joint_codes(t1, t2)
    cols = [np.ascontiguousarray(x, np.int32) for x in
            (c1, t1["pos_start"], t1["pos_end"], c2, t2["pos_start"], t2["pos_end"])]
    _, meta, didx, dq, _ = pj._partitioned_inputs(mesh, *cols)
    ms, bounds = {}, {}
    for strategy in ("sort", "bsearch"):
        os.environ["SEQUILA_MESH_BOUNDS"] = strategy
        bounds[strategy] = pj.shard_bounds(mesh, meta, didx, dq)
        ms[strategy] = time_events(torch, lambda: pj.shard_bounds(mesh, meta, didx, dq),
                                   BOUNDS_REPS) / mesh.size
    os.environ.pop("SEQUILA_MESH_BOUNDS", None)
    for key, (lb, ub) in bounds["sort"].items():
        lb2, ub2 = bounds["bsearch"][key]
        if not (torch.equal(lb, lb2) and torch.equal(ub, ub2)):
            fail(f"shard {key}: sort and bsearch bounds differ")
    winner = min(ms, key=ms.get)
    print(f"per-shard bounds at the genome count shape ({meta['num_levels']} levels, "
          f"{dq[0, 0][0].numel()} probe slots): sort {ms['sort']:.3f} ms, bsearch "
          f"{ms['bsearch']:.3f} ms, equal bounds; faster: {winner}, CUDA default: "
          f"{pj._CUDA_BOUNDS} [{card}]", flush=True)


def grouped_rows(out) -> list:
    """The grouped count's (contig, count) rows, sorted."""
    return sorted([str(c), int(n)] for c, n in zip(out.column_np(0), out.column_np(1)))


def rank_checks(torch, spec) -> dict:
    """One rank's phase-8 work; its results are the same on every rank but
    for the times."""
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.parallel import distributed, engine
    from sequila_tpu_torch.parallel import partitioned_join as pj
    from sequila_tpu_torch.session import SessionContext

    launches = reset_launches()
    data = np.load(spec["data"])
    genome = [{c: data[f"{n}_{c}"] for c in ("contig", "pos_start", "pos_end")}
              for n in ("s1", "s2")]
    (n, seed_l), (m, seed_r) = MAT_PAIR
    tables = {"genome": [pa.table(t) for t in genome],
              "mat": [pa.table(bd.gen_chain_table(n, seed_l)), pa.table(bd.gen_chain_table(m, seed_r))]}
    mesh = engine.get_engine_mesh(PART_TARGET, "cuda")
    res = {"mesh": repr(mesh), "count": {}, "distribution": {}, "select": {}, "ms": {},
           "collective_ms": {}}

    def session(pair, dist):
        ctx = SessionContext(device="cuda")
        for name, t in zip(("s1", "s2"), tables[pair]):
            ctx.register_table(name, t)
        ctx.sql(f"SET datafusion.execution.target_partitions = {PART_TARGET}")
        ctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        return ctx

    def run(label, fn):
        torch.cuda.synchronize()
        distributed.STATS.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["ms"][label] = (time.perf_counter() - t0) * 1e3
        res["collective_ms"][label] = distributed.STATS.seconds * 1e3
        return out

    for dist in MP_DISTS:
        ctx = session("genome", dist)
        res["count"][dist] = run(f"count genome {dist} first", lambda: count(ctx, bd.QUERY))
        res["distribution"][dist] = distribution_of(ctx)
        if run(f"count genome {dist} warm", lambda: count(ctx, bd.QUERY)) != res["count"][dist]:
            fail(f"the warm genome count under {dist} differs from the first")
        ctx = session("mat", dist)
        res["select"][dist] = checksum([run(f"select * 15M {dist}", lambda: ctx.sql(SELECT_STAR))])
    c1, c2 = joint_codes(*genome)
    cols = [np.ascontiguousarray(x, np.int32) for x in
            (c1, genome[0]["pos_start"], genome[0]["pos_end"],
             c2, genome[1]["pos_start"], genome[1]["pos_end"])]
    res["count"]["collect_left"] = run("collect_left_count genome",
                                       lambda: pj.collect_left_count(mesh, *cols))
    ctx = session("genome", "hash")
    res["grouped"] = grouped_rows(run("grouped count", lambda: ctx.sql(GROUPED_QUERY)))
    torch.cuda.synchronize()
    res["launches"] = launches()
    return res


def rank_main(spec: dict) -> None:
    """A phase-8 rank (``chip_smoke.py --rank <spec>``): join the group,
    run rank_checks, print one ``RESULT`` JSON line."""
    import torch

    from sequila_tpu_torch.parallel import distributed

    # Gloo ranks share card 0; an NCCL rank takes the card of its rank
    device = "cuda:0" if spec["backend"] == "gloo" else "cuda"
    distributed.initialize(spec["init"], spec["world"], spec["rank"], spec["backend"],
                           device=device, timeout_s=MP_COLLECTIVE_TIMEOUT_S)
    try:
        res = rank_checks(torch, spec)
    finally:
        distributed.shutdown()
    print("RESULT " + json.dumps(res), flush=True)


def rank_results(world: int, backend: str, data: str, tmp: str, label: str) -> list[dict]:
    """Start ``world`` ranks of this script and wait for them; fail, with
    every rank stopped, if one fails or the ranks outlast MP_TIMEOUT_S."""
    from sequila_tpu_torch.parallel.multihost_dryrun import run_ranks

    init = f"file://{os.path.join(tmp, f'rendezvous_{label}')}"
    specs = [{"rank": r, "world": world, "backend": backend, "init": init, "data": data}
             for r in range(world)]
    ranks = run_ranks([[sys.executable, os.path.abspath(__file__), "--rank", json.dumps(spec)]
                       for spec in specs], MP_TIMEOUT_S)
    if any(code or killed for code, _, killed in ranks):
        for r, (code, log, killed) in enumerate(ranks):
            print(f"--- {label} rank {r}: rc {code}{', stopped' if killed else ''} ---\n"
                  f"{''.join(log)[-3000:]}", flush=True)
        fail(f"phase {label}: a rank failed or outlasted {MP_TIMEOUT_S} s")
    return [json.loads([ln for ln in log if ln.startswith("RESULT ")][-1][7:])
            for _, log, _ in ranks]


def phase_multiprocess(torch, genome, mat_ref, grouped_ref, card, shapes=MP_SHAPES):
    print("== phase 8: Partitioned mode across processes (torch.distributed)", flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "genome.npz")
        np.savez(data, **{f"{n}_{c}": v for n, t in zip(("s1", "s2"), genome)
                          for c, v in t.items()})
        for label, backend in shapes:
            world = 2 if backend == "gloo" else torch.cuda.device_count()
            t0 = time.perf_counter()
            ranks = rank_results(world, backend, data, tmp, label)
            wall = time.perf_counter() - t0
            first = ranks[0]
            print(f"{label}: {world} rank(s) over {backend}, {first['mesh']}", flush=True)
            for r, res in enumerate(ranks):
                tag = f"{label} rank {r}"
                for name, got in res["count"].items():
                    if got != GENOME_EXPECTED:
                        fail(f"{tag}: genome count {got} under {name}, expected {GENOME_EXPECTED}")
                for dist, got in res["distribution"].items():
                    if got != dist:
                        fail(f"{tag}: distribution {got}, expected {dist}")
                for dist, got in res["select"].items():
                    if tuple(got) != tuple(mat_ref):
                        fail(f"{tag}: SELECT * under {dist}: (rows, checksum) {got} != host "
                             f"route {mat_ref}")
                if res["grouped"] != grouped_ref:
                    fail(f"{tag}: the grouped count differs from the single-process run")
                if any(res["launches"].values()):
                    fail(f"{tag}: a hand kernel launched: {res['launches']}")
                keys = ("mesh", "count", "distribution", "select", "grouped", "launches")
                if any(res[k] != first[k] for k in keys):
                    fail(f"{tag} disagrees with rank 0")
            for name in first["ms"]:
                ms = [res["ms"][name] for res in ranks]
                coll = [res["collective_ms"][name] for res in ranks]
                print(f"{label} {name}: " + ", ".join(
                    f"rank {r} {t:.1f} ms (collectives {c:.1f} ms, {100 * c / t:.1f} %)"
                    for r, (t, c) in enumerate(zip(ms, coll))) + f" [{card}]", flush=True)
            print(f"{label}: every rank gave {GENOME_EXPECTED} under "
                  f"{', '.join(first['count'])}, {mat_ref[0]} SELECT * rows with the host "
                  f"route's checksum under {', '.join(first['select'])}, the 24 groups; hand-"
                  f"kernel launches {first['launches']}; {wall:.1f} s", flush=True)
    print(f"phase 8 passed in {time.perf_counter() - t_phase:.1f} s", flush=True)


def multiprocess_refs(genome_ctx, mat_ctx):
    """Phase 8's references from this process, on the host route: the 15M
    SELECT *'s (rows, checksum) and the grouped count's rows (phases 4f
    and 5a hold the device routes equal to them)."""
    os.environ["SEQUILA_HOST_THRESHOLD"] = HOST_ROUTE
    try:
        mat_ref = checksum([mat_ctx.sql(SELECT_STAR)])
        grouped = grouped_rows(genome_ctx.sql(GROUPED_QUERY))
    finally:
        os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    if len(grouped) != GENOME_CONTIGS or sum(n for _, n in grouped) != GENOME_EXPECTED:
        fail(f"the single-process grouped count gave {grouped}")
    return mat_ref, grouped


def multiprocess_only(torch, card) -> None:
    """Phase 8 alone, with its references built here."""
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.session import SessionContext

    genome = (bd.gen_genome_table(bd.GENOME_LEFT, 21), bd.gen_genome_table(bd.GENOME_RIGHT, 22))
    (n, seed_l), (m, seed_r) = MAT_PAIR
    ctxs = []
    for t1, t2 in (genome, (bd.gen_chain_table(n, seed_l), bd.gen_chain_table(m, seed_r))):
        ctx = SessionContext(device="cuda")
        ctx.register_table("s1", pa.table(t1))
        ctx.register_table("s2", pa.table(t2))
        ctxs.append(ctx)
    phase_multiprocess(torch, genome, *multiprocess_refs(*ctxs), card, shapes=MP_SHAPES[1:])


def phase_sweep(card) -> float:
    print("== phase 9: the device sweep (tools/cuda_sweep.py): device routes against the "
          "host route", flush=True)
    from tools import cuda_sweep

    t0 = time.perf_counter()
    sw = cuda_sweep.sweep(report=lambda line: print(line, flush=True))
    dt = time.perf_counter() - t0
    bad = sw.failed()
    if bad:
        fail(f"phase 9: {len(bad)} of {len(sw.checks)} sweep checks failed: {bad}")
    print(f"phase 9 passed: {len(sw.checks)} sweep checks in {dt:.1f} s [{card}]", flush=True)
    return dt


def phase_fuzz(card) -> float:
    from tools import cuda_fuzz

    print(f"== phase 10: the device fuzz (tools/cuda_fuzz.py, seed {cuda_fuzz.SEED}): public "
          "paths against the oracle, each kernel entry against its plain version", flush=True)
    t0 = time.perf_counter()
    launches = reset_launches()
    try:
        public = cuda_fuzz.fuzz(rounds=0, report=lambda line: print(line, flush=True))
        ran = launches()
        kernels = cuda_fuzz.fuzz(trials=0, report=lambda line: print(line, flush=True))
    except cuda_fuzz.FuzzFailure as e:
        fail(f"phase 10: {e}")
    missing = {"merge", "stream", "level"} - public["count_routes"]
    if missing:
        fail(f"phase 10: no trial took the count(*) route(s) {sorted(missing)}")
    idle = [k for k in ("merge_rank_sorted", "pack_view", "unpermute_counts", "unpermute_ranks",
                        "stream_rank_sorted") if not ran[k]]
    if idle:
        fail(f"phase 10: the public paths launched no {idle} ({ran})")
    n, m = zip(*public["sizes"])
    dt = time.perf_counter() - t0
    print(f"phase 10 passed: {len(n)} trials (build rows {min(n)}-{max(n)}, probe rows "
          f"{min(m)}-{max(m)}, {public['total']} matches, {public['pairs']} pairs held to the "
          f"oracle; count routes {sorted(public['count_routes'])}; hand-kernel launches {ran}) "
          f"and {cuda_fuzz.ROUNDS} kernel rounds (largest |diff| {kernels['err']}) in {dt:.1f} s "
          f"[{card}]", flush=True)
    return dt


def phase_sanitize(card) -> float:
    print("== phase 11: compute-sanitizer and guard bands over every hand kernel "
          "(tools/cuda_sanitize.py)", flush=True)
    from tools import cuda_sanitize

    t0 = time.perf_counter()
    res = cuda_sanitize.sanitize(report=lambda line: print(line, flush=True))
    counts = {t: "not run" if isinstance(r, str) else r["errors"] for t, r in res["tools"].items()}
    dt = time.perf_counter() - t0
    if not res["ok"]:
        fail(f"phase 11: the kernels' checks found a fault: tools {counts}, guard bands "
             f"{res['guards']['faults']}")
    print(f"phase 11 passed: compute-sanitizer {counts}; guard bands "
          f"{res['guards']['rounds']} rounds, 0 faults; {dt:.1f} s [{card}]", flush=True)
    return dt


def phase_checks(card) -> None:
    """Phases 9-11, with their wall times."""
    times = {"9": phase_sweep(card), "10": phase_fuzz(card), "11": phase_sanitize(card)}
    print("phases 9-11: " + ", ".join(f"phase {k} {v:.1f} s" for k, v in times.items())
          + f" [{card}]", flush=True)


def ok_line(torch) -> str:
    """The last line of a run that passed."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main(only_multiprocess: bool = False, only_checks: bool = False) -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    if not os.path.isdir(os.path.join(here, "sequila_tpu_torch")):
        fail("sequila_tpu_torch not found beside chip_smoke.py: run it from the repository")
    os.environ.pop("SEQUILA_COUNT_BACKEND", None)
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    card = phase_toolchain(torch)
    if only_multiprocess:
        multiprocess_only(torch, card)
        print(card)
        print(ok_line(torch))
        return
    phase_build()
    if only_checks:
        phase_checks(card)
        print(f"phases 1-2 and 9-11 passed in {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(ok_line(torch))
        return
    err = phase_kernels(torch, dev)
    sessions, merge_launches = phase_main_path(torch, card)
    stream_launches = phase_backends(torch, sessions)
    phase_level(torch, sessions, card)
    resident_launches, resident_cols = phase_resident(torch, dev)
    kernel_ms, _ = phase_times(torch, sessions, card, err, resident_cols)
    probe_launches, probe_ms = phase_grouped(torch, sessions, card, err)
    kernel_ms.update(probe_ms)
    mat_ctx, mat_expected, mat_ref, mat_launches = phase_materialize(torch, card)
    kernel_ms["merge_level_ranks"] = phase_emission_parts(torch, mat_ctx, card, err)
    phase_stream(sessions, card)
    phase_copy(mat_ctx, mat_expected, mat_ref)
    phase_stages(torch, mat_ctx, card)
    phase_routing(torch, sessions, card)
    phase_nearest(torch, sessions, card)
    phase_malloc(card)
    verb_launches, verb_ms = phase_verbs(torch, sessions, card, err)
    kernel_ms.update(verb_ms)
    os.environ.pop("SEQUILA_HOST_THRESHOLD", None)
    phase_q1()
    phase_q2()
    phase_partitioned(torch, sessions, mat_ctx, mat_expected, mat_ref, card)
    mp_mat_ref, grouped_ref = multiprocess_refs(sessions[1][1], mat_ctx)
    if mp_mat_ref != mat_ref:
        fail(f"the host route's SELECT * now gives {mp_mat_ref}, earlier {mat_ref}")
    phase_multiprocess(torch, (sessions[1][3], sessions[1][4]), mat_ref, grouped_ref, card)
    phase_checks(card)
    if "jax" in sys.modules:
        fail("the port imported jax")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches come from the run of its own path: B1 and
    # pack_view from the merge count(*) route, B1's level mode from the
    # device merge SELECT *, B1's per-probe mode and its un-permute from the
    # merge route's grouped count, B1's verb mode and the un-permute from the device
    # coverage calls of 5h, B2 from the stream route, B3 from
    # rank_lex_resident
    launches = {
        "merge_rank_sorted": merge_launches["merge_rank_sorted"],
        "merge_level_ranks": mat_launches["merge_rank_sorted"],
        "merge_probe_ranks": probe_launches["merge_rank_sorted"],
        "unpermute_counts": probe_launches["unpermute_counts"],
        "merge_verb_ranks": verb_launches["merge_rank_sorted"],
        "unpermute_ranks": verb_launches["unpermute_ranks"],
        "pack_view": merge_launches["pack_view"],
        "stream_rank_sorted": stream_launches["stream_rank_sorted"],
        "rank_sorted_resident": resident_launches["rank_sorted_resident"],
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"sequila_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err[name],
            **kernel_ms[name],
        }
        for name, (src, replaces) in KERNELS.items()
    ]}
    print(card)
    print(json.dumps(record))
    print(ok_line(torch))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(json.loads(sys.argv[2]))
    else:
        main(only_multiprocess=sys.argv[1:] == ["--multiprocess-only"],
             only_checks=sys.argv[1:] == ["--checks-only"])
