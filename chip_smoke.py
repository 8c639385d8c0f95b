"""Smoke run of the PyTorch / CUDA port (sequila_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:
1. toolchain: torch, CUDA, the card's name and power limit, nvcc, g++,
   triton, pyarrow;
2. build: the CUDA kernels from sequila_tpu_torch/csrc with nvcc for sm_90a,
   printing ``-Xptxas -v``;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, exact integer equality, on random sorted u32 tables with duplicate
   runs, both sentinels, both ``strict`` values, lengths that are not a
   multiple of the block and an empty table, up to the genome shapes;
4. main path: ``SessionContext(device="cuda").sql(count(*) overlap join)``
   on the synthetic databio chr1 pair and on the whole-genome pair, checked
   against the known counts and an independent numpy BITS count; every
   kernel's launch counter must rise; warm query time and each kernel's
   time against its plain version (CUDA events), beside the card's name
   and power limit;
5. the q1 fixture through the port's CLI (host route), expecting 16.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

CHR1_EXPECTED = 153_690_858
GENOME_EXPECTED = 99_159_827
Q1_EXPECTED = 16
WARM_QUERIES = 10
TIMED_LAUNCHES = 20


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


def phase_kernels(torch, dev) -> dict:
    print("== phase 3: kernels vs plain (exact)", flush=True)
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    rng = np.random.default_rng(0)
    err = {"pack_view": 0, "merge_rank_sorted": 0}
    # (table rows N, query rows M): empty table, ragged M, chr1 and genome
    # padded view shapes in both directions
    shapes = [(0, 300), (1, 1), (2048, 1000), (5000, 257), (303_104, 208_896),
              (7_684_096, 2_351_104), (2_351_104, 7_684_096)]
    for n, m in shapes:
        a = sorted_u32(rng, n, torch, dev)
        q = sorted_u32(rng, m, torch, dev)
        for strict in (True, False):
            got = mc.merge_rank_sorted(a, q, strict=strict)
            want = mc.merge_rank_plain(a, q, strict=strict)
            d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if m else 0
            s_got = int(mc.merge_rank_sorted(a, q, strict=strict, reduce=True))
            s_want = int(mc.merge_rank_plain(a, q, strict=strict, reduce=True))
            err["merge_rank_sorted"] = max(err["merge_rank_sorted"], d, abs(s_got - s_want))
            if d or s_got != s_want:
                fail(f"merge_rank_sorted N={n} M={m} strict={strict}: "
                     f"max |diff| {d}, sums {s_got} vs {s_want}")
        print(f"merge_rank_sorted N={n} M={m}: ranks and sums equal for strict=True/False")
    for n, nkeys in ((0, 1), (1000, 3), (1_000_003, 24), (7_684_096, 24)):
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
    torch.cuda.synchronize()
    return err


def bits_count(t1: dict, t2: dict) -> int:
    """Independent numpy BITS count of the overlap join t1 x t2 on contig:
    sum over build rows of #{probe start <= end} - #{probe end < start}
    within the same contig, on int64 (contig, value) composites."""
    keys = np.unique(np.concatenate([t1["contig"], t2["contig"]]))
    kb = np.searchsorted(keys, t1["contig"]).astype(np.int64) << 32
    kq = np.searchsorted(keys, t2["contig"]).astype(np.int64) << 32
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


def phase_main_path(torch, dev, card: str):
    print("== phase 4: main path through SessionContext(device='cuda').sql", flush=True)
    import pyarrow as pa

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.ops.cuda import merge_count as mc
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
        sessions.append((name, ctx, expected))
        print(f"{name}: {len(t1['contig'])} x {len(t2['contig'])} rows, "
              f"numpy BITS reference {ref}")

    mc.pack_view.launches = 0
    mc.merge_rank_sorted.launches = 0
    for name, ctx, expected in sessions:
        got = int(ctx.sql(bd.QUERY).column_np(0)[0])
        if got != expected:
            fail(f"{name}: port returned {got}, expected {expected}")
    torch.cuda.synchronize()
    launches = {
        "pack_view": mc.pack_view.launches,
        "merge_rank_sorted": mc.merge_rank_sorted.launches,
    }
    print(f"main path counts correct; kernel launches in the main path: {launches}")
    for kname, n in launches.items():
        if n <= 0:
            fail(f"kernel {kname} was not launched by the main path")

    times = {}
    for name, ctx, expected in sessions:
        ts = []
        for _ in range(WARM_QUERIES):
            t0 = time.perf_counter()
            got = int(ctx.sql(bd.QUERY).column_np(0)[0])
            ts.append(time.perf_counter() - t0)
            if got != expected:
                fail(f"{name}: warm query returned {got}")
        times[name] = float(np.median(ts)) * 1e3
        print(f"{name}: warm median {times[name]:.3f} ms/query over {WARM_QUERIES} "
              f"queries, min {min(ts) * 1e3:.3f} ms [{card}]")

    # kernel vs plain time at the genome main-path shapes: the plan's own
    # device tensors, turns plain, kernel, kernel, plain
    name, ctx, _ = sessions[1]
    join = ctx.plan_sql(bd.QUERY).children[0]
    left, right = ctx.table("s1"), ctx.table("s2")
    inputs = join._sorted_count_inputs(left, right)
    plan = join._merge_count_plan(left, right, *inputs)
    bq_k, bq_v, c_bq, pq_k, pq_v, c_pq = plan[:6]
    q1 = mc.pack_view(bq_k, bq_v, c_bq, mc.BUILD_PAD)
    a1 = mc.pack_view(pq_k, pq_v, c_pq, mc.PROBE_PAD)
    cases = {
        "pack_view": (
            lambda: mc.pack_view_plain(pq_k, pq_v, c_pq, mc.PROBE_PAD),
            lambda: mc.pack_view(pq_k, pq_v, c_pq, mc.PROBE_PAD),
            f"n={pq_k.numel()}",
        ),
        "merge_rank_sorted": (
            lambda: mc.merge_rank_plain(a1, q1, strict=False, reduce=True),
            lambda: mc.merge_rank_sorted(a1, q1, strict=False, reduce=True),
            f"N={a1.numel()} M={q1.numel()} reduce=True",
        ),
    }
    kernel_ms = {}
    for kname, (plain, kern, shape) in cases.items():
        p1 = time_events(torch, plain, TIMED_LAUNCHES)
        k1 = time_events(torch, kern, TIMED_LAUNCHES)
        k2 = time_events(torch, kern, TIMED_LAUNCHES)
        p2 = time_events(torch, plain, TIMED_LAUNCHES)
        kernel_ms[kname] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"{kname} ({name} pair, {shape}): kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms [{card}]")
    return launches, kernel_ms, times


def phase_q1():
    print("== phase 5: q1 fixture through the port's CLI", flush=True)
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    if not os.path.isdir(os.path.join(here, "sequila_tpu_torch")):
        fail("sequila_tpu_torch not found beside chip_smoke.py: run it from the repository")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    card = phase_toolchain(torch)
    phase_build()
    err = phase_kernels(torch, dev)
    launches, kernel_ms, _ = phase_main_path(torch, dev, card)
    phase_q1()
    if "jax" in sys.modules:
        fail("the port imported jax")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [
        {
            "name": "merge_rank_sorted",
            "route": "cuda",
            "source": "sequila_tpu_torch/csrc/merge_rank.cu",
            "replaces": "sequila_tpu/ops/pallas/merge_count.py:110",
            "launches": launches["merge_rank_sorted"],
            "max_abs_err": err["merge_rank_sorted"],
            "ms": kernel_ms["merge_rank_sorted"][0],
            "plain_ms": kernel_ms["merge_rank_sorted"][1],
        },
        {
            "name": "pack_view",
            "route": "cuda",
            "source": "sequila_tpu_torch/csrc/merge_rank.cu",
            "replaces": "sequila_tpu/ops/pallas/merge_count.py:158",
            "launches": launches["pack_view"],
            "max_abs_err": err["pack_view"],
            "ms": kernel_ms["pack_view"][0],
            "plain_ms": kernel_ms["pack_view"][1],
        },
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
