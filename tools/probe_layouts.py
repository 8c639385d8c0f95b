"""Time designs of the per-probe counts' un-permute on one NVIDIA GPU.

    python3 tools/probe_layouts.py

Builds the genome pair (``gen_genome_table(2_350_965, 21)`` as the build,
``(7_684_066, 22)`` as the probe), its per-probe count plan
(``merge_count.plan_verb_ranks(want4=False)``) and the two view-order rank
planes (one B1 launch), then times with CUDA events, two turns of 20
launches each, every way to get ``out[i] = ranks[0, inv_e[i]] -
ranks[1, inv_s[i]]``:
- the package's kernel (``merge_count.unpermute_counts``: blocks
  plane-major, each adding its plane's term into a zeroed output with
  red.add);
- from ``tools/probe_layouts.cu``, built here with nvcc: one pass that
  reads both planes for each row; two launches of one plane each (the
  second reads the output back); the package's reduction with an L2
  evict-first policy on the reductions; one launch plane-major by ticket
  (blocks take tickets as they start, plane 1's wait for plane 0's of
  the same rows, then subtract from what they stored), also held against
  the plain version at ragged sizes;
- two ``torch.index_select`` and a subtraction.
Each result is held against ``merge_probe_count_passes_plain``; the card's
name and power limit are printed beside the times, with the bytes bound
(ranks, inverse orders and counts over 3.35 TB/s).  Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPS = 20
HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import pyarrow as pa
    import torch

    from sequila_tpu_torch import bench_data as bd
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.ops.cuda import _lib
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    so = os.path.join(_lib.BUILD_DIR, "libprobe_layouts.so")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so,
                          os.path.join(HERE, "probe_layouts.cu")], capture_output=True, text=True)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode:
        sys.exit("nvcc failed on tools/probe_layouts.cu")
    lib = ctypes.CDLL(so)
    ways_c = ("pl_counts_one_pass", "pl_counts_two_launches", "pl_counts_red_evict_first")
    for name in ways_c:
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    lib.pl_counts_ticket.restype = ctypes.c_int
    lib.pl_counts_ticket.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]

    build = Table(pa.table(bd.gen_genome_table(bd.GENOME_LEFT, 21)))
    probe = Table(pa.table(bd.gen_genome_table(bd.GENOME_RIGHT, 22)))
    plan = mc.plan_verb_ranks(build, probe, (0, 1, 2), (0, 1, 2), want4=False, device="cuda")
    n, invs = plan.n, (plan.inv_qe, plan.inv_qs)
    packed = [mc.pack_view(*p, mc.BUILD_PAD) for p in (plan.pqe, plan.pqs)]
    ranks = torch.empty((2, n), dtype=torch.int32, device="cuda")
    mc.merge_rank_segments(plan.segplan, (*packed, ranks.view(-1)))
    want = mc.merge_probe_count_passes_plain(plan)
    out = torch.empty(n, dtype=torch.int32, device="cuda")

    def c_way(name):
        fn = getattr(lib, name)

        def run():
            err = fn(ranks.data_ptr(), invs[0].data_ptr(), invs[1].data_ptr(), out.data_ptr(), n,
                     torch.cuda.current_stream().cuda_stream)
            _lib.check(err, name)
            return out
        return run

    def ticket_way(m):
        """The ticket design on the first m rows (m = n: the genome shape)."""
        sync = torch.empty(2 + m // 1024, dtype=torch.int32, device="cuda")
        r, ie, is_ = ranks[:, :m].contiguous(), invs[0][:m], invs[1][:m]
        if m < n:  # inverse orders of m rows: a permutation of 0 .. m - 1
            ie = torch.argsort(torch.argsort(ie)).to(torch.int32)
            is_ = torch.argsort(torch.argsort(is_)).to(torch.int32)
        res = torch.empty(m, dtype=torch.int32, device="cuda")

        def run():
            err = lib.pl_counts_ticket(r.data_ptr(), ie.data_ptr(), is_.data_ptr(), res.data_ptr(),
                                       sync.data_ptr(), m, torch.cuda.current_stream().cuda_stream)
            _lib.check(err, "pl_counts_ticket")
            return res
        return run, (r, ie, is_)

    for m in (1, 2, 1023, 1024, 1025, 70_001):  # ragged chunks against the plain version
        run, args = ticket_way(m)
        if not torch.equal(run(), mc.unpermute_counts_plain(*args)):
            sys.exit(f"the ticket design differs from unpermute_counts_plain at n={m}")
    ways = {
        "plane-major red.add (unpermute_counts)": lambda: mc.unpermute_counts(ranks, *invs),
        "one pass, both planes": c_way("pl_counts_one_pass"),
        "two launches, one plane each": c_way("pl_counts_two_launches"),
        "plane-major red.add, L2 evict-first": c_way("pl_counts_red_evict_first"),
        "one launch, plane-major by ticket": ticket_way(n)[0],
        "torch.index_select x 2 and a subtraction": lambda: (
            torch.index_select(ranks[0], 0, invs[0]) - torch.index_select(ranks[1], 0, invs[1])),
    }
    for name, fn in ways.items():
        if not torch.equal(fn(), want):
            sys.exit(f"{name} differs from merge_probe_count_passes_plain")
    nbytes = 4 * (2 * n + 2 * n + n)
    print(f"bound: {nbytes} bytes (2 rank planes, 2 inverse orders, the counts) over 3.35 TB/s "
          f"= {nbytes / 3.35e9:.4f} ms (n={n}) [{card}]", flush=True)
    for turn in (1, 2):
        for name, fn in ways.items():
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            print(f"turn {turn}, {name}: {start.elapsed_time(end) / REPS:.4f} ms "
                  f"(n={n}) [{card}]", flush=True)


if __name__ == "__main__":
    main()
