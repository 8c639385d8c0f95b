"""Time the genomic verbs' un-permute in two layouts on one NVIDIA GPU.

    python3 tools/verb_layouts.py

Builds the genome pair (``gen_genome_table(2_350_965, 21)`` as the build,
``(7_684_066, 22)`` as the probe), its coverage plan
(``merge_count.plan_verb_ranks``) and the four view-order rank rows (one
B1 launch), then times with CUDA events, two turns of 20 launches each:
- the package's plane-major un-permute (``merge_count.unpermute_ranks``:
  four planes of n int32, one at a time);
- the pair layout (``tools/verb_layouts.cu``, built here with nvcc): the
  same ranks as int32 pairs, one 8-byte gather a view and probe row;
- ``torch.gather`` over a (4, n) int64 index.
Each result is held against ``merge_verb_rank4_plain``; the card's name and
power limit are printed beside the times.  Needs a CUDA device and nvcc.
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
    so = os.path.join(_lib.BUILD_DIR, "libverb_layouts.so")
    os.makedirs(_lib.BUILD_DIR, exist_ok=True)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(HERE, "verb_layouts.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.vl_unpermute_pairs.restype = ctypes.c_int
    lib.vl_unpermute_pairs.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int64, vp]

    build = Table(pa.table(bd.gen_genome_table(bd.GENOME_LEFT, 21)))
    probe = Table(pa.table(bd.gen_genome_table(bd.GENOME_RIGHT, 22)))
    plan = mc.plan_verb_ranks(build, probe, (0, 1, 2), (0, 1, 2), want4=True, device="cuda")
    n, invs = plan.n, (plan.inv_qe, plan.inv_qs)
    packed = [mc.pack_view(*p, mc.BUILD_PAD) for p in plan.packs]
    ranks = torch.empty((4, n), dtype=torch.int32, device="cuda")
    mc.merge_rank_segments(plan.segplan, (*packed, ranks.view(-1)))
    want = mc.merge_verb_rank4_plain(plan)
    pe = torch.stack([ranks[0], ranks[2]], 1).contiguous()
    ps = torch.stack([ranks[1], ranks[3]], 1).contiguous()
    index = torch.stack([*invs, *invs]).to(torch.int64)
    out = torch.empty_like(ranks)

    def pairs():
        err = lib.vl_unpermute_pairs(pe.data_ptr(), ps.data_ptr(), invs[0].data_ptr(),
                                     invs[1].data_ptr(), out.data_ptr(), n,
                                     torch.cuda.current_stream().cuda_stream)
        _lib.check(err, "vl_unpermute_pairs")
        return out

    ways = {
        "planes (unpermute_ranks)": lambda: mc.unpermute_ranks(ranks, *invs),
        "pairs (verb_layouts.cu)": pairs,
        "torch.gather": lambda: torch.gather(ranks, 1, index),
    }
    for name, fn in ways.items():
        if not torch.equal(fn(), want):
            sys.exit(f"{name} differs from merge_verb_rank4_plain")
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
