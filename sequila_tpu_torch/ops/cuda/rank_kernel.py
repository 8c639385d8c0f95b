"""Lexicographic ranks against a resident build.

Port of sequila_tpu/ops/pallas/rank_kernel.py.  ``rank_sorted_resident``
ranks sorted int32 (key, value) queries in a sorted build of at most
MAX_RESIDENT_BUILD rows: one segment of the hand-written CUDA merge path
over pairs, csrc/pair_merge.cu (B3, ops/cuda/pair_merge.py), with no
windows at all — what separated the TPU kernel from the stream kernel
(B2) was that it found its own.

``rank_lex_resident`` is the drop-in for ops/ranks.rank_lex_sort on
2-tuple keys (the JAX package's ``rank_lex_pallas``): it sorts both sides,
ranks, and scatters back; above MAX_RESIDENT_BUILD rows it ranks by
``rank_lex_sort`` instead, as the JAX package does above its VMEM cap.  As
in the JAX package, only tests reach it.

The wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain PyTorch version only for CPU tensors; the counter
``launch.pair_merge`` counts kernel launches.
"""

from __future__ import annotations

import torch

from sequila_tpu_torch.ops.cuda.merge_count import _check
from sequila_tpu_torch.ops.cuda.pair_merge import BLOCK, CHUNK, pair_rank_plain, rank_pairs
from sequila_tpu_torch.ops.cuda.stream_rank import sorted_padded
from sequila_tpu_torch.ops.ranks import rank_lex_sort

# the JAX package's MAX_VMEM_BUILD: its contract, kept though the merge
# path has no cap of its own
MAX_RESIDENT_BUILD = 1 << 20


def rank_resident_plain(a_keys, a_vals, q_keys, q_vals, *, strict: bool,
                        reduce: bool = False) -> torch.Tensor:
    """Plain PyTorch rank_sorted_resident: one searchsorted over int64
    composites."""
    ranks = pair_rank_plain(a_keys, a_vals, q_keys, q_vals, strict=strict)
    if reduce:
        return ranks.sum()
    return ranks.to(torch.int32)


def rank_sorted_resident(a_keys, a_vals, q_keys, q_vals, *, strict: bool,
                         reduce: bool = False) -> torch.Tensor:
    """Rank sorted (key, value) queries in the sorted build (a_keys,
    a_vals), whose length is a multiple of CHUNK and at most
    MAX_RESIDENT_BUILD.  strict=True counts build tuples ``<`` the query,
    strict=False ``<=``.  Returns int32 ranks, or with ``reduce=True``
    their int64 sum as a 0-d tensor.  One segment of the pair-merge launch
    (pair_merge.py).
    Replaces the TPU kernel sequila_tpu/ops/pallas/rank_kernel.py:126
    ::_pallas_rank_sorted (B3)."""
    for t, name in ((a_keys, "a_keys"), (a_vals, "a_vals"), (q_keys, "q_keys"),
                    (q_vals, "q_vals")):
        _check(t, name)
    n_pad = a_keys.numel()
    m = q_keys.numel()
    if a_vals.numel() != n_pad or q_vals.numel() != m:
        raise ValueError("keys and values differ in length")
    if n_pad % CHUNK or n_pad > MAX_RESIDENT_BUILD:
        raise ValueError(
            f"build of {n_pad} rows: expected a multiple of {CHUNK}, at most "
            f"{MAX_RESIDENT_BUILD}"
        )
    return rank_pairs(a_keys, a_vals, q_keys, q_vals, strict=strict, reduce=reduce)


def rank_lex_resident(build_keys, query_keys, side: str = "left"):
    """Drop-in alternative to rank_lex_sort for 2-tuple keys: sorts the
    build side and the queries, runs the resident kernel, and scatters the
    ranks back to query order.  Query keys must be below the PAD key
    2^31 - 1 (the PAD convention)."""
    bk, bv = build_keys
    qk, qv = query_keys
    n = bk.numel()
    m = qk.numel()
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.int32, device=qk.device)
    if n > MAX_RESIDENT_BUILD:
        return rank_lex_sort(build_keys, query_keys, side=side)
    a_k, a_v, _ = sorted_padded(bk, bv, -(-n // CHUNK) * CHUNK)
    sk, sv, sidx = sorted_padded(qk, qv, -(-m // BLOCK) * BLOCK)
    ranks_sorted = rank_sorted_resident(a_k, a_v, sk, sv, strict=side == "left")
    ranks = torch.empty_like(ranks_sorted)
    ranks[sidx] = ranks_sorted
    return ranks[:m]
