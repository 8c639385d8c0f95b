"""Lexicographic ranks against a resident build that finds its own windows.

Port of sequila_tpu/ops/pallas/rank_kernel.py.  ``rank_sorted_resident``
ranks sorted int32 (key, value) queries in a sorted build of at most
MAX_RESIDENT_BUILD rows: the hand-written CUDA kernel csrc/rank_kernel.cu
(B3).  Each block of BLOCK queries loads the build's chunk-boundary
elements into shared memory, finds its window of chunks there with two
binary searches, and searches the window in global memory — no host
windows, which is what separates it from the stream kernel (B2).

``rank_lex_resident`` is the drop-in for ops/ranks.rank_lex_sort on
2-tuple keys (the JAX package's ``rank_lex_pallas``): it sorts both sides,
ranks, and scatters back; above MAX_RESIDENT_BUILD rows it ranks by
``rank_lex_sort`` instead, as the JAX package does above its VMEM cap.  As
in the JAX package, only tests reach it.

The wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain PyTorch version only for CPU tensors;
``rank_sorted_resident.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from sequila_tpu_torch.ops.cuda.merge_count import _check, _same_device
from sequila_tpu_torch.ops.cuda.stream_rank import BLOCK, CHUNK, sorted_padded
from sequila_tpu_torch.ops.ranks import composite, rank_lex_sort

# the chunk-boundary table (MAX / CHUNK = 512 pairs, 4 KB) must fit shared
# memory; the JAX package's MAX_VMEM_BUILD
MAX_RESIDENT_BUILD = 1 << 20


def rank_resident_plain(a_keys, a_vals, q_keys, q_vals, *, strict: bool,
                        reduce: bool = False) -> torch.Tensor:
    """Plain PyTorch rank_sorted_resident: one searchsorted over int64
    composites (the kernel's windows are exact for sorted inputs)."""
    ranks = torch.searchsorted(
        composite(a_keys, a_vals), composite(q_keys, q_vals), right=not strict
    )
    if reduce:
        return ranks.sum()
    return ranks.to(torch.int32)


def rank_sorted_resident(a_keys, a_vals, q_keys, q_vals, *, strict: bool,
                         reduce: bool = False) -> torch.Tensor:
    """Rank sorted (key, value) queries in the sorted build (a_keys,
    a_vals), whose length is a multiple of CHUNK and at most
    MAX_RESIDENT_BUILD.  strict=True counts build tuples ``<`` the query,
    strict=False ``<=``.  Returns int32 ranks, or with ``reduce=True``
    their int64 sum as a 0-d tensor.
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
    dev = _same_device(a_keys, a_vals, q_keys, q_vals)
    if dev.type == "cpu":
        return rank_resident_plain(a_keys, a_vals, q_keys, q_vals,
                                   strict=strict, reduce=reduce)
    from sequila_tpu_torch.ops.cuda import _lib

    total = torch.zeros((), dtype=torch.int64, device=dev) if reduce else None
    ranks = None if reduce else torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return total if reduce else ranks
    with torch.cuda.device(dev):
        err = _lib.lib().seq_resident_rank(
            a_keys.data_ptr(), a_vals.data_ptr(), n_pad, q_keys.data_ptr(),
            q_vals.data_ptr(), m, int(strict),
            None if reduce else ranks.data_ptr(),
            total.data_ptr() if reduce else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "rank_sorted_resident")
    rank_sorted_resident.launches += 1
    return total if reduce else ranks


rank_sorted_resident.launches = 0


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
