"""Device-to-device shuffle: hash repartition of both tables between the
shards of the mesh's 'part' axis (port of sequila_tpu/parallel/shuffle.py).

The other modules of this package partition on the host (the single-host
stand-in).  Here rows start arbitrarily spread over the 'part' shards
(dealt round-robin, as if freshly scanned), every shard sorts its rows by
destination (key hash), and each destination's slice moves to that
shard's device with ``.to(device)`` — the port's ``all_to_all``; on a
host with several cards these copies are peer to peer.  The shuffled
shards are then counted in place with the BITS sum of ranks (no sorted
input, no level structure), or joined by the max-extension window with
row ids riding along.

The JAX package pads every (source, destination) bucket to one static
capacity, sized by a first pass (the pmax of the bucket counts); the
port's exchange moves each bucket at its exact size, read from the
destination-sorted offsets, so it needs no sizing pass.
"""

from __future__ import annotations

import numpy as np
import torch

from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.ops import interval_join as ij
from sequila_tpu_torch.ops.interval_index import PAD_KEY, PAD_VAL, _bucket
from sequila_tpu_torch.ops.ranks import composite
from sequila_tpu_torch.parallel.mesh import Mesh


def _deal(k, s, e, nparts):
    """Round-robin deal over the 'part' shards, with global row ids in the
    validity column (-1 = padding).  Returns [nparts, rows] arrays."""
    n = len(k)
    rows = _bucket(max(-(-n // nparts), 1), minimum=8)
    K = np.full((nparts, rows), PAD_KEY, np.int32)
    S = np.full((nparts, rows), PAD_VAL, np.int32)
    E = np.full((nparts, rows), PAD_VAL, np.int32)
    I = np.full((nparts, rows), -1, np.int32)
    for p in range(nparts):
        sl = slice(p, n, nparts)
        cnt = len(k[sl])
        K[p, :cnt] = k[sl]
        S[p, :cnt] = s[sl]
        E[p, :cnt] = e[sl]
        I[p, :cnt] = np.arange(p, n, nparts)
    return K, S, E, I


def _dest_sorted(keys, valid, nparts, *cols):
    """Stable sort of one shard's rows by destination (``key % nparts``;
    invalid rows go last and are never sent).  Returns (per-destination
    start offsets [nparts + 1] on the host, the sorted key column, the
    sorted ``cols``)."""
    dest = torch.where(valid, keys % nparts, nparts)
    order = torch.sort(dest, stable=True).indices
    offsets = torch.searchsorted(
        dest[order], torch.arange(nparts + 1, dtype=dest.dtype, device=dest.device)
    )
    return offsets.tolist(), keys[order], [c[order] for c in cols]


def _exchange(mesh: Mesh, shards) -> list[list[torch.Tensor]]:
    """The all_to_all over 'part': ``shards[p]`` is (keys, valid, *cols)
    on shard p's device; every row moves to shard ``key % nparts``.
    Returns, per destination, its received (keys, *cols), concatenated in
    source order."""
    nparts = mesh.shape["part"]
    recv = [[] for _ in range(nparts)]
    for keys, valid, *cols in shards:
        offsets, k_s, c_s = _dest_sorted(keys, valid, nparts, *cols)
        for d in range(nparts):
            lo, hi = offsets[d], offsets[d + 1]
            recv[d].append([c[lo:hi].to(mesh.device(d)) for c in (k_s, *c_s)])
    return [[torch.cat(col) for col in zip(*parts)] for parts in recv]


def _place(mesh: Mesh, *arrays):
    """Row p of each [nparts, rows] array as a tensor on shard p's device."""
    return [
        tuple(torch.from_numpy(np.ascontiguousarray(a[p])).to(mesh.device(p)) for a in arrays)
        for p in range(mesh.shape["part"])
    ]


def all_to_all_partitioned_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    """Exact count with a device-to-device shuffle of both tables.

    Rows are dealt round-robin across the 'part' shards, shuffled by key
    hash, and counted shard-locally with the BITS sum of ranks; only one
    int64 a shard reaches the host after the upload.  Degenerate (qs > qe)
    probe rows and inverted builds must be routed elsewhere by the
    caller: BITS does not count them exactly."""
    nparts = mesh.shape["part"]
    BK, BS, BE, BI = _deal(lk, ls, le, nparts)
    QK, QS, QE, QI = _deal(rk, rs, re, nparts)
    build = _exchange(mesh, [(k, i >= 0, s, e) for k, s, e, i in _place(mesh, BK, BS, BE, BI)])
    probe = _exchange(mesh, [(k, i >= 0, s, e) for k, s, e, i in _place(mesh, QK, QS, QE, QI)])
    partials = []
    for (bk, bs, be), (qk, qs, qe) in zip(build, probe):
        pu = ij._sum_ranks(bk, bs, qk, qe, side="right")
        pl = ij._sum_ranks(bk, be, qk, qs, side="left")
        partials.append(pu - pl)
    return sum(int(x) for x in partials)


def _window_bounds(bk, bs, be, bi, qk, qs, qe):
    """One shard's max-extension window: its received build rows sorted by
    (key, start) (stable, so ties keep their arrival order), and every
    probe's candidate run [lb, ub) among them with exclusive offsets."""
    comp, order = torch.sort(composite(bk, bs), stable=True)
    sk, ss, se, si = bk[order], bs[order], be[order], bi[order]
    max_len = (se.to(torch.int64) - ss).max() if sk.numel() else 0
    lo_q = ij.sat_sub_i32(qs, max_len)
    lb = torch.searchsorted(comp, composite(qk, lo_q))
    ub = torch.searchsorted(comp, composite(qk, qe), right=True)
    widths = torch.clamp(ub - lb, min=0)
    offsets = torch.cat([widths.new_zeros(1), torch.cumsum(widths, 0)])
    return (sk, ss, se, si), lb, offsets


def _window_emit(build, lb, offsets, qk, qs, qi, base: int, capacity: int):
    """Pairs of candidate slots [base, base + capacity) of one shard:
    (build row ids, probe row ids) of the candidates that overlap."""
    sk, _, se, si = build
    slots = torch.arange(capacity, dtype=torch.int64, device=qk.device) + base
    cell = torch.searchsorted(offsets, slots, right=True) - 1
    cell = torch.clamp(cell, 0, qk.numel() - 1)
    g = torch.clamp(lb[cell] + (slots - offsets[cell]), 0, sk.numel() - 1)
    match = (slots < offsets[-1]) & (se[g] >= qs[cell]) & (sk[g] == qk[cell])
    return si[g][match].cpu().numpy(), qi[cell][match].cpu().numpy()


def all_to_all_partitioned_pairs(mesh: Mesh, lk, ls, le, rk, rs, re,
                                 chunk_limit: int = 1 << 22):
    """Exact materializing join with the device-to-device shuffle: both
    tables exchanged by key hash (row ids ride along), each shard sorts
    its build rows and window-emits its pairs; the host only concatenates
    the valid (build_row, probe_row) ids.

    The emission buffer is capped at ``chunk_limit`` candidate slots a
    shard; bigger shards drain in several passes with advancing base
    offsets.  A shard whose candidate count reaches 2^31 is an
    ExecutionError, as in the JAX package (its int32 emit arithmetic)."""
    nparts = mesh.shape["part"]
    BK, BS, BE, BI = _deal(lk, ls, le, nparts)
    QK, QS, QE, QI = _deal(rk, rs, re, nparts)
    build = _exchange(mesh, [(k, i >= 0, s, e, i) for k, s, e, i in _place(mesh, BK, BS, BE, BI)])
    probe = _exchange(mesh, [(k, i >= 0, s, e, i) for k, s, e, i in _place(mesh, QK, QS, QE, QI)])
    windows = [_window_bounds(*b, *q[:3]) for b, q in zip(build, probe)]
    totals = [int(off[-1]) for _, _, off in windows]
    need = max(totals, default=0)
    if need >= 2**31:
        raise ExecutionError(
            "a shuffle shard's candidate window count exceeded 2^31 (the "
            "int32 emit arithmetic limit); raise target_partitions"
        )
    pair_cap = _bucket(min(need, chunk_limit), minimum=1024)
    out_b, out_q = [], []
    for base in range(0, need, pair_cap):
        for d, (sorted_build, lb, offsets) in enumerate(windows):
            if totals[d] <= base:
                continue
            qk, qs, _, qi = probe[d]
            b, q = _window_emit(sorted_build, lb, offsets, qk, qs, qi, base, pair_cap)
            out_b.append(b)
            out_q.append(q)
    if not out_b:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_b).astype(np.int64), np.concatenate(out_q).astype(np.int64)
