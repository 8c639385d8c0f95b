"""Device-to-device shuffle: hash repartition of both tables between the
shards of the mesh's 'part' axis (port of sequila_tpu/parallel/shuffle.py).

The other modules of this package partition on the host (the single-host
stand-in).  Here rows start arbitrarily spread over the 'part' shards
(dealt round-robin, as if freshly scanned), every shard sorts its rows by
destination (key hash), and each destination's slice moves to that
shard's device: with ``.to(device)`` when the destination shard belongs
to the same process (on a host with several cards these copies are peer
to peer), else through one ``all_to_all_single`` between the processes
(the counts first, then the rows packed as one int32 [rows, columns]
tensor).  The shuffled shards are then counted in place with the BITS
sum of ranks (no sorted input, no level structure), or joined by the
max-extension window with row ids riding along.

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
from sequila_tpu_torch.parallel import distributed
from sequila_tpu_torch.parallel import partitioned_join as pj
from sequila_tpu_torch.parallel.distributed import agree
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


def _exchange(mesh: Mesh, shards: dict, width: int) -> dict:
    """The all_to_all over 'part': ``shards[p]`` is (keys, valid, *cols)
    of local shard p on its device, int32, ``width`` columns with the
    keys; every row moves to shard ``key % nparts``.  Returns, per local
    destination, its received (keys, *cols), concatenated in source
    order."""
    nparts = mesh.shape["part"]
    mine = [d for d in range(nparts) if mesh.is_local(d)]
    recv = {d: {} for d in mine}  # destination -> source -> columns
    remote = {}  # (destination, source) -> columns, for other processes
    counts = torch.zeros((nparts, nparts), dtype=torch.int64)
    with agree():
        for p, (keys, valid, *cols) in shards.items():
            offsets, k_s, c_s = _dest_sorted(keys, valid, nparts, *cols)
            for d in range(nparts):
                lo, hi = offsets[d], offsets[d + 1]
                counts[p, d] = hi - lo
                block = [c[lo:hi] for c in (k_s, *c_s)]
                if mesh.is_local(d):
                    recv[d][p] = [c.to(mesh.device(d)) for c in block]
                else:
                    remote[d, p] = block
    if distributed.in_group():
        _exchange_remote(mesh, counts, remote, recv, width)
    return {d: [torch.cat(col) for col in zip(*(recv[d][p] for p in sorted(recv[d])))]
            for d in mine}


def _exchange_remote(mesh: Mesh, counts, remote: dict, recv: dict, width: int) -> None:
    """The blocks between processes: the [source, destination] row counts
    all-reduced first, then one uneven ``all_to_all_single`` of int32
    [rows, columns] blocks, ordered (destination, source) on both sides.
    Fills ``recv[d][p]`` for every remote source p of local destination d."""
    rank, size = distributed.world()
    owner = [int(o) for o in mesh.owners[:, 0]]
    counts = distributed.all_reduce(counts)
    parts_of = [[p for p in range(len(owner)) if owner[p] == r] for r in range(size)]
    dev = distributed.collective_device()
    send = {
        r: torch.cat([torch.stack(remote[d, p], 1).to(dev) for d in parts_of[r]
                      for p in parts_of[rank]] or [torch.empty((0, width), dtype=torch.int32)])
        for r in range(size) if r != rank
    }
    recv_rows = {r: int(counts[parts_of[r]][:, sorted(recv)].sum()) for r in range(size)}
    got = distributed.all_to_all_rows(send, recv_rows, width)
    for r, rows in got.items():
        lo = 0
        for d in sorted(recv):
            for p in parts_of[r] if r != rank else ():
                n = int(counts[p, d])
                block = rows[lo : lo + n].to(mesh.device(d))
                recv[d][p] = [block[:, j] for j in range(width)]
                lo += n


def _part_column(mesh: Mesh) -> Mesh:
    """The shards of the 'part' axis: the (nparts, 1) mesh of each part's
    first device and its owner (the exchange runs over 'part' only; the
    JAX package replicates it over 'probe')."""
    return Mesh(mesh.devices[:, :1], mesh.owners[:, :1])


def _place(mesh: Mesh, *arrays) -> dict:
    """Row p of each [nparts, rows] array as a tensor on local shard p's
    device ({p: tuple of tensors})."""
    return {
        p: tuple(torch.from_numpy(np.ascontiguousarray(a[p])).to(mesh.device(p)) for a in arrays)
        for p in range(mesh.shape["part"]) if mesh.is_local(p)
    }


def all_to_all_partitioned_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    """Exact count with a device-to-device shuffle of both tables.

    Rows are dealt round-robin across the 'part' shards, shuffled by key
    hash, and counted shard-locally with the BITS sum of ranks; only one
    int64 a shard reaches the host after the upload.  Degenerate (qs > qe)
    probe rows and inverted builds must be routed elsewhere by the
    caller: BITS does not count them exactly."""
    mesh = _part_column(mesh)
    build, probe = (_shuffled(mesh, cols, width=3) for cols in ((lk, ls, le), (rk, rs, re)))
    with agree():
        partials = []
        for d, (bk, bs, be) in build.items():
            qk, qs, qe = probe[d]
            pu = ij._sum_ranks(bk, bs, qk, qe, side="right")
            pl = ij._sum_ranks(bk, be, qk, qs, side="left")
            partials.append(pu - pl)
    return pj.psum(partials)


def _shuffled(mesh: Mesh, cols, width: int) -> dict:
    """One table (k, s, e) dealt over the local 'part' shards and
    exchanged by key hash: per local destination its (k, s, e), with the
    global row ids when ``width`` is 4."""
    K, S, E, I = _deal(*cols, mesh.shape["part"])
    with agree():
        placed = _place(mesh, K, S, E, I)
    return _exchange(
        mesh, {p: (k, i >= 0, s, e, i)[: width + 1] for p, (k, s, e, i) in placed.items()}, width
    )


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
    """Pairs of candidate slots [base, base + capacity) of one shard: the
    (build row id, probe row id) of each candidate that overlaps, as an
    int32 [pairs, 2] tensor on the host."""
    sk, _, se, si = build
    slots = torch.arange(capacity, dtype=torch.int64, device=qk.device) + base
    cell = torch.searchsorted(offsets, slots, right=True) - 1
    cell = torch.clamp(cell, 0, qk.numel() - 1)
    g = torch.clamp(lb[cell] + (slots - offsets[cell]), 0, sk.numel() - 1)
    match = (slots < offsets[-1]) & (se[g] >= qs[cell]) & (sk[g] == qk[cell])
    return torch.stack((si[g][match], qi[cell][match]), 1).cpu()


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
    mesh = _part_column(mesh)
    build, probe = (_shuffled(mesh, cols, width=4) for cols in ((lk, ls, le), (rk, rs, re)))
    with agree():
        windows = {d: _window_bounds(*b, *probe[d][:3]) for d, b in build.items()}
        local = {(d, 0): off[-1:].to(torch.int64) for d, (_, _, off) in windows.items()}
    totals = pj.fetch_global(mesh, local).reshape(-1)
    need = int(totals.max(initial=0))
    if need >= 2**31:
        raise ExecutionError(
            "a shuffle shard's candidate window count exceeded 2^31 (the "
            "int32 emit arithmetic limit); raise target_partitions"
        )
    pair_cap = _bucket(min(need, chunk_limit), minimum=1024)
    out_b, out_q = [], []
    for base in range(0, need, pair_cap):
        local = {}
        with agree():
            for d, (sorted_build, lb, offsets) in windows.items():
                if totals[d] <= base:
                    local[d, 0] = torch.empty((0, 2), dtype=torch.int32)
                    continue
                qk, qs, _, qi = probe[d]
                local[d, 0] = _window_emit(sorted_build, lb, offsets, qk, qs, qi, base, pair_cap)
        for pairs in pj.gather_shards(mesh, local).values():
            out_b.append(pairs[:, 0].numpy())
            out_q.append(pairs[:, 1].numpy())
    if not out_b:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_b).astype(np.int64), np.concatenate(out_q).astype(np.int64)
