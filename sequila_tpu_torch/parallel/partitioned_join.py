"""Multi-device interval join: shard programs over a (part, probe) mesh
(port of sequila_tpu/parallel/partitioned_join.py).

The reference's PartitionMode::Partitioned (required distribution
HashPartitioned on the equi-keys, interval_join.rs:385-404, :472-510):
both sides are hash-partitioned by key code over mesh axis 'part', the
probe rows additionally row-split over mesh axis 'probe' (so every
(part, probe) shard owns one build partition x one probe slice).
Per-part indexes share one level layout, as in the JAX package; key
disjointness makes per-shard counts sum exactly to the global count.
(CollectLeft is the operator's single-device execution;
``collect_left_count`` is its mesh form: a replicated build, the probe
rows split over every shard.)

The JAX package runs each program as one shard_map.  Here each process
drives the shards it owns (``Mesh.is_local``): a shard program is a plain
function over the tensors placed on its shard's device
(``Mesh.device(part, probe)``), ``psum`` sums the local shards in int64
and all-reduces the sum over the processes (the JAX package's 8-row
int32 partials were a TPU workaround), and ``fetch_global`` gathers every
shard's result to every process's host.  As in the JAX package's
multi-host convention, every process holds the global tables and places
only its own shards; every process returns the same answer.  The shards'
work is enqueued device by device before any result is read, so shards
on different cards overlap.  Host-side hash partitioning is, as in the
JAX package, the single-host stand-in for the distributed shuffle
(parallel/shuffle.py is the exchange between devices).  A rank-local
block of shard work runs under ``distributed.agree``, so a rank that
raises makes every rank raise instead of leaving its peers waiting in a
collective.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.ops import interval_join as ij
from sequila_tpu_torch.ops.genomic import coverage_finish
from sequila_tpu_torch.ops.interval_index import (
    PAD_KEY,
    PAD_VAL,
    _bucket,
    build_interval_index,
)
from sequila_tpu_torch.parallel import distributed
from sequila_tpu_torch.parallel.distributed import agree
from sequila_tpu_torch.parallel.mesh import Mesh

# Per-shard rank strategy on CUDA when SEQUILA_MESH_BOUNDS is unset: the
# faster of the two in chip_smoke.py phase 7, which times both on every
# shard (PERF.md section 6).
_CUDA_BOUNDS = "sort"


def mesh_bounds_strategy(mesh: Mesh) -> str:
    """Per-shard rank strategy: 'sort' (one torch.searchsorted of int64
    composites per level) or 'bsearch' (the fixed-step vectorized binary
    search with gathers).

    The JAX package routes by backend (the co-sort on a TPU, bsearch on
    its CPU mesh).  The port keeps bsearch on the CPU and takes
    _CUDA_BOUNDS on a card; SEQUILA_MESH_BOUNDS=sort|bsearch overrides."""
    env = os.environ.get("SEQUILA_MESH_BOUNDS", "auto")
    if env in ("sort", "bsearch"):
        return env
    return _CUDA_BOUNDS if mesh.device(0).type == "cuda" else "bsearch"


def _shard_bounds(ix, k, s, e, meta, strategy):
    """Strategy-routed per-shard [lb, ub) level bounds of probe slots
    (k, s, e) in one shard's index ``ix`` (see mesh_bounds_strategy)."""
    lv, ky, st, en = (ix[n] for n in ("levels", "keys", "starts", "ends"))
    if strategy == "bsearch":
        return ij._bounds_bsearch(
            lv, ky, st, en, k, s, e, num_levels=meta["num_levels"],
            level_pad=meta["layout"], level_offsets=meta["level_offsets"],
        )
    return ij._bounds_sort(
        lv, ky, st, en, k, s, e,
        num_levels=meta["num_levels"], level_offsets=meta["level_offsets"],
    )


def _shards(mesh: Mesh):
    """(part, probe, device) of every shard this process owns, in mesh
    order."""
    for p in range(mesh.shape["part"]):
        for q in range(mesh.shape["probe"]):
            if mesh.is_local(p, q):
                yield p, q, mesh.device(p, q)


def gather_shards(mesh: Mesh, per_shard: dict) -> dict:
    """Every shard's tensor on this process's host ({(part, probe): cpu
    tensor}, in mesh order) from ``per_shard``, which holds a tensor for
    each local shard: the cross-process gather (sizes first, then one
    padded all-gather), or the local tensors' host copies with no group."""
    keys = [(p, q) for p in range(mesh.shape["part"]) for q in range(mesh.shape["probe"])]
    pieces = distributed.gather_var(
        [per_shard[p, q] for p, q, _ in _shards(mesh)], [int(mesh.owners[k]) for k in keys]
    )
    return dict(zip(keys, pieces))


def fetch_global(mesh: Mesh, per_shard: dict) -> np.ndarray:
    """Every shard's result stacked on the host as [part, probe, ...], on
    every process: the gather that replaces the JAX package's fetch of a
    sharded array."""
    out = [t.numpy() for t in gather_shards(mesh, per_shard).values()]
    return np.stack(out).reshape(mesh.devices.shape + out[0].shape)


def psum(values) -> int:
    """The int64 sum of the local shards' scalars, all-reduced over the
    processes."""
    return distributed.all_reduce_sum(sum(int(v) for v in values))


# ---------------------------------------------------------------------------
# Host-side partitioning and placement
# ---------------------------------------------------------------------------


def build_partitioned_index(lk, ls, le, npart: int, part_of=None, keys=None):
    """Partition the build side and build per-part indexes with one shared
    level layout.  Returns (stacked numpy arrays [npart, N] by field,
    meta).

    Default partitioning is key-hash (``lk % npart``); skew-aware callers
    pass explicit per-row ``part_of`` assignments and alternative ``keys``
    (shard ids) — rows may then appear in several parts via repeated
    indices in the caller's replica expansion.

    The JAX package levels each part twice (once for the covering layout,
    once to build at it); here each part's natural level view is built
    once and re-padded into the layout, which gives the same arrays: a
    level's rows keep their (key, start) order whatever its padding."""
    if part_of is None:
        part_of = lk % npart
    if keys is None:
        keys = lk
    parts = [np.nonzero(part_of == p)[0] for p in range(npart)]
    views = [build_interval_index(keys[rows], ls[rows], le[rows], device="cpu") for rows in parts]
    num_levels = max(v.num_levels for v in views)
    layout = tuple(
        _bucket(max(1, max((v.level_sizes[i] if i < v.num_levels else 0) for v in views)))
        for i in range(num_levels)
    )
    level_offsets = tuple(int(x) for x in np.concatenate([[0], np.cumsum(layout)[:-1]]))
    total = int(sum(layout))
    levels = np.repeat(np.arange(num_levels, dtype=np.int32), layout)
    fill = {"keys": PAD_KEY, "starts": PAD_VAL, "ends": PAD_VAL, "pos": -1}
    arrays = {"levels": np.tile(levels, (npart, 1))}
    arrays.update({name: np.full((npart, total), v, np.int32) for name, v in fill.items()})
    for p, (rows, v) in enumerate(zip(parts, views)):
        for lv, (size, old) in enumerate(zip(v.level_sizes, v.level_offsets)):
            new = level_offsets[lv]
            arrays["keys"][p, new : new + size] = v.keys_host[old : old + size]
            arrays["starts"][p, new : new + size] = v.starts_host[old : old + size]
            arrays["ends"][p, new : new + size] = v.ends_host[old : old + size]
            # positions are local to the part; remap to global build rows
            arrays["pos"][p, new : new + size] = rows[v.pos_host[old : old + size]]
    meta = {"num_levels": num_levels, "level_offsets": level_offsets, "layout": layout}
    return arrays, meta


def partition_probe(rk, rs, re, npart: int, nprobe: int, part_of=None, keys=None):
    """Hash-partition probe rows by key over 'part', row-split over 'probe'.

    Returns arrays of shape [npart, nprobe, M] plus the caller-row index of
    each slot ([-1] = padding) for result scattering.  Skew-aware callers
    pass explicit ``part_of`` and ``keys`` (shard ids) over replica rows.
    Padding slots are degenerate (never match)."""
    if part_of is None:
        part_of = rk % npart
    if keys is None:
        keys = rk
    groups = [np.nonzero(part_of == p)[0] for p in range(npart)]
    max_rows = max((len(g) for g in groups), default=1)
    per_chip = _bucket(max(1, -(-max_rows // nprobe)), minimum=8)
    K = np.full((npart, nprobe, per_chip), PAD_KEY, np.int32)
    S = np.full((npart, nprobe, per_chip), PAD_VAL, np.int32)
    E = np.full((npart, nprobe, per_chip), PAD_VAL - 2, np.int32)
    IDX = np.full((npart, nprobe, per_chip), -1, np.int32)
    for p, rows in enumerate(groups):
        for q in range(nprobe):
            sl = rows[q * per_chip : (q + 1) * per_chip]
            K[p, q, : len(sl)] = keys[sl]
            S[p, q, : len(sl)] = rs[sl]
            E[p, q, : len(sl)] = re[sl]
            IDX[p, q, : len(sl)] = sl
    return K, S, E, IDX


def place_index(mesh: Mesh, arrays: dict) -> dict:
    """Part p's index fields as tensors on the device of every local shard
    of mesh row p ({(part, probe): {field: tensor}}); ``arrays`` has one
    row a part, or one row that every part shares (the replicated build).
    A device that repeats holds one copy of a row."""
    out, placed = {}, {}
    for p, q, dev in _shards(mesh):
        row = p if len(next(iter(arrays.values()))) > 1 else 0
        if (row, dev) not in placed:
            placed[row, dev] = {
                name: torch.from_numpy(np.ascontiguousarray(a[row])).to(dev)
                for name, a in arrays.items()
            }
        out[p, q] = placed[row, dev]
    return out


def place_probe(mesh: Mesh, *arrays) -> dict:
    """Local shard (p, q)'s slice of each [npart, nprobe, M] array as a
    tensor on its device ({(part, probe): tuple of tensors})."""
    return {
        (p, q): tuple(torch.from_numpy(np.ascontiguousarray(a[p, q])).to(dev) for a in arrays)
        for p, q, dev in _shards(mesh)
    }


def _partitioned_inputs(mesh: Mesh, lk, ls, le, rk, rs, re):
    """Hash-partitioned build index and probe slots, placed on the mesh:
    (arrays, meta, index by shard, probe (k, s, e) by shard, IDX)."""
    npart, nprobe = mesh.shape["part"], mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    return arrays, meta, place_index(mesh, arrays), place_probe(mesh, K, S, E), IDX


# ---------------------------------------------------------------------------
# Shard programs
# ---------------------------------------------------------------------------


def shard_bounds(mesh: Mesh, meta, didx, dq) -> dict:
    """Every shard's [lb, ub) level bounds, enqueued shard by shard."""
    strategy = mesh_bounds_strategy(mesh)
    return {
        (p, q): _shard_bounds(didx[p, q], *dq[p, q], meta, strategy)
        for p, q, _ in _shards(mesh)
    }


def shard_totals(mesh: Mesh, bounds: dict) -> np.ndarray:
    """Exact per-shard match totals [npart, nprobe] in int64, guarded by
    the single-device emit path's limit (_EMIT_LIMIT): emit_pairs' slot and
    offset arithmetic is int32, so a shard that would emit >= 2^31 pairs
    must be an error, never a silent wrap."""
    with agree():
        sums = {k: ij.counts_from_bounds(lb, ub).sum(dtype=torch.int64)
                for k, (lb, ub) in bounds.items()}
    totals = fetch_global(mesh, sums).astype(np.int64)
    if totals.size and int(totals.max()) >= ij._EMIT_LIMIT:
        raise ExecutionError(
            f"a join shard would emit {int(totals.max())} pairs (>= 2^31, "
            "the int32 emit-offset limit); raise target_partitions so no "
            "single (part, probe) shard exceeds it"
        )
    return totals


def emit_all_shards(mesh: Mesh, meta, didx, bounds, totals, chunk_limit: int | None = None):
    """Drain every shard's pairs through fixed-capacity emission.

    Yields (part, probe, build_rows, probe_slots) of every shard of the
    mesh per chunk, on every process, chunk-major as the JAX package's
    calls run, with invalid slots stripped.  Each process emits its local
    shards; each chunk's pairs are then gathered to every process.
    ``totals`` is every shard's (shard_totals), so every process runs the
    same chunks.  ``chunk_limit`` caps the per-shard buffer (low-memory
    mode); None sizes it to the largest shard (one chunk)."""
    max_total = int(totals.max())
    cap = _bucket(max(1, min(max_total, chunk_limit) if chunk_limit else max_total), minimum=1024)
    with agree():
        cells = {k: ij.pair_offsets(lb, ub) for k, (lb, ub) in bounds.items()}
    for base in range(0, max_total, cap):
        local = {}
        with agree():
            for p, q, dev in _shards(mesh):
                if totals[p, q] <= base:
                    local[p, q] = torch.empty((0, 2), dtype=torch.int32)
                    continue
                offsets, lb_pm = cells[p, q]
                b, s, valid = ij.emit_pairs(
                    offsets, lb_pm, didx[p, q]["pos"], base, capacity=cap,
                    num_levels=meta["num_levels"], level_offsets=meta["level_offsets"],
                )
                # each shard's chunk leaves the device before the next is
                # emitted
                local[p, q] = torch.stack((b[valid], s[valid]), 1).to(torch.int32).cpu()
        for (p, q), pairs in gather_shards(mesh, local).items():
            if len(pairs):
                yield p, q, pairs[:, 0].numpy(), pairs[:, 1].numpy()


def partitioned_pairs(mesh: Mesh, lk, ls, le, rk, rs, re, chunk_limit: int | None = None):
    """Exact materializing join over the (part, probe) mesh.

    Per-shard totals size the emission capacity, then every shard emits its
    pairs — in fixed-capacity chunks when ``chunk_limit`` caps the buffer
    (low-memory mode); the host maps shard-local probe slots back to
    global rows.  Returns (build_rows, probe_rows)."""
    with agree():
        _, meta, didx, dq, IDX = _partitioned_inputs(mesh, lk, ls, le, rk, rs, re)
        bounds = shard_bounds(mesh, meta, didx, dq)
    totals = shard_totals(mesh, bounds)
    out_b, out_p = [], []
    for p, q, b_valid, s_valid in emit_all_shards(mesh, meta, didx, bounds, totals, chunk_limit):
        out_b.append(b_valid)
        out_p.append(IDX[p, q][s_valid])
    if not out_b:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    return np.concatenate(out_b), np.concatenate(out_p)


def nearest_shards(mesh: Mesh, meta, didx, dq) -> np.ndarray:
    """Per-shard nearest picks [npart, nprobe, M] (first overlap, else the
    nearest by genomic distance, else -1): the reference's CoitreesNearest
    semantics (interval_join.rs:909-1020) with the engine's canonical
    tie-breaking.  Exact when each probe's full candidate set lives in its
    shard: true under hash partitioning (whole key per part), and under
    skew range splitting when the caller replicated the boundary fringe
    rows (parallel/skew.py:skew_partitioned_nearest)."""
    picks = {}
    with agree():
        for (p, q), (lb, ub) in shard_bounds(mesh, meta, didx, dq).items():
            ix = didx[p, q]
            picks[p, q] = ij.nearest_from_bounds(
                lb, ub, ix["levels"], ix["keys"], ix["starts"], ix["ends"], ix["pos"],
                *dq[p, q], level_offsets=meta["level_offsets"], level_pad=meta["layout"],
            )
    return fetch_global(mesh, picks)


def partitioned_nearest(mesh: Mesh, lk, ls, le, rk, rs, re) -> np.ndarray:
    """Global nearest build row per probe row (-1 = key absent) over the
    (part, probe) mesh."""
    with agree():
        _, meta, didx, dq, IDX = _partitioned_inputs(mesh, lk, ls, le, rk, rs, re)
    res = nearest_shards(mesh, meta, didx, dq)
    out = np.full(len(rk), -1, np.int64)
    slot_rows = IDX.reshape(-1)
    real = slot_rows >= 0
    out[slot_rows[real]] = res.reshape(-1)[real]
    return out


def partitioned_probe_counts(mesh: Mesh, lk, ls, le, rk, rs, re) -> np.ndarray:
    """Exact per-probe-row overlap counts over the mesh (int64 [m]):
    CountOverlaps / grouped-count semantics, exact for degenerate probes
    and inverted builds (the level bounds, not BITS)."""
    with agree():
        _, meta, didx, dq, IDX = _partitioned_inputs(mesh, lk, ls, le, rk, rs, re)
        counts = {k: ij.counts_from_bounds(lb, ub)
                  for k, (lb, ub) in shard_bounds(mesh, meta, didx, dq).items()}
    res = fetch_global(mesh, counts).astype(np.int64)
    out = np.zeros(len(rk), np.int64)
    slot_rows = IDX.reshape(-1)
    real = slot_rows >= 0
    out[slot_rows[real]] = res.reshape(-1)[real]
    return out


def coverage_rank_shards(mesh: Mesh, meta, didx, dq):
    """Per-shard level-rank matrices for coverage (lb, ub, t, r), each
    [npart, nprobe, L, M] int32 on the host: the devices rank, the host
    finishes with int64 prefix-sum arithmetic (ops/genomic.coverage_finish)."""
    kw = dict(num_levels=meta["num_levels"], level_offsets=meta["level_offsets"])
    if mesh_bounds_strategy(mesh) == "bsearch":
        def rank(*a, side):
            return ij.level_ranks_bsearch(*a, side=side, level_pad=meta["layout"], **kw)
    else:
        def rank(*a, side):
            return ij.level_ranks(*a, side=side, **kw)
    out = ({}, {}, {}, {})
    with agree():
        for p, q, _ in _shards(mesh):
            ix = didx[p, q]
            lv, ky, st, en = (ix[n] for n in ("levels", "keys", "starts", "ends"))
            k, s, e = dq[p, q]
            for o, r in zip(out, (rank(lv, ky, en, k, s, side="left"),
                                  rank(lv, ky, st, k, e, side="right"),
                                  rank(lv, ky, en, k, e, side="right"),
                                  rank(lv, ky, st, k, s, side="left"))):
                o[p, q] = r
    return tuple(fetch_global(mesh, o) for o in out)


def partitioned_coverage(mesh: Mesh, lk, ls, le, rk, rs, re):
    """Per-probe (count, covered_bases) on the mesh — superintervals
    coverage semantics (superintervals.rs:802-822), exact for every query
    shape.  Returns int64 arrays ([m], [m])."""
    npart, nprobe = mesh.shape["part"], mesh.shape["probe"]
    arrays, meta = build_partitioned_index(lk, ls, le, npart)
    K, S, E, IDX = partition_probe(rk, rs, re, npart, nprobe)
    with agree():
        placed = place_index(mesh, arrays), place_probe(mesh, K, S, E)
    LB, UB, T, R = coverage_rank_shards(mesh, meta, *placed)
    out_c = np.zeros(len(rk), np.int64)
    out_b = np.zeros(len(rk), np.int64)
    for part in range(npart):
        # per-part prefix sums over the padded level arrays (padding rows
        # are zeroed; rank windows never cover them anyway)
        real = arrays["pos"][part] >= 0
        ps = np.concatenate([[0], np.cumsum(np.where(real, arrays["starts"][part], 0).astype(np.int64))])
        pe = np.concatenate([[0], np.cumsum(np.where(real, arrays["ends"][part], 0).astype(np.int64))])
        for chip in range(nprobe):
            rows = IDX[part, chip]
            keep = rows >= 0
            if not keep.any():
                continue
            counts, total = coverage_finish(
                LB[part, chip], UB[part, chip], T[part, chip], R[part, chip],
                meta["level_offsets"], ps, pe,
                S[part, chip].astype(np.int64), E[part, chip].astype(np.int64),
            )
            out_c[rows[keep]] = counts[keep]
            out_b[rows[keep]] = total[keep]
    return out_c, out_b


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


def partitioned_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    """Exact pair count over the (part, probe) mesh: per-shard level counts
    summed in int64 (the psum)."""
    with agree():
        _, meta, didx, dq, _ = _partitioned_inputs(mesh, lk, ls, le, rk, rs, re)
        sums = [ij.counts_from_bounds(lb, ub).sum(dtype=torch.int64)
                for lb, ub in shard_bounds(mesh, meta, didx, dq).values()]
    return psum(sums)


def collect_left_count(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    """CollectLeft over the mesh: one level index of the whole build,
    replicated on every shard's device, the probe rows split over every
    shard of the mesh, per-shard level counts psum'd in int64."""
    arrays, meta = build_partitioned_index(lk, ls, le, 1)
    K, S, E, _ = partition_probe(rk, rs, re, 1, mesh.size)
    grid = mesh.devices.shape + (-1,)
    with agree():
        didx = place_index(mesh, arrays)
        dq = place_probe(mesh, *(a.reshape(grid) for a in (K, S, E)))
        sums = [ij.counts_from_bounds(lb, ub).sum(dtype=torch.int64)
                for lb, ub in shard_bounds(mesh, meta, didx, dq).values()]
    return psum(sums)

