"""Skew-aware partition planning: range-splitting of hot contigs (port of
sequila_tpu/parallel/skew.py).

Hash partitioning by contig collapses when one chromosome dominates (chr1
is ~8% of the genome; a whole-genome join then bottlenecks on one
device).  The fix is the classic range sub-split, done exactly:

- a hot key's coordinate space is cut at probe-start quantiles into
  sub-ranges, each its own shard;
- build intervals are REPLICATED into every sub-range they overlap;
  probe intervals likewise;
- each (build, probe) pair is counted only in the sub-range containing
  ``max(build.start, probe.start)`` — the leftmost point of their
  intersection — so replicas never double-count.

Inside a sub-range [lo, hi) that rule reduces to rank arithmetic:

    native probes (qs in [lo,hi)):   #(bs <= qe') - #(be < qs)
    visitor probes (qs < lo):        #(bs <= qe') - #(bs < lo)

with qe' = min(qe, hi-1).  One extra rank column versus plain BITS.

The planning and replica assignment are host numpy, copied from the JAX
package, and every process runs them on the global tables; the counts,
pairs and nearest picks are shard programs over the mesh, each process
running its own shards (parallel/partitioned_join.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sequila_tpu_torch.ops.interval_index import _bucket
from sequila_tpu_torch.ops.ranks import rank_lex_sort
from sequila_tpu_torch.parallel import partitioned_join as pj
from sequila_tpu_torch.parallel.distributed import agree
from sequila_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class PartitionPlan:
    """Assignment of (key, sub-range) shards to parts.

    shard_of_key: key -> shard id for unsplit keys
    splits: key -> (boundaries array [k+1], shard ids [k]) for hot keys
    num_shards: total shards (>= npart; shards are then LPT-packed onto
    parts by weight)
    shard_part: shard id -> part id
    """

    shard_of_key: dict
    splits: dict
    num_shards: int
    shard_part: np.ndarray


def plan_partitions(lk, rk, rs, npart: int, split_threshold: float = 1.5) -> PartitionPlan:
    """Greedy LPT packing of per-key weights; keys heavier than
    ``split_threshold * (total/npart)`` are range-split into roughly
    equal-probe sub-ranges."""
    num_keys = int(max(lk.max() if len(lk) else 0, rk.max() if len(rk) else 0)) + 1
    wb = np.bincount(lk, minlength=num_keys).astype(np.int64)
    wp = np.bincount(rk, minlength=num_keys).astype(np.int64)
    weights = wb + wp
    total = int(weights.sum())
    cap = max(1.0, split_threshold * total / max(npart, 1))

    shard_of_key: dict = {}
    splits: dict = {}
    shard_weights: list = []
    for key in np.argsort(weights)[::-1]:
        w = int(weights[key])
        if w == 0:
            continue
        if w > cap and wp[key] > npart:
            # range-split at probe-start quantiles
            nsub = min(npart, max(2, int(np.ceil(w / cap))))
            starts = np.sort(rs[rk == key])
            qs_bounds = starts[
                np.linspace(0, len(starts) - 1, nsub + 1).astype(np.int64)
            ].astype(np.int64)
            # duplicate quantiles (many reads sharing a start) collapse
            inner = np.unique(qs_bounds[1:-1])
            inner = inner[(inner > -(2**31)) & (inner < 2**31)]
            bounds = np.concatenate([[-(2**31)], inner, [2**31]])
            nsub = len(bounds) - 1
            if nsub < 2:
                # cannot split (e.g. all probes share one start): keep
                # the key whole on a single shard
                shard_of_key[int(key)] = len(shard_weights)
                shard_weights.append(w)
                continue
            ids = []
            for _ in range(nsub):
                ids.append(len(shard_weights))
                shard_weights.append(w / nsub)
            splits[int(key)] = (bounds, np.asarray(ids))
        else:
            shard_of_key[int(key)] = len(shard_weights)
            shard_weights.append(w)

    num_shards = len(shard_weights)
    # LPT: heaviest shard to lightest part
    part_load = np.zeros(npart, np.float64)
    shard_part = np.zeros(num_shards, np.int64)
    for sid in np.argsort(np.asarray(shard_weights))[::-1]:
        p = int(np.argmin(part_load))
        shard_part[sid] = p
        part_load[p] += shard_weights[sid]
    return PartitionPlan(shard_of_key, splits, num_shards, shard_part)


def assign_build(plan: PartitionPlan, lk, ls, le):
    """Replicate build rows into their shards.  Returns (shard_ids, rows)."""
    out_shard, out_row = [], []
    for key, sid in plan.shard_of_key.items():
        rows = np.nonzero(lk == key)[0]
        out_shard.append(np.full(len(rows), sid))
        out_row.append(rows)
    for key, (bounds, ids) in plan.splits.items():
        rows = np.nonzero(lk == key)[0]
        s = ls[rows].astype(np.int64)
        e = le[rows].astype(np.int64)
        for i, sid in enumerate(ids):
            lo, hi = bounds[i], bounds[i + 1]
            mask = (s < hi) & (e >= lo)
            out_shard.append(np.full(int(mask.sum()), sid))
            out_row.append(rows[mask])
    if not out_shard:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_shard), np.concatenate(out_row)


def assign_probe(plan: PartitionPlan, rk, rs, re):
    """Replicate probe rows into their shards.

    Returns (shard_ids, rows, lo, hi): per replica the sub-range window
    ([-2^31, 2^31) for unsplit keys, so every probe is 'native')."""
    out = {k: [] for k in ("sid", "row", "lo", "hi")}
    for key, sid in plan.shard_of_key.items():
        rows = np.nonzero(rk == key)[0]
        out["sid"].append(np.full(len(rows), sid))
        out["row"].append(rows)
        out["lo"].append(np.full(len(rows), -(2**31), np.int64))
        out["hi"].append(np.full(len(rows), 2**31, np.int64))
    for key, (bounds, ids) in plan.splits.items():
        rows = np.nonzero(rk == key)[0]
        s = rs[rows].astype(np.int64)
        e = re[rows].astype(np.int64)
        for i, sid in enumerate(ids):
            lo, hi = bounds[i], bounds[i + 1]
            mask = (s < hi) & (e >= lo)
            sel = rows[mask]
            out["sid"].append(np.full(len(sel), sid))
            out["row"].append(sel)
            out["lo"].append(np.full(len(sel), lo, np.int64))
            out["hi"].append(np.full(len(sel), hi, np.int64))
    if not out["sid"]:
        z = np.empty(0, np.int64)
        return z, z, z, z
    return tuple(np.concatenate(out[k]) for k in ("sid", "row", "lo", "hi"))


def counts_skew(bk, bs, be, qk, qs, qe, q_lo, q_hi_incl):
    """Exact per-replica counts under the max(bs,qs)-ownership rule.

    bk here is the SHARD id (key identity is folded into the shard), and
    likewise qk.  q_lo / q_hi_incl are each replica's sub-range window as
    int32 with an INCLUSIVE upper bound (the full i32 range is then
    representable in int32, as in the JAX package)."""
    qe_c = torch.minimum(qe, q_hi_incl)
    native = qs >= q_lo
    ub = rank_lex_sort((bk, bs), (qk, qe_c), side="right")
    lb_nat = rank_lex_sort((bk, be), (qk, qs), side="left")
    lb_vis = rank_lex_sort((bk, bs), (qk, q_lo), side="left")
    counts = ub - torch.where(native, lb_nat, lb_vis)
    return torch.where(qs <= qe, torch.clamp(counts, min=0), 0)


def _replica_windows(q_lo, q_hi):
    """The replicas' windows as int32 (lo, inclusive hi)."""
    lim = (-(2**31), 2**31 - 1)
    return (np.clip(q_lo, *lim).astype(np.int32), np.clip(q_hi - 1, *lim).astype(np.int32))


def skew_partitioned_count_mesh(mesh: Mesh, lk, ls, le, rk, rs, re) -> int:
    """Skew-aware count over a (part, probe) mesh: shards packed onto parts
    by LPT weight, probe replicas row-split over 'probe', per-shard 3-rank
    counting, the shards' int64 totals summed."""
    npart, nprobe = mesh.shape["part"], mesh.shape["probe"]
    plan = plan_partitions(lk, rk, rs, npart)
    b_sid, b_row = assign_build(plan, lk, ls, le)
    q_sid, q_row, q_lo, q_hi = assign_probe(plan, rk, rs, re)
    if len(q_sid) == 0 or len(b_sid) == 0:
        return 0
    b_part = plan.shard_part[b_sid]
    q_part = plan.shard_part[q_sid]

    # per-part padded build arrays (PAD shard id sorts after real shards)
    PAD_SID = np.int32(2**31 - 1)
    bn = _bucket(max(int(np.bincount(b_part, minlength=npart).max()), 1), minimum=8)
    BK = np.full((npart, 1, bn), PAD_SID, np.int32)
    BS = np.full((npart, 1, bn), 2**31 - 1, np.int32)
    BE = np.full((npart, 1, bn), 2**31 - 1, np.int32)
    for p in range(npart):
        sel = np.nonzero(b_part == p)[0]
        BK[p, 0, : len(sel)] = b_sid[sel]
        BS[p, 0, : len(sel)] = ls[b_row[sel]]
        BE[p, 0, : len(sel)] = le[b_row[sel]]

    # per-(part, probe) padded probe arrays; padding is degenerate
    per = max(int(np.bincount(q_part, minlength=npart).max()), 1)
    per_chip = _bucket(max(1, -(-per // nprobe)), minimum=8)
    QK = np.full((npart, nprobe, per_chip), PAD_SID, np.int32)
    QS = np.full((npart, nprobe, per_chip), 2**31 - 1, np.int32)
    QE = np.full((npart, nprobe, per_chip), 2**31 - 3, np.int32)
    QLO = np.full((npart, nprobe, per_chip), -(2**31), np.int32)
    QHI = np.full((npart, nprobe, per_chip), 2**31 - 1, np.int32)  # inclusive
    lo32, hi32 = _replica_windows(q_lo, q_hi)
    for p in range(npart):
        sel = np.nonzero(q_part == p)[0]
        for c in range(nprobe):
            sl = sel[c * per_chip : (c + 1) * per_chip]
            QK[p, c, : len(sl)] = q_sid[sl]
            QS[p, c, : len(sl)] = rs[q_row[sl]]
            QE[p, c, : len(sl)] = re[q_row[sl]]
            QLO[p, c, : len(sl)] = lo32[sl]
            QHI[p, c, : len(sl)] = hi32[sl]

    with agree():
        # the build of part p on every local device of mesh row p
        builds = pj.place_probe(mesh, np.repeat(BK, nprobe, 1), np.repeat(BS, nprobe, 1),
                                np.repeat(BE, nprobe, 1))
        probes = pj.place_probe(mesh, QK, QS, QE, QLO, QHI)
        sums = [counts_skew(*builds[k], *probes[k]).sum(dtype=torch.int64) for k in probes]
    return pj.psum(sums)


def _replica_inputs(mesh: Mesh, plan, b_sid, b_row, ls, le, q_sid, q_rows, rs, re):
    """Replica build index and probe slots placed on the mesh, with the
    shard ids as keys and the plan's parts (build pos -> replica index)."""
    npart, nprobe = mesh.shape["part"], mesh.shape["probe"]
    b_sid32 = b_sid.astype(np.int32)
    q_sid32 = q_sid.astype(np.int32)
    arrays, meta = pj.build_partitioned_index(
        b_sid32, ls[b_row], le[b_row], npart, part_of=plan.shard_part[b_sid], keys=b_sid32,
    )
    K, S, E, IDX = pj.partition_probe(
        q_sid32, rs[q_rows], re[q_rows], npart, nprobe,
        part_of=plan.shard_part[q_sid], keys=q_sid32,
    )
    return meta, pj.place_index(mesh, arrays), pj.place_probe(mesh, K, S, E), IDX


def skew_partitioned_pairs(mesh: Mesh, lk, ls, le, rk, rs, re, chunk_limit=None):
    """Skew-aware exact MATERIALIZING join.

    Shards (range-split hot contigs) become the equi-keys of per-part
    level indexes; every shard emits its replica pairs, and the host keeps
    exactly the pairs owned by each replica's sub-range
    (``max(bs, qs) in [lo, hi)``) — so replicated build/probe rows never
    produce duplicates.  Returns global (build_rows, probe_rows)."""
    plan = plan_partitions(lk, rk, rs, mesh.shape["part"])
    b_sid, b_row = assign_build(plan, lk, ls, le)
    q_sid, q_row, q_lo, q_hi = assign_probe(plan, rk, rs, re)
    if len(b_sid) == 0 or len(q_sid) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    # the index's pos maps to REPLICA indices (rows into b_sid/b_row)
    with agree():
        meta, didx, dq, IDX = _replica_inputs(mesh, plan, b_sid, b_row, ls, le, q_sid, q_row,
                                              rs, re)
        bounds = pj.shard_bounds(mesh, meta, didx, dq)
    totals = pj.shard_totals(mesh, bounds)
    out_b, out_p = [], []
    for p, q, b_rep, p_slot in pj.emit_all_shards(mesh, meta, didx, bounds, totals, chunk_limit):
        q_rep = IDX[p, q][p_slot]
        # ownership: the pair belongs to the sub-range containing
        # max(build.start, probe.start)
        own_point = np.maximum(ls[b_row[b_rep]].astype(np.int64), rs[q_row[q_rep]].astype(np.int64))
        own = (own_point >= q_lo[q_rep]) & (own_point < q_hi[q_rep])
        out_b.append(b_row[b_rep[own]])
        out_p.append(q_row[q_rep[own]])
    if not out_b:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_b), np.concatenate(out_p)


def assign_build_nearest(plan: PartitionPlan, lk, ls, le):
    """Build replicas for NEAREST shards: the overlap replicas of
    ``assign_build`` plus, per sub-range [lo, hi), two canonical boundary
    fringe rows (reference nearest semantics: interval_join.rs:909-956):

    - upstream fringe: the lexicographic (end, start, row) MAXIMUM among
      the key's builds with end < lo — the canonical upstream pick for
      any in-shard probe whose true upstream neighbor lies below lo;
    - downstream fringe: the (start, end, row) MINIMUM among builds with
      start >= hi — the canonical downstream pick past the cut.

    With the engine's canonical (structure-independent) tie-breaking,
    these two rows are exactly sufficient (see skew_partitioned_nearest).
    Fringe rows can never tie with in-shard replicas (their end < lo /
    start >= hi separate them).  Returns (shard_ids, rows)."""
    out_shard, out_row = [], []
    for key, sid in plan.shard_of_key.items():
        rows = np.nonzero(lk == key)[0]
        out_shard.append(np.full(len(rows), sid))
        out_row.append(rows)
    for key, (bounds, ids) in plan.splits.items():
        rows = np.nonzero(lk == key)[0]
        s = ls[rows].astype(np.int64)
        e = le[rows].astype(np.int64)
        # ascending (end, start, row): last entry with end < lo is the
        # canonical upstream fringe
        ord_e = np.lexsort((rows, s, e))
        e_sorted = e[ord_e]
        # ascending (start, end, row): first entry with start >= hi is
        # the canonical downstream fringe
        ord_s = np.lexsort((rows, e, s))
        s_sorted = s[ord_s]
        for i, sid in enumerate(ids):
            lo, hi = bounds[i], bounds[i + 1]
            mask = (s < hi) & (e >= lo)
            rep = [rows[mask]]
            j = np.searchsorted(e_sorted, lo, side="left") - 1
            if j >= 0:
                rep.append(rows[ord_e[j : j + 1]])
            j2 = np.searchsorted(s_sorted, hi, side="left")
            if j2 < len(ord_s):
                rep.append(rows[ord_s[j2 : j2 + 1]])
            rep = np.concatenate(rep)
            out_shard.append(np.full(len(rep), sid))
            out_row.append(rep)
    if not out_shard:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_shard), np.concatenate(out_row)


def assign_probe_nearest(plan: PartitionPlan, rk, rs, re):
    """Assign each probe row to exactly ONE shard (nearest answers once).

    A probe of a split key goes to the sub-range CONTAINING its whole
    window ([min(qs,qe), max(qs,qe)]); probes that straddle a cut
    boundary are returned separately (``crossing``) — the caller answers
    those against a whole-key host index, since a sub-range shard cannot
    see both sides' candidates at once.  Returns (shard_ids, rows,
    crossing_rows)."""
    out_sid, out_row, crossing = [], [], []
    for key, sid in plan.shard_of_key.items():
        rows = np.nonzero(rk == key)[0]
        out_sid.append(np.full(len(rows), sid))
        out_row.append(rows)
    for key, (bounds, ids) in plan.splits.items():
        rows = np.nonzero(rk == key)[0]
        mn = np.minimum(rs[rows], re[rows]).astype(np.int64)
        mx = np.maximum(rs[rows], re[rows]).astype(np.int64)
        i = np.searchsorted(bounds, mn, side="right") - 1
        i = np.clip(i, 0, len(ids) - 1)
        contained = (mn >= bounds[i]) & (mx < bounds[i + 1])
        out_sid.append(np.asarray(ids)[i[contained]])
        out_row.append(rows[contained])
        crossing.append(rows[~contained])
    z = np.empty(0, np.int64)
    return (
        np.concatenate(out_sid) if out_sid else z,
        np.concatenate(out_row) if out_row else z,
        np.concatenate(crossing) if crossing else z,
    )


def skew_partitioned_nearest(mesh: Mesh, lk, ls, le, rk, rs, re) -> np.ndarray:
    """Skew-aware NEAREST over the (part, probe) mesh.

    Hot contigs are range-split exactly as for counts; correctness rests
    on the engine's canonical tie-breaking (ops/interval_join.
    nearest_from_bounds):

    - overlap pick = lexmin (start, end, row): every build overlapping a
      contained probe also overlaps the probe's sub-range [lo, hi), so all
      overlap candidates are replicated into the shard;
    - upstream pick = lexmax (end, start, row): a candidate with end in
      [lo, qs) is in the shard; when the global maximum has end < lo it
      IS the upstream fringe row (assign_build_nearest);
    - downstream pick = lexmin (start, end, row): symmetric via the
      downstream fringe (start >= hi).

    Probes straddling a cut are answered on the host against a whole-key
    index (ops/host_join), as in the JAX package — bit-for-bit identical
    by the host/device parity invariant.  Returns the global build row per
    probe row (-1 = no candidate)."""
    from sequila_tpu_torch.ops.host_join import make_host_index

    plan = plan_partitions(lk, rk, rs, mesh.shape["part"])
    b_sid, b_row = assign_build_nearest(plan, lk, ls, le)
    q_sid, q_row, crossing = assign_probe_nearest(plan, rk, rs, re)
    out = np.full(len(rk), -1, np.int64)

    if len(q_sid) and len(b_sid):
        with agree():
            meta, didx, dq, IDX = _replica_inputs(mesh, plan, b_sid, b_row, ls, le, q_sid,
                                                  q_row, rs, re)
        # picks are REPLICA indices (the index's pos maps into the replica
        # row space) -> original rows via b_row
        res = pj.nearest_shards(mesh, meta, didx, dq)
        slot_rows = IDX.reshape(-1)
        real = slot_rows >= 0
        picks = res.reshape(-1).astype(np.int64)[real]
        out[q_row[slot_rows[real]]] = np.where(picks >= 0, b_row[np.clip(picks, 0, None)], -1)

    if len(crossing):
        hot = np.asarray(sorted(plan.splits.keys()))
        hrows = np.nonzero(np.isin(lk, hot))[0]
        if len(hrows):
            hidx = make_host_index(lk[hrows], ls[hrows], le[hrows])
            res2 = np.asarray(hidx.nearest(rk[crossing], rs[crossing], re[crossing])).astype(np.int64)
            out[crossing] = np.where(res2 >= 0, hrows[np.clip(res2, 0, None)], -1)
    return out
