"""The merge path over (key, value) pairs (csrc/pair_merge.cu::
pair_merge_kernel) behind B2 and B3, and its host side
(ops/cuda/pair_merge.py, the two-segment stream count).

On the CPU: the descriptor layout and constants against the CUDA source;
the block plan covers every merge diagonal of every segment once; a numpy
emulation of the kernel's algorithm over int64 pair composites (block
splits, thread splits, sequential merge, window clamp) gives
np.searchsorted's ranks under both tie rules, and the TPU kernel's ranks
(the JAX package's in interpret mode) with exact and too-narrow windows;
the two-segment stream plan equals stream_count_partials pass by pass.
The ``cuda`` test holds one launch of every edge segment against the
plain version on the card.  Ranks and sums are integers: every
comparison is exact.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.ops.pallas import stream_rank as jsr
from sequila_tpu_torch.ops.cuda import pair_merge as pm
from sequila_tpu_torch.ops.cuda import stream_rank as tsr
from sequila_tpu_torch.ops.ranks import composite
from sequila_tpu_torch.utils import metrics

CPU = torch.device("cpu")
CU = os.path.join(os.path.dirname(pm.__file__), "..", "..", "csrc", "pair_merge.cu")
PAD = 2**31 - 1


def _t(a, device=CPU) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pair(k, v) -> np.ndarray:
    """The kernel's composite: key << 32 | (value ^ 2^31), as int64."""
    hi = k.astype(np.int64).astype(np.uint64) << np.uint64(32)
    lo = (v.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)) ^ np.uint64(2**31)
    return (hi | lo).view(np.int64)


def sorted_pairs(rng, n, nkeys=4, run=0, pad=0, pad_value=PAD):
    """n sorted (key, value) pairs: few keys with many equal keys of other
    values, a run of ``run`` equal pairs, then ``pad`` (PAD, pad_value)
    rows."""
    real = n - pad
    k = rng.integers(-2, nkeys, real).astype(np.int32)
    v = rng.integers(-60, 60, real).astype(np.int32)
    v[::7] = rng.integers(-(2**31), 2**31 - 1, len(v[::7]), dtype=np.int64)
    if run and real:
        k[:run], v[:run] = 1, 7
    o = np.lexsort((v, k))
    return (np.concatenate([k[o], np.full(pad, PAD, np.int32)]),
            np.concatenate([v[o], np.full(pad, pad_value, np.int32)]))


# ---------------------------------------------------------------------------
# numpy emulation of the kernel's algorithm (used only by these tests)
# ---------------------------------------------------------------------------


def before(a, q, strict):
    return a < q if strict else a <= q


def diagonal_split(a, q, d, strict):
    """Table rows among the first d merged elements: a thread's binary
    search in shared memory."""
    lo, hi = max(0, d - len(q)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if before(a[mid], q[d - 1 - mid], strict):
            lo = mid + 1
        else:
            hi = mid
    return lo


def block_split(a, q, d, strict, ways=32):
    """The same split as a warp finds it in global memory, ``ways``
    samples a round (csrc/pair_merge.cu::warp_split)."""
    lo, hi = max(0, d - len(q)), min(d, len(a))
    while lo < hi:
        step = -(-(hi - lo) // ways)
        pos = [lo + t * step for t in range(ways)]
        c = sum(p < hi and before(a[p], q[d - 1 - p], strict) for p in pos)
        assert all(p < hi and before(a[p], q[d - 1 - p], strict) for p in pos[:c])
        lo, hi = (lo + (c - 1) * step + 1 if c else lo), min(lo + c * step, hi)
    return lo


def clamp(r, jg, n, c_lo, n_chunks):
    """csrc/pair_merge.cu::Window::clamp"""
    c0, c = int(c_lo[jg // pm.BLOCK]), int(n_chunks[jg // pm.BLOCK])
    w0 = c0 * pm.CHUNK
    w1 = max(min((c0 + max(c, 0)) * pm.CHUNK, n), w0)
    return min(max(r, w0), w1)


def merge_path_ranks(a, q, strict, tile=pm.TILE, items=pm.ITEMS, ways=32, windows=None):
    """The kernel's ranks over composites: per tile the two global splits,
    per thread its split in the tile, then ``items`` sequential merge
    steps, each emitted rank clamped to its window when given.  Asserts
    that each query is emitted exactly once."""
    a, q = a.tolist(), q.tolist()
    n, m = len(a), len(q)
    ranks = [None] * m
    for d0 in range(0, (n + m) if m else 0, tile):
        d1 = min(d0 + tile, n + m)
        i0, i1 = block_split(a, q, d0, strict, ways), block_split(a, q, d1, strict, ways)
        j0 = d0 - i0
        sa, sq = a[i0:i1], q[j0:d1 - i1]
        for dl in range(0, d1 - d0, items):
            i = diagonal_split(sa, sq, dl, strict)
            j = dl - i
            for _ in range(min(items, d1 - d0 - dl)):
                if j >= len(sq) or (i < len(sa) and before(sa[i], sq[j], strict)):
                    i += 1
                else:
                    assert ranks[j0 + j] is None, "a query emitted twice"
                    r = i0 + i
                    ranks[j0 + j] = r if windows is None else clamp(r, j0 + j, n, *windows)
                    j += 1
    assert None not in ranks, "a query never emitted"
    return np.asarray(ranks, np.int64)


def merged_splits(a, q, strict):
    """Table rows among the first d merged elements for every d, from a
    stable sort with the tie rule."""
    val = np.concatenate([a, q])
    is_a = np.concatenate([np.ones(len(a), bool), np.zeros(len(q), bool)])
    tie = is_a if strict else ~is_a
    order = np.lexsort((tie, val))
    return np.concatenate([[0], np.cumsum(is_a[order])])


# ---------------------------------------------------------------------------
# (a) the layout the kernel reads
# ---------------------------------------------------------------------------


def test_constants_and_descriptor_match_the_kernel():
    src = open(CU).read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["kThreads"], consts["kItems"], consts["kTiles"]) == (pm.THREADS, pm.ITEMS, pm.TILES)
    assert pm.TILES < pm.THREADS // 32  # a warp for each of the TILES + 1 boundaries
    assert (consts["kBases"], consts["kInline"]) == (pm.N_SLOTS, pm.N_INLINE)
    assert (consts["kBlock"], consts["kChunk"]) == (pm.BLOCK, pm.CHUNK) == (tsr.BLOCK, tsr.CHUNK)
    assert f"sizeof(Segment) == {len(pm.FIELDS)} * sizeof(int64_t)" in src
    body = re.search(r"struct Segment \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\b(\w+)\s*[,;]", re.sub(r"//[^\n]*", "", body))
    assert tuple(names) == pm.FIELDS


def test_descriptor_rows_of_a_plan():
    """The rows a plan for the card uploads, read back by field name: the
    two stream passes, then a segment without windows or a sum."""
    segs = tsr.count_segments(4096, 700, 2048, 700) + (
        pm.PairSegment(5, 9, a_k=(13, 2), a_v=(14, 3), q_k=(15, 0), q_v=(15, 9), strict=True,
                       out=(2, 40)),)
    block0 = pm.plan_pair_segments(segs, CPU).block0
    rows = [dict(zip(pm.FIELDS, r.tolist())) for r in pm.descriptors(segs, block0)]
    u, lo, extra = rows
    assert (u["lo_slot"], u["nch_slot"], u["total_slot"], u["total_off"], u["out_slot"]) == \
        (4, 5, 12, 0, -1)
    assert (u["n"], u["m"], u["strict"], u["block0"]) == (4096, 700, 0, 0)
    assert (lo["ak_slot"], lo["av_slot"], lo["qv_slot"], lo["total_off"], lo["strict"]) == \
        (6, 7, 9, 1, 1)
    assert lo["block0"] == pm.segment_blocks(4096, 700)
    assert (extra["lo_slot"], extra["nch_slot"], extra["total_slot"]) == (-1, -1, -1)
    assert (extra["out_slot"], extra["out_off"], extra["ak_off"], extra["qv_off"]) == (2, 40, 2, 9)


def block_map(plan):
    b = np.arange(plan.block0[-1])
    s = np.searchsorted(plan.block0[:-1], b, side="right") - 1
    out = []
    for bi, si in zip(b.tolist(), s.tolist()):
        seg = plan.segs[si]
        d0 = (bi - int(plan.block0[si])) * pm.SPAN
        out.append((si, d0, min(d0 + pm.SPAN, seg.n + seg.m)))
    return out


@pytest.mark.parametrize("sizes", [
    [(0, 0)], [(0, 5)], [(5, 0)], [(1, 1)], [(pm.SPAN, 0), (0, pm.SPAN), (7, 301_056)],
    [(3, 2), (0, 0), (pm.SPAN - 1, 1), (10**6, 17), (17, 10**6), (0, 9)],
])
def test_block_plan_covers_every_diagonal_once(sizes):
    segs = [pm.PairSegment(n, m, a_k=(0, 0), a_v=(1, 0), q_k=(2, 0), q_v=(3, 0), strict=False)
            for n, m in sizes]
    plan = pm.plan_pair_segments(segs, CPU)
    seen = [np.zeros(s.n + s.m, np.int64) for s in plan.segs]
    for si, d0, d1 in block_map(plan):
        assert d0 < d1
        seen[si][d0:d1] += 1
    for s, cov in zip(plan.segs, seen):
        np.testing.assert_array_equal(cov, 1 if s.m else 0)


# ---------------------------------------------------------------------------
# (b) the merge path over pairs, emulated
# ---------------------------------------------------------------------------


def test_kernel_composite_orders_like_the_pair():
    rng = np.random.default_rng(5)
    k = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    v = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    k[:4], v[:4] = [-(2**31), -(2**31), PAD, PAD], [-(2**31), PAD, PAD - 1, PAD]
    np.testing.assert_array_equal(pair(k, v), composite(_t(k), _t(v)).numpy())
    order = np.lexsort((v, k))
    assert (np.diff(pair(k, v)[order]) >= 0).all()


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("n,m", [(700, 500), (50, 1200), (1300, 3), (0, 40), (40, 0)])
def test_split_at_every_diagonal(rng, strict, n, m):
    """Equal keys with other values, a shared run of equal pairs, PAD rows
    on both sides (build (PAD, PAD), probe (PAD, PAD - 1))."""
    a = pair(*sorted_pairs(rng, n, run=n // 3, pad=min(n, 5)))
    q = pair(*sorted_pairs(rng, m, run=m // 2, pad=min(m, 4), pad_value=PAD - 1))
    want = merged_splits(a, q, strict)
    a, q = a.tolist(), q.tolist()
    np.testing.assert_array_equal([diagonal_split(a, q, d, strict) for d in range(n + m + 1)],
                                  want)
    for ways in (2, 3, 32):
        got = [block_split(a, q, d, strict, ways) for d in range(n + m + 1)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("n,m,tile,run", [
    (6000, 3000, pm.TILE, 3 * pm.TILE), (2500, 7000, pm.TILE, 0), (1, 700, 64, 0),
    (900, 1, 64, 0), (0, 300, 64, 0), (300, 0, 64, 0), (400, 400, 16, 100),
])
def test_emulated_kernel_equals_searchsorted(rng, strict, n, m, tile, run):
    """Runs of equal pairs longer than a tile on both sides."""
    a = pair(*sorted_pairs(rng, n, run=run, pad=min(n, 3)))
    q = pair(*sorted_pairs(rng, m, run=run // 2, pad=min(m, 3), pad_value=PAD - 1))
    want = np.searchsorted(a, q, side="left" if strict else "right")
    got = merge_path_ranks(a, q, strict, tile=tile, items=min(pm.ITEMS, tile),
                           ways=min(32, tile // 8))
    np.testing.assert_array_equal(got, want)


def _jax_stream(ak, av, c_lo, n_ch, qk, qv, strict):
    """The TPU kernel in interpret mode (queries padded to its block)."""
    m = len(qk)
    m_pad = -(-m // pm.BLOCK) * pm.BLOCK
    pk = np.concatenate([qk, np.full(m_pad - m, PAD, np.int32)])
    pv = np.concatenate([qv, np.full(m_pad - m, PAD - 1, np.int32)])
    return np.asarray(jsr._stream_rank_sorted(
        jnp.stack([jnp.asarray(ak), jnp.asarray(av)]), jnp.asarray(c_lo), jnp.asarray(n_ch),
        jnp.asarray(pk), jnp.asarray(pv), strict=strict,
    ))[:m]


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("windows", ["exact", "narrow"])
def test_window_clamp_matches_jax_kernel(rng, strict, windows):
    """The emulated kernel and the plain version, clamped to host_windows'
    exact windows or to too-narrow ones, equal the TPU kernel's
    ``c_lo * CHUNK + #{window rows before q}``."""
    n, m = 3 * pm.CHUNK, 700
    ak, av = sorted_pairs(rng, n, nkeys=3, run=pm.CHUNK + 300, pad=100)
    qk, qv = sorted_pairs(rng, m, nkeys=3, run=60, pad=9, pad_value=PAD - 1)
    blocks = -(-m // pm.BLOCK)
    if windows == "exact":
        m_pad = blocks * pm.BLOCK
        c_lo, n_ch = tsr.host_windows(
            ak, av, np.concatenate([qk, np.full(m_pad - m, PAD, np.int32)]),
            np.concatenate([qv, np.full(m_pad - m, PAD - 1, np.int32)]))
    else:
        # inside the build, as the TPU kernel needs: [1, 2), [0, 0), [2, 3)
        c_lo = np.array([1, 0, 2], np.int32)[:blocks]
        n_ch = np.array([1, 0, 1], np.int32)[:blocks]
    want = _jax_stream(ak, av, c_lo, n_ch, qk, qv, strict)
    got = merge_path_ranks(pair(ak, av), pair(qk, qv), strict, tile=512,
                           windows=(c_lo, n_ch))
    np.testing.assert_array_equal(got, want)
    plain = pm.pair_rank_plain(_t(ak), _t(av), _t(qk), _t(qv), strict=strict,
                               c_lo=_t(c_lo), n_chunks=_t(n_ch))
    np.testing.assert_array_equal(plain.numpy(), want)
    if windows == "exact":  # exact windows change nothing
        np.testing.assert_array_equal(
            want, np.searchsorted(pair(ak, av), pair(qk, qv), side="left" if strict else "right"))


# ---------------------------------------------------------------------------
# (c) plans, the plain launch and the two-segment stream count
# ---------------------------------------------------------------------------


def mixed_segments(rng, device=CPU):
    """(segments, slots): every edge case of one launch.  Slots: 0 table
    keys, 1 table values, 2 query keys, 3 query values, 4 ranks, 5 sums,
    6 c_lo, 7 n_chunks."""
    cases = [  # (n, m, windows: None, "exact" or "narrow")
        (0, 300, None), (500, 0, None), (1, 257, None), (20_000, 37, None),
        (37, 20_000, "exact"), (6 * pm.TILE, 3 * pm.TILE, None), (3 * pm.CHUNK, 3000, "narrow"),
        (0, 5, "exact"), (pm.CHUNK, 700, "exact"),
    ]
    cols = [[], [], [], [], [], []]
    segs, off = [], [0, 0, 0]  # table, queries, windows
    for i, (n, m, win) in enumerate(cases):
        ak, av = sorted_pairs(rng, n, run=min(n, 3 * pm.TILE) if i == 5 else 0, pad=min(n, 2))
        qk, qv = sorted_pairs(rng, m, pad=min(m, 2), pad_value=PAD - 1)
        kw = dict(out=(4, off[1])) if i % 2 else dict(total=(5, i))
        blocks = -(-m // pm.BLOCK)
        if win is not None:
            if win == "exact":
                c_lo = (np.searchsorted(pair(ak, av), pair(qk, qv)[::pm.BLOCK]) // pm.CHUNK)
                c_hi = -(-np.searchsorted(pair(ak, av), pair(qk, qv)[pm.BLOCK - 1::pm.BLOCK],
                                          side="right") // pm.CHUNK)
                c_hi = np.concatenate([c_hi, [n // pm.CHUNK + 1]])[:blocks]
                n_ch = np.maximum(c_hi - c_lo, 0)
            else:
                c_lo = rng.integers(0, max(n // pm.CHUNK, 1), blocks)
                n_ch = rng.integers(-1, 2, blocks)
            cols[4].append(c_lo.astype(np.int32))
            cols[5].append(n_ch.astype(np.int32))
            kw.update(c_lo=(6, off[2]), n_chunks=(7, off[2]))
            off[2] += blocks
        segs.append(pm.PairSegment(n, m, a_k=(0, off[0]), a_v=(1, off[0]), q_k=(2, off[1]),
                                   q_v=(3, off[1]), strict=bool(i % 3 == 1), **kw))
        for c, x in zip(cols, (ak, av, qk, qv)):
            c.append(x)
        off[0] += n
        off[1] += m
    cat = [_t(np.concatenate(c).astype(np.int32), device) for c in cols]
    slots = (*cat[:4], torch.full((off[1],), -1, dtype=torch.int32, device=device),
             torch.zeros(len(cases), dtype=torch.int64, device=device), *cat[4:])
    return segs, slots


def test_mixed_segments_plain_equals_the_emulated_kernel(rng):
    segs, slots = mixed_segments(rng)
    pm.pair_merge_segments(pm.plan_pair_segments(segs, CPU), slots)
    for i, s in enumerate(segs):
        a = pair(*(t[s.a_k[1]:s.a_k[1] + s.n].numpy() for t in slots[:2]))
        q = pair(*(t[s.q_k[1]:s.q_k[1] + s.m].numpy() for t in slots[2:4]))
        windows = None
        if s.c_lo is not None:
            blocks = -(-s.m // pm.BLOCK)
            windows = tuple(t[r[1]:r[1] + blocks].numpy() for t, r in
                            ((slots[6], s.c_lo), (slots[7], s.n_chunks)))
        want = merge_path_ranks(a, q, s.strict, windows=windows)
        if s.total is not None:
            assert int(slots[5][i]) == int(want.sum())
        else:
            np.testing.assert_array_equal(slots[4][s.out[1]:s.out[1] + s.m].numpy(), want)


def test_contract_rejects_bad_plans_and_slots():
    q = torch.zeros(4, dtype=torch.int32)
    seg = pm.PairSegment(4, 4, a_k=(0, 0), a_v=(1, 0), q_k=(2, 0), q_v=(3, 0), strict=True)
    with pytest.raises(ValueError):
        pm.plan_pair_segments([], CPU)
    with pytest.raises(ValueError, match="both c_lo and n_chunks"):
        pm.plan_pair_segments([seg._replace(c_lo=(4, 0))], CPU)
    with pytest.raises(ValueError, match="slot"):
        pm.plan_pair_segments([seg._replace(total=(2, 0))], CPU)  # int32 and int64
    plan = pm.plan_pair_segments([seg._replace(a_k=(0, 1))], CPU)
    with pytest.raises(ValueError):  # the table runs past its slot
        pm.pair_merge_segments(plan, (q,) * 4)
    with pytest.raises(TypeError):
        pm.pair_merge_segments(plan, (q.long(), q, q, q))
    with pytest.raises(ValueError):
        pm.pair_merge_segments(plan, (q,) * (pm.N_SLOTS + 1))


def test_cpu_launches_no_kernel(rng):
    segs, slots = mixed_segments(rng)
    with metrics.recording() as rec:
        pm.pair_merge_segments(pm.plan_pair_segments(segs, CPU), slots)
    assert rec.counts()["launch.pair_merge"] == 0


def _stream_plan(rng, deltas):
    import pyarrow as pa

    from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec
    from sequila_tpu_torch.exec.plan import ScanExec
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.planner.expr import BinaryExpr, Column, Literal
    from sequila_tpu_torch.planner.intervals import ColInterval, ColIntervals

    def table(k, nkeys):
        s = rng.integers(0, 8000, k).astype(np.int64)
        return Table(pa.table({"contig": [f"c{int(x)}" for x in rng.integers(0, nkeys, k)],
                               "s": s, "e": s + rng.integers(2, 3000, k)}))

    def bound(idx, d):
        col = Column("x", idx)
        return col if d == 0 else BinaryExpr(col, "+" if d > 0 else "-", Literal(abs(d)))

    lt, rt = table(2500, 5), table(3100, 6)
    d_bs, d_be, d_qs, d_qe = deltas
    join = IntervalJoinExec(
        ScanExec("l", lt), ScanExec("r", rt),
        on=[(Column("contig", 0), Column("contig", 0))], filter_=None,
        intervals=ColIntervals(ColInterval(bound(1, d_bs), bound(2, d_be)),
                               ColInterval(bound(1, d_qs), bound(2, d_qe))),
        device="cpu",
    )
    return join._stream_count_plan(lt, rt, *join._sorted_count_inputs(lt, rt))


@pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1)])
def test_stream_count_plan_equals_jax_partials_pass_by_pass(rng, deltas):
    """The two segments of one launch: pass u non-strict and pass l strict,
    each with its own windows, each summed into its own int64, equal to
    the JAX package's ub and lb partial sums over the same arrays."""
    plan = _stream_plan(rng, deltas)
    kw = dict(zip(("d_bs", "d_be", "d_qs", "d_qe"), deltas))
    pass_u, pass_l = tsr.stream_pass_inputs(*plan, **kw)
    launch, totals = tsr.stream_count_launcher(pass_u, pass_l)
    segs = tsr._count_plan(pass_u[0].shape[1], pass_u[3].numel(), pass_l[0].shape[1],
                           pass_l[3].numel(), CPU).segs
    assert [s.strict for s in segs] == [False, True]
    assert [s.total for s in segs] == [(12, 0), (12, 1)]
    assert segs[0].c_lo != segs[1].c_lo and pass_u[0].shape[1] % pm.CHUNK == 0
    launch()
    partials = np.asarray(jsr.stream_count_partials(
        *(jnp.asarray(x.numpy()) for x in plan), **kw)).astype(np.int64)
    half = len(partials) // 2
    assert totals.tolist() == [int(partials[:half].sum()), -int(partials[half:].sum())]
    assert int(tsr.stream_count_passes(*plan, **kw)) == int(partials.sum())


# ---------------------------------------------------------------------------
# (d) the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mixed_segments_kernel_equals_plain(rng, cuda_device):
    """One launch (descriptors on the card) of every edge segment."""
    segs, slots = mixed_segments(rng, cuda_device)
    plain = tuple(t.cpu().clone() for t in slots)
    with metrics.recording() as rec:
        pm.pair_merge_segments(pm.plan_pair_segments(segs, cuda_device), slots)
    torch.cuda.synchronize()
    assert rec.counts()["launch.pair_merge"] == 1
    pm.pair_segments_plain(segs, plain)
    for got, want in zip(slots, plain):
        assert torch.equal(got.cpu(), want)
