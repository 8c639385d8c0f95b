"""The segmented merge-path B1 (csrc/merge_rank.cu::merge_path_kernel) and
its host side (ops/cuda/merge_count.py: plan_segments, merge_rank_segments).

On the CPU: the block plan covers every merge diagonal of every segment
once; a numpy emulation of the kernel's algorithm (block splits, thread
splits, sequential merge) gives torch.searchsorted's ranks under both tie
rules, so the rule the CUDA code implements is tested before it runs; and
merge_rank_segments_plain equals the JAX package's merge count and level
bounds.  The ``cuda`` tests hold the kernel against its plain version.
Ranks and sums are integers: every comparison is exact.
"""

import os
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.config import Algorithm as JaxAlgorithm
from sequila_tpu.config import SequilaConfig as JaxConfig
from sequila_tpu.exec.context import ExecContext as JaxCtx
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec as JaxJoin
from sequila_tpu.exec.plan import ScanExec as JaxScan
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu.planner import expr as jexpr
from sequila_tpu.planner import intervals as jiv
from sequila_tpu_torch.config import Algorithm as TorchAlgorithm
from sequila_tpu_torch.config import SequilaConfig as TorchConfig
from sequila_tpu_torch.exec.context import ExecContext as TorchCtx
from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec as TorchJoin
from sequila_tpu_torch.exec.plan import ScanExec as TorchScan
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from sequila_tpu_torch.planner import expr as texpr
from sequila_tpu_torch.planner import intervals as tiv
from sequila_tpu_torch.utils import metrics

CPU = torch.device("cpu")
CU = os.path.join(os.path.dirname(tmc.__file__), "..", "..", "csrc", "merge_rank.cu")
PKGS = {
    "jax": (jexpr, jiv, JaxJoin, JaxScan, JaxTable, JaxAlgorithm, lambda: JaxCtx(JaxConfig())),
    "torch": (texpr, tiv, TorchJoin, TorchScan, TorchTable, TorchAlgorithm,
              lambda: TorchCtx(TorchConfig())),
}


def bits(x: np.ndarray, device=CPU) -> torch.Tensor:
    """u32 values as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32).copy()).to(device)


def sorted_u32(rng, n, runs=True):
    """Sorted u32 with duplicate runs longer than a tile, both sentinels,
    0 and 2^32 - 1 (= BUILD_PAD)."""
    if n == 0:
        return np.empty(0, np.uint32)
    pool = rng.integers(0, 2**32, max(n // (3 * tmc.TILE) if runs else n, 4), dtype=np.uint64)
    pool = np.concatenate([pool, [0, tmc.PROBE_PAD, tmc.BUILD_PAD]])
    return np.sort(rng.choice(pool, n).astype(np.uint32))


# ---------------------------------------------------------------------------
# numpy emulation of the kernel's algorithm (used only by these tests)
# ---------------------------------------------------------------------------


def before(a, q, strict):
    """Does table element a precede query q in the merged order?"""
    return a < q if strict else a <= q


def diagonal_split(a, q, d, strict):
    """Table rows among the first d elements of the merge of a and q: the
    binary search each thread runs in shared memory."""
    lo, hi = max(0, d - len(q)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if before(a[mid], q[d - 1 - mid], strict):
            lo = mid + 1
        else:
            hi = mid
    return lo


def block_split(a, q, d, strict, ways=32):
    """The same split as a block finds it in global memory: ``ways``
    samples a round (a warp's lanes), the range cut to the step after the
    last that holds the rule (csrc/merge_rank.cu::warp_split)."""
    lo, hi = max(0, d - len(q)), min(d, len(a))
    while lo < hi:
        step = -(-(hi - lo) // ways)
        pos = [lo + t * step for t in range(ways)]
        c = sum(p < hi and before(a[p], q[d - 1 - p], strict) for p in pos)
        assert all(p < hi and before(a[p], q[d - 1 - p], strict) for p in pos[:c])
        lo, hi = (lo + (c - 1) * step + 1 if c else lo), min(lo + c * step, hi)
    return lo


def merge_path_ranks(a, q, strict, tile=tmc.TILE, items=tmc.ITEMS, ways=32):
    """The kernel's ranks: per tile the two global splits (which block
    holds the tile changes nothing), per thread its split in the tile, then
    ``items`` sequential merge steps.  Asserts that each query is emitted
    exactly once."""
    a, q = a.tolist(), q.tolist()
    n, m = len(a), len(q)
    ranks = [-1] * m
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
                    assert ranks[j0 + j] == -1, "a query emitted twice"
                    ranks[j0 + j] = i0 + i
                    j += 1
    assert -1 not in ranks, "a query never emitted"
    return np.asarray(ranks, np.int64)


def merged_splits(a, q, strict):
    """Table rows among the first d merged elements for every d, from a
    stable sort with the tie rule (an equal table element first when
    non-strict, last when strict)."""
    val = np.concatenate([a, q]).astype(np.int64)
    is_a = np.concatenate([np.ones(len(a), bool), np.zeros(len(q), bool)])
    tie = is_a if strict else ~is_a
    order = np.lexsort((tie, val))
    return np.concatenate([[0], np.cumsum(is_a[order])])


# ---------------------------------------------------------------------------
# (a) the host-side segment plan
# ---------------------------------------------------------------------------


def block_map(plan):
    """(segment, first diagonal, end diagonal) of every block, as the
    kernel maps blockIdx.x: the last segment whose block0 is <= b."""
    b = np.arange(plan.block0[-1])
    s = np.searchsorted(plan.block0[:-1], b, side="right") - 1
    out = []
    for bi, si in zip(b.tolist(), s.tolist()):
        seg = plan.segs[si]
        d0 = (bi - int(plan.block0[si])) * tmc.SPAN
        out.append((si, d0, min(d0 + tmc.SPAN, seg.n + seg.m)))
    return out


def assert_covers(plan):
    """Every diagonal of every segment with queries lies in exactly one
    block; a segment without queries takes no block."""
    seen = [np.zeros(s.n + s.m, np.int64) for s in plan.segs]
    for si, d0, d1 in block_map(plan):
        assert d0 < d1
        seen[si][d0:d1] += 1
    for s, cov in zip(plan.segs, seen):
        np.testing.assert_array_equal(cov, 1 if s.m else 0)
    sizes = [tmc.segment_blocks(s.n, s.m) for s in plan.segs]
    np.testing.assert_array_equal(plan.block0, np.concatenate([[0], np.cumsum(sizes)]))


def test_constants_match_the_kernel():
    """The Python plan tiles as the kernel does."""
    src = open(CU).read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kThreads"] == tmc.THREADS and consts["kItems"] == tmc.ITEMS
    assert "constexpr int kTiles = kThreads / 32 - 1;" in src and tmc.TILES == tmc.THREADS // 32 - 1
    assert consts["kBases"] == tmc.N_SLOTS and consts["kInline"] == tmc.N_INLINE
    assert f"sizeof(Segment) == {tmc._F} * sizeof(int64_t)" in src


@pytest.mark.parametrize("sizes", [
    [(0, 0)], [(0, 5)], [(5, 0)], [(1, 1)], [(tmc.SPAN, 0), (0, tmc.SPAN), (7, 301_056)],
    [(3, 2), (0, 0), (0, 0), (tmc.SPAN - 1, 1), (10**6, 17), (17, 10**6), (0, 9)],
])
def test_block_plan_covers_every_diagonal_once(sizes):
    segs = [tmc.Segment(n, m, q=(0, 0), strict=False, a=(0, 0)) for n, m in sizes]
    assert_covers(tmc.plan_segments(segs, CPU))


def _join(pkg, lt, rt, deltas=(0, 0, 0, 0)):
    ex, iv, Join, Scan, Table, Alg, _ = PKGS[pkg]

    def bound(idx, d):
        col = ex.Column("x", idx)
        return col if d == 0 else ex.BinaryExpr(col, "+" if d > 0 else "-", ex.Literal(abs(d)))

    lt, rt = Table(lt), Table(rt)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    join = Join(
        Scan("l", lt), Scan("r", rt),
        on=[(ex.Column("contig", 0), ex.Column("contig", 0))], filter_=None,
        intervals=iv.ColIntervals(iv.ColInterval(bound(1, deltas[0]), bound(2, deltas[1])),
                                  iv.ColInterval(bound(1, deltas[2]), bound(2, deltas[3]))),
        algorithm=Alg.COITREES, **kw,
    )
    return join, lt, rt


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, degenerate=0.0):
    lts = rng.integers(0, span, n).astype(np.int64)
    rts = rng.integers(0, span, m).astype(np.int64)
    re_ = rts + rng.integers(2, 3000, m)
    if degenerate:
        flip = rng.random(m) < degenerate
        re_ = np.where(flip, rts - rng.integers(1, 500, m), re_)
    lt = pa.table({"contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
                   "s": lts, "e": lts + rng.integers(2, 3000, n)})
    rt = pa.table({"contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
                   "s": rts, "e": re_})
    return lt, rt


def count_inputs(pkg, lt, rt):
    join, l, r = _join(pkg, lt, rt)
    return join._merge_count_plan(l, r, *join._sorted_count_inputs(l, r))


def packed_count_slots(tplan):
    """The count's slots (a1, q1, a2, q2, totals) from the port's plan."""
    pv = tmc.pack_view_plain
    q1 = pv(*tplan[0:3], tmc.BUILD_PAD)
    a1 = pv(*tplan[3:6], tmc.PROBE_PAD)
    q2 = pv(*tplan[6:9], tmc.BUILD_PAD)
    a2 = pv(*tplan[9:12], tmc.PROBE_PAD)
    return a1, q1, a2, q2, torch.zeros(2, dtype=torch.int64)


def level_plan(pkg, lt, rt, deltas=(0, 0, 0, 0)):
    join, l, r = _join(pkg, lt, rt, deltas)
    index, *_ = join._prepare(PKGS[pkg][-1](), l, r)
    plan = join._merge_bounds_plan(l, r, index)
    assert plan is not None
    return index, plan, r.num_rows


def test_count_plan_of_a_table_pair(rng):
    slots = packed_count_slots(count_inputs("torch", *_tables(rng, 700, 1500)))
    a1, q1, a2, q2, _ = slots
    plan = tmc.plan_segments(tmc.count_segments(a1.numel(), q1.numel(), a2.numel(), q2.numel()),
                             CPU)
    assert len(plan.segs) == 2 and plan.desc is None
    assert_covers(plan)


def test_level_plan_of_a_table_pair(rng):
    """2L segments, ub rows after lb rows, empty levels included."""
    index, plan, m = level_plan("torch", *_tables(rng, 400, 700))
    segplan, L, n = plan[0], plan[7], plan[8]
    assert L == index.num_levels and n == m and len(segplan.segs) == 2 * L
    assert sorted(s.out[1] for s in segplan.segs) == [i * n for i in range(2 * L)]
    assert [s.n for s in segplan.segs[::2]] == list(index.level_sizes)
    assert_covers(segplan)


# ---------------------------------------------------------------------------
# (b) the merge-path split and merge, emulated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("n,m", [(700, 500), (50, 1200), (1300, 3), (0, 40), (40, 0)])
def test_split_at_every_diagonal(rng, strict, n, m):
    a, q = sorted_u32(rng, n, runs=False), sorted_u32(rng, m, runs=False)
    a[: n // 3] = a[n // 3] if n else 0  # a long duplicate run shared by both
    q[: m // 2] = a[n // 3] if n else 0
    a, q = np.sort(a), np.sort(q)
    want = merged_splits(a, q, strict)
    a, q = a.tolist(), q.tolist()
    got = [diagonal_split(a, q, d, strict) for d in range(n + m + 1)]
    np.testing.assert_array_equal(got, want)
    for ways in (2, 3, 32):
        got = [block_split(a, q, d, strict, ways) for d in range(n + m + 1)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("n,m,tile", [
    (6000, 3000, tmc.TILE), (2500, 7000, tmc.TILE), (1, 700, 64), (900, 1, 64),
    (0, 300, 64), (300, 0, 64), (400, 400, 16),
])
def test_emulated_kernel_equals_searchsorted(rng, strict, n, m, tile):
    a, q = sorted_u32(rng, n), sorted_u32(rng, m)
    want = torch.searchsorted(tmc.as_u32(bits(a)), tmc.as_u32(bits(q)), right=not strict)
    got = merge_path_ranks(a, q, strict, tile=tile, items=min(tmc.ITEMS, tile),
                           ways=min(32, tile // 8))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("where", ["below", "above"])
def test_emulated_kernel_all_queries_on_one_side(rng, strict, where):
    a = np.sort(rng.integers(1000, 2**31, 3000, dtype=np.uint64).astype(np.uint32))
    q = np.full(2100, 999 if where == "below" else 2**32 - 1, np.uint32)
    got = merge_path_ranks(a, q, strict)
    np.testing.assert_array_equal(got, 0 if where == "below" else len(a))


# ---------------------------------------------------------------------------
# (c) merge_rank_segments_plain against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(700, 1500), (2500, 300), (300, 2500)])
def test_count_segments_match_jax(rng, shape):
    lt, rt = _tables(rng, *shape)
    limbs = np.asarray(jmc.merge_count_passes(*count_inputs("jax", lt, rt))).astype(np.int64)
    want = jmc.limbs_to_total(limbs[:4]) - jmc.limbs_to_total(limbs[4:])
    slots = packed_count_slots(count_inputs("torch", lt, rt))
    segs = tmc.count_segments(*(t.numel() for t in slots[:4]))
    tmc.merge_rank_segments_plain(segs, slots)
    totals = slots[4]
    assert int(totals[0] - totals[1]) == want


@pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
def test_level_segments_match_jax(rng, deltas):
    lt, rt = _tables(rng, 400, 700, degenerate=0.1)
    _, jplan, m = level_plan("jax", lt, rt, deltas)
    jlb, jub = (np.asarray(x)[:, :m] for x in jmc.merge_level_bounds(jplan))
    _, plan, _ = level_plan("torch", lt, rt, deltas)
    segplan, pqe_k, pqe_v, pqs_k, pqs_v, c_qe, c_qs, L, n = plan
    q_e = tmc.pack_view_plain(pqe_k, pqe_v, c_qe, tmc.BUILD_PAD)
    q_s = tmc.pack_view_plain(pqs_k, pqs_v, c_qs, tmc.BUILD_PAD)
    bounds = torch.full((2, L, n), -1, dtype=torch.int32)
    tmc.merge_rank_segments_plain(segplan.segs, (q_e, q_s, bounds.view(-1)))
    np.testing.assert_array_equal(bounds[0].numpy(), jlb)
    np.testing.assert_array_equal(bounds[1].numpy(), jub)


# ---------------------------------------------------------------------------
# The wrapper's contract on the CPU
# ---------------------------------------------------------------------------


def mixed_segments(rng, device=CPU):
    """(segments, slots, plain copy of the slots): every edge case of one
    launch.  Slots: 0 packed tables, 1 queries, 2 ranks, 3 sums."""
    cases = [  # (n, m, raw)
        (0, 300, False), (500, 0, False), (1, 257, True), (20_000, 37, False),
        (37, 20_000, True), (6 * tmc.TILE, 3 * tmc.TILE, False), (3000, 3000, True),
        (0, 5, True),
    ]
    tabs, qs, segs, raws = [], [], [], []
    a_off = q_off = out_off = 0
    for i, (n, m, raw) in enumerate(cases):
        a, q = sorted_u32(rng, n), sorted_u32(rng, m)
        strict = bool(i % 2)
        n_real = max(m - 3, 0)
        ord_ = torch.from_numpy(rng.permutation(n_real).astype(np.int64)).to(device)
        kw = dict(out=(2, out_off), ord=ord_, n_real=n_real) if i % 3 else dict(total=(3, i))
        if raw:  # the packed values as key codes and values through a C table
            k = torch.from_numpy(np.minimum(rng.integers(0, 3, n), 2).astype(np.int32))
            c = bits(np.array([7, 2**31, 5], np.uint32))
            v = (bits(a).to(torch.int64) - c.to(torch.int64)[k.long()]).to(torch.int32)
            k, v, c = k.to(device), v.to(device), c.to(device)
            raws.append((k, v, c))
            segs.append(tmc.Segment(n, m, q=(1, q_off), strict=strict,
                                    raw=(k, v, c, tmc.PROBE_PAD), **kw))
        else:
            segs.append(tmc.Segment(n, m, q=(1, q_off), strict=strict, a=(0, a_off), **kw))
            tabs.append(a)
            a_off += n
        qs.append(q)
        q_off += m
        out_off += n_real if "out" in kw else 0
    slots = (bits(np.concatenate(tabs)), bits(np.concatenate(qs)),
             torch.full((out_off,), -1, dtype=torch.int32), torch.zeros(len(cases), dtype=torch.int64))
    return segs, tuple(t.to(device) for t in slots)


def test_mixed_segments_plain_equals_searchsorted(rng):
    """The plain version: ranks through each order and sums, raw tables
    packed, against a per-segment searchsorted."""
    segs, slots = mixed_segments(rng)
    tmc.merge_rank_segments(tmc.plan_segments(segs, CPU), slots)
    for i, s in enumerate(segs):
        q = slots[1][s.q[1]:s.q[1] + s.m]
        a = slots[0][s.a[1]:s.a[1] + s.n] if s.a else tmc.pack_view_plain(*s.raw)
        want = tmc.merge_rank_plain(a, q, strict=s.strict).to(torch.int64)
        if s.total:
            assert int(slots[3][i]) == int(want.sum())
        else:
            got = slots[2][s.out[1]:s.out[1] + s.n_real][s.ord].to(torch.int64)
            assert torch.equal(got, want[:s.n_real])


def test_contract_rejects_bad_plans_and_slots():
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmc.plan_segments([], CPU)
    with pytest.raises(ValueError):  # neither a packed nor a raw table
        tmc.plan_segments([tmc.Segment(1, 4, q=(0, 0), strict=True)], CPU)
    with pytest.raises(ValueError):  # an order without an output
        tmc.plan_segments([tmc.Segment(1, 4, q=(0, 0), strict=True, a=(0, 0),
                                       ord=torch.arange(4))], CPU)
    plan = tmc.plan_segments([tmc.Segment(4, 4, q=(1, 0), strict=True, a=(0, 1))], CPU)
    with pytest.raises(ValueError):  # the table runs past its slot
        tmc.merge_rank_segments(plan, (q, q))
    with pytest.raises(TypeError):
        tmc.merge_rank_segments(plan, (q.to(torch.int64), q))
    with pytest.raises(ValueError):
        tmc.merge_rank_segments(plan, (q,) * (tmc.N_SLOTS + 1))


def test_cpu_launches_no_kernel(rng):
    segs, slots = mixed_segments(rng)
    with metrics.recording() as rec:
        tmc.merge_rank_segments(tmc.plan_segments(segs, CPU), slots)
    assert rec.counts()["launch.merge_path"] == 0


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
    """One launch (descriptors on the card) of every edge case."""
    segs, slots = mixed_segments(rng, cuda_device)
    plain = tuple(t.cpu().clone() for t in slots)
    cpu_segs = [s._replace(ord=None if s.ord is None else s.ord.cpu(),
                           raw=None if s.raw is None else (*(t.cpu() for t in s.raw[:3]), s.raw[3]))
                for s in segs]
    with metrics.recording() as rec:
        tmc.merge_rank_segments(tmc.plan_segments(segs, cuda_device), slots)
    torch.cuda.synchronize()
    assert rec.counts()["launch.merge_path"] == 1
    tmc.merge_rank_segments_plain(cpu_segs, plain)
    for got, want in zip(slots, plain):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
def test_inline_count_kernel_equals_plain(rng, cuda_device, strict):
    """Two packed segments passed as kernel parameters, ragged lengths."""
    a1, q1 = sorted_u32(rng, 300_001), sorted_u32(rng, 70_003)
    a2, q2 = sorted_u32(rng, 5), sorted_u32(rng, 123_457)
    slots = tuple(bits(x, cuda_device) for x in (a1, q1, a2, q2))
    totals = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    segs = [s._replace(strict=strict) for s in tmc.count_segments(len(a1), len(q1), len(a2), len(q2))]
    tmc.merge_rank_segments(tmc.plan_segments(segs, cuda_device), (*slots, totals))
    want = [int(tmc.merge_rank_plain(a, q, strict=strict, reduce=True))
            for a, q in (slots[:2], slots[2:])]
    assert totals.tolist() == want


@pytest.mark.cuda
def test_level_bounds_on_card_match_cpu(rng, cuda_device):
    lt, rt = _tables(rng, 3000, 5000, degenerate=0.1)
    _, plan, _ = level_plan("torch", lt, rt)
    want = tmc.merge_level_bounds(plan)
    join, l, r = _join("torch", lt, rt)
    join.device = cuda_device
    index, *_ = join._prepare(TorchCtx(TorchConfig()), l, r)
    got = tmc.merge_level_bounds(join._merge_bounds_plan(l, r, index))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
