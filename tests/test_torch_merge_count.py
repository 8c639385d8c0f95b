"""Port parity: sequila_tpu_torch/ops/cuda/merge_count.py vs the JAX package.

The same numpy inputs, made from a seed, go through the JAX merge-count
pieces (the Pallas kernel in interpret mode on the CPU) and through the
port's wrappers (their plain PyTorch versions on CPU tensors).  Ranks,
packed values and counts are integers: every comparison is exact.
The ``cuda`` tests hold each kernel against its plain version on the card.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.config import Algorithm
from sequila_tpu.exec.joins.interval_join import IntervalJoinExec as JaxJoin
from sequila_tpu.exec.plan import ScanExec as JaxScan
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu.planner.expr import Column as JaxColumn
from sequila_tpu.planner.intervals import ColInterval as JaxCI
from sequila_tpu.planner.intervals import ColIntervals as JaxCIs
from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec as TorchJoin
from sequila_tpu_torch.exec.plan import ScanExec as TorchScan
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from sequila_tpu_torch.planner.expr import Column as TorchColumn
from sequila_tpu_torch.planner.intervals import ColInterval as TorchCI
from sequila_tpu_torch.planner.intervals import ColIntervals as TorchCIs
from sequila_tpu_torch.utils import metrics

CPU = torch.device("cpu")


def to_torch(x, device=CPU) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor; u32 becomes int32 bits."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def jax_plan_to_torch(jplan, device=CPU) -> tuple:
    """The JAX merge-count plan's sorted views and C tables as the port's
    ``merge_count_passes`` arguments (the port's kernel reads no windows)."""
    return tuple(to_torch(x, device) for x in jplan[:12])


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _sorted_u32(rng, n):
    """Sorted u32 values with duplicate runs and both sentinels."""
    vals = rng.choice(rng.integers(0, 2**32 - 2, max(n // 4, 1), dtype=np.uint64), n)
    vals[-3:] = tmc.PROBE_PAD
    vals[-1:] = tmc.BUILD_PAD
    return np.sort(vals.astype(np.uint32))


def _windows(a_h, q_h):
    lo = np.searchsorted(a_h, q_h[0 :: jmc.BLOCK], side="left")
    hi = np.searchsorted(a_h, q_h[jmc.BLOCK - 1 :: jmc.BLOCK], side="right")
    c_lo = (lo // jmc.CHUNK).astype(np.int32)
    c_hi = (-((-hi) // jmc.CHUNK)).astype(np.int32)
    return c_lo, np.maximum(c_hi - c_lo, 0).astype(np.int32)


def _tables(rng, n, m, lkeys=5, rkeys=6, span=8000, neg=False):
    lo = -span if neg else 0
    lts = rng.integers(lo, span, n).astype(np.int64)
    rts = rng.integers(lo, span, m).astype(np.int64)
    left = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, lkeys, n)],
        "s": lts,
        "e": lts + rng.integers(2, 3000, n),
    })
    right = pa.table({
        "contig": [f"c{int(k)}" for k in rng.integers(0, rkeys, m)],
        "s": rts,
        "e": rts + rng.integers(2, 3000, m),
    })
    return left, right


def _plans(left: pa.Table, right: pa.Table):
    """(JAX plan, port plan) of the merge count for one arrow table pair."""
    jl, jr = JaxTable(left), JaxTable(right)
    tl, tr = TorchTable(left), TorchTable(right)
    jjoin = JaxJoin(
        JaxScan("l", jl), JaxScan("r", jr),
        on=[(JaxColumn("contig", 0), JaxColumn("contig", 0))], filter_=None,
        intervals=JaxCIs(JaxCI(JaxColumn("s", 1), JaxColumn("e", 2)),
                         JaxCI(JaxColumn("s", 1), JaxColumn("e", 2))),
        algorithm=Algorithm.COITREES,
    )
    tjoin = TorchJoin(
        TorchScan("l", tl), TorchScan("r", tr),
        on=[(TorchColumn("contig", 0), TorchColumn("contig", 0))], filter_=None,
        intervals=TorchCIs(TorchCI(TorchColumn("s", 1), TorchColumn("e", 2)),
                           TorchCI(TorchColumn("s", 1), TorchColumn("e", 2))),
        algorithm=Algorithm.COITREES, device="cpu",
    )
    jplan = jjoin._merge_count_plan(jl, jr, *jjoin._sorted_count_inputs(jl, jr))
    tplan = tjoin._merge_count_plan(tl, tr, *tjoin._sorted_count_inputs(tl, tr))
    return jplan, tplan


class TestPlanning:
    def test_plan_packing_matches_jax(self, rng):
        left, right = _tables(rng, 500, 700, lkeys=4, rkeys=7, neg=True)
        jl, jr = JaxTable(left), JaxTable(right)
        remap_b = np.array([0, 2, 3, 5], np.int32)
        remap_q = np.arange(7, dtype=np.int32)
        views = (
            jl.per_key_minmax(0, 1), jl.per_key_minmax(0, 2),
            jr.per_key_minmax(0, 1), jr.per_key_minmax(0, 2),
        )
        for deltas in ((0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)):
            want = jmc.plan_packing(remap_b, remap_q, views, deltas)
            got = tmc.plan_packing(remap_b, remap_q, views, deltas)
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.uint32
                np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("top", [2**32 - 46, 2**32 - 45])
    def test_joint_domain_and_c_tab_match_jax(self, top):
        """Summed spans of top + 44: just inside, then just outside the
        32-bit budget (2^32 - 2)."""
        remap_b = np.array([0, 1], np.int32)
        remap_q = np.array([0, 2], np.int32)
        mn = np.array([-5, 0], np.int64)
        mx = np.array([top, 17], np.int64)
        args = (remap_b, remap_q, 3, mn, mx, 1, mn, mx, -1)
        want = jmc._joint_domain(*args)
        got = tmc._joint_domain(*args)
        assert (got is None) == (want is None) == (top == 2**32 - 45)
        if want is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(
                tmc._c_tab(remap_q, *got, -7), jmc._c_tab(remap_q, *want, -7)
            )

    def test_plan_packing_declines_like_jax(self):
        remap = np.array([0, 1], np.int32)
        over = tuple(
            (np.array([0, 0], np.int64), np.array([2**31, 2**31], np.int64))
            for _ in range(4)
        )
        assert jmc.plan_packing(remap, remap, over, (0, 0, 0, 0)) is None
        assert tmc.plan_packing(remap, remap, over, (0, 0, 0, 0)) is None


class TestPackView:
    @pytest.mark.parametrize("pad", [tmc.BUILD_PAD, tmc.PROBE_PAD])
    def test_matches_jax(self, rng, pad):
        n, nkeys = 3000, 7
        k = rng.integers(0, nkeys, n).astype(np.int32)
        k[rng.random(n) < 0.1] = 2**31 - 1  # PAD rows
        v = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        c = rng.integers(0, 2**32, nkeys, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(
            jmc._pack_view(jnp.asarray(k), jnp.asarray(v), jnp.asarray(c), np.uint32(pad))
        )
        got = tmc.pack_view(to_torch(k), to_torch(v), to_torch(c), pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(u32(got), want)

    def test_plan_views_pack_like_jax(self, rng):
        """Real cached views and C tables of a table pair, both sentinels."""
        jplan, _ = _plans(*_tables(rng, 600, 900))
        tplan = jax_plan_to_torch(jplan)
        for i, pad in ((0, tmc.BUILD_PAD), (3, tmc.PROBE_PAD), (6, tmc.BUILD_PAD),
                       (9, tmc.PROBE_PAD)):
            want = np.asarray(jmc._pack_view(*jplan[i:i + 3], np.uint32(pad)))
            got = tmc.pack_view(*tplan[i:i + 3], pad)
            np.testing.assert_array_equal(u32(got), want)


class TestMergeRank:
    @pytest.mark.parametrize("strict", [True, False])
    def test_random_u32_matches_jax(self, rng, strict):
        a_h = _sorted_u32(rng, 5120)
        q_h = _sorted_u32(rng, 4096)
        c_lo, n_ch = _windows(a_h, q_h)
        want = np.asarray(jmc._merge_rank_sorted(
            jnp.asarray(a_h), jnp.asarray(q_h), jnp.asarray(c_lo), jnp.asarray(n_ch),
            strict=strict,
        ))
        got = tmc.merge_rank_sorted(to_torch(a_h), to_torch(q_h), strict=strict)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        total = tmc.merge_rank_sorted(to_torch(a_h), to_torch(q_h), strict=strict, reduce=True)
        assert total.dtype == torch.int64 and int(total) == int(want.astype(np.int64).sum())

    def test_plan_passes_match_jax_with_host_windows(self, rng):
        """Both BITS passes of a real plan: the JAX kernel over its
        host_windows_joint windows, the port over the same packed arrays."""
        jplan, _ = _plans(*_tables(rng, 700, 1500))
        tplan = jax_plan_to_torch(jplan)
        passes = (
            (0, 3, 12, False),  # build (k, end) in probe (k, qs), #{a <= q}
            (6, 9, 14, True),  # build (k, start) in probe (k, qe), #{a < q}
        )
        for qi, ai, wi, strict in passes:
            q_j = jmc._pack_view(*jplan[qi:qi + 3], jmc._BUILD_PAD)
            a_j = jmc._pack_view(*jplan[ai:ai + 3], jmc._PROBE_PAD)
            want = np.asarray(jmc._merge_rank_sorted(
                a_j, q_j, jplan[wi], jplan[wi + 1], strict=strict,
            ))
            q_t = tmc.pack_view(*tplan[qi:qi + 3], tmc.BUILD_PAD)
            a_t = tmc.pack_view(*tplan[ai:ai + 3], tmc.PROBE_PAD)
            got = tmc.merge_rank_sorted(a_t, q_t, strict=strict)
            np.testing.assert_array_equal(got.numpy(), want)

    def test_empty_table_and_queries(self):
        empty = torch.empty(0, dtype=torch.int32)
        q = to_torch(np.array([0, 5, 0xFFFFFFFF], np.uint32))
        for strict in (True, False):
            assert tmc.merge_rank_sorted(empty, q, strict=strict).tolist() == [0, 0, 0]
            assert tmc.merge_rank_sorted(q, empty, strict=strict).numel() == 0
            assert int(tmc.merge_rank_sorted(q, empty, strict=strict, reduce=True)) == 0


class TestMergeCountPasses:
    @pytest.mark.parametrize("shape", [(700, 1500), (2500, 300), (300, 2500)])
    def test_limb_total_equals_int64_total(self, rng, shape):
        left, right = _tables(rng, *shape)
        jplan, tplan = _plans(left, right)
        limbs = np.asarray(jmc.merge_count_passes(*jplan)).astype(np.int64)
        want = jmc.limbs_to_total(limbs[:4]) - jmc.limbs_to_total(limbs[4:])
        got = tmc.merge_count_passes(*tplan)
        assert got.dtype == torch.int64
        assert int(got) == want
        # the JAX plan's own arrays, carried across, give the same total
        assert int(tmc.merge_count_passes(*jax_plan_to_torch(jplan))) == want


class TestWrapperContract:
    def test_rejects_wrong_dtype_and_mixed_devices(self):
        a = torch.zeros(4, dtype=torch.int64)
        with pytest.raises(TypeError):
            tmc.merge_rank_sorted(a, a.to(torch.int32), strict=True)
        q = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError):
            tmc.merge_rank_sorted(q, q.to("meta"), strict=True)
        with pytest.raises(ValueError):
            tmc.pack_view(q, q[:3], q, tmc.BUILD_PAD)

    def test_cpu_tensors_launch_no_kernel(self, rng):
        _, tplan = _plans(*_tables(rng, 200, 300))
        with metrics.recording() as rec:
            tmc.merge_count_passes(*tplan)
        got = rec.counts()
        assert (got["launch.pack_view"], got["launch.merge_path"]) == (0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("strict", [True, False])
    def test_merge_rank_kernel_equals_plain(self, rng, cuda_device, strict):
        a = to_torch(_sorted_u32(rng, 300_001), cuda_device)
        q = to_torch(_sorted_u32(rng, 70_003), cuda_device)
        with metrics.recording() as rec:
            got = tmc.merge_rank_sorted(a, q, strict=strict)
            total = tmc.merge_rank_sorted(a, q, strict=strict, reduce=True)
        torch.cuda.synchronize()
        assert rec.counts()["launch.merge_path"] == 2
        want = tmc.merge_rank_plain(a, q, strict=strict)
        assert torch.equal(got, want)
        assert int(total) == int(want.to(torch.int64).sum())

    def test_pack_view_kernel_equals_plain(self, rng, cuda_device):
        n = 100_003
        k = rng.integers(0, 9, n).astype(np.int32)
        k[rng.random(n) < 0.05] = 2**31 - 1
        v = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        c = rng.integers(0, 2**32, 9, dtype=np.uint64).astype(np.uint32)
        k, v, c = (to_torch(x, cuda_device) for x in (k, v, c))
        for pad in (tmc.BUILD_PAD, tmc.PROBE_PAD):
            got = tmc.pack_view(k, v, c, pad)
            torch.cuda.synchronize()
            assert torch.equal(got, tmc.pack_view_plain(k, v, c, pad))

    def test_merge_count_on_card_matches_jax(self, rng, cuda_device):
        jplan, _ = _plans(*_tables(rng, 3000, 5000))
        limbs = np.asarray(jmc.merge_count_passes(*jplan)).astype(np.int64)
        want = jmc.limbs_to_total(limbs[:4]) - jmc.limbs_to_total(limbs[4:])
        assert int(tmc.merge_count_passes(*jax_plan_to_torch(jplan, cuda_device))) == want
