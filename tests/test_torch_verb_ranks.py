"""Port parity: the genomic verbs' merge rank passes (B1's verb mode).

plan_verb_ranks of sequila_tpu_torch (``device="cpu"``) and of the JAX
package on the same arrow tables: merge_verb_rank4 through the segmented
launch's plain path and merge_verb_rank4_plain (no segment machinery)
against the JAX merge_verb_rank4 (its four Pallas B1 calls in interpret
mode on the CPU), element for element; coverage_from_ranks against the
JAX finish; the want4=False plan's per-probe counts against the JAX
merge_probe_count_passes; the preconditions that decline a plan.  The
``cuda`` test holds a warm merge_verb_rank4 to one B1 launch and four
pack_view launches.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from test_torch_interval_count import _degenerate_probe, _dup, _inverted_build, _tables, _wide

COLS = (0, 1, 2)  # (contig, s, e) of the helpers' tables


def _pair(b, a):
    return (JaxTable(b), JaxTable(a)), (TorchTable(b), TorchTable(a))


def _plans(b, a, want4, device="cpu"):
    (jb, ja), (tb, ta) = _pair(b, a)
    jplan = jmc.plan_verb_ranks(jb, ja, COLS, COLS, want4=want4)
    tplan = tmc.plan_verb_ranks(tb, ta, COLS, COLS, want4=want4, device=device)
    return jplan, tplan, a.num_rows


def _prefix(t: pa.Table, col: str) -> np.ndarray:
    """int64 exclusive prefix sum of the (contig, col)-sorted view's values
    (PAD tail included, as the dataframe caches it)."""
    _, v, _, _, _ = TorchTable(t).sorted_interval_view(0, t.schema.get_field_index(col), "cpu")
    return np.concatenate([[0], np.cumsum(v.numpy().astype(np.int64))])


SHAPES = {
    "several_keys": lambda rng: _tables(rng, 500, 700, lkeys=4, rkeys=6),
    "negative_missing_keys": lambda rng: _tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True),
    "probe_larger": lambda rng: _tables(rng, 300, 2000),
    "build_larger": lambda rng: _tables(rng, 2000, 300),
    "dense_ties": lambda rng: (_dup(1500, 3), _dup(2000, 4)),
}


class TestMergeVerbRank4:
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_equals_jax(self, rng, shape):
        b, a = SHAPES[shape](rng)
        jplan, tplan, n = _plans(b, a, want4=True)
        want = np.asarray(jmc.merge_verb_rank4(*jplan))[:, :n]
        got = tmc.merge_verb_rank4(tplan)
        assert got.dtype == torch.int32 and got.shape == (4, n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmc.merge_verb_rank4_plain(tplan).numpy(), want)

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_coverage_from_ranks_equals_jax(self, rng, shape):
        b, a = SHAPES[shape](rng)
        jplan, tplan, n = _plans(b, a, want4=True)
        ranks = tmc.merge_verb_rank4(tplan)
        qs = a.column("s").to_numpy().astype(np.int32)
        qe = a.column("e").to_numpy().astype(np.int32)
        psum, esum = _prefix(b, "s"), _prefix(b, "e")
        want = jmc.coverage_from_ranks(ranks.numpy(), qs, qe, psum, esum)
        got = tmc.coverage_from_ranks(
            ranks, torch.from_numpy(qs), torch.from_numpy(qe),
            torch.from_numpy(psum), torch.from_numpy(esum),
        )
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        assert want[0].sum() > 0

    def test_plan_is_four_segments_of_one_launch(self, rng):
        b, a = _tables(rng, 300, 500)
        _, tplan, n = _plans(b, a, want4=True)
        segs = tplan.segplan.segs
        assert len(segs) == 4 and len(tplan.packs) == 4 and tplan.n == n
        assert [s.strict for s in segs] == [False, True, False, True]
        assert [s.out for s in segs] == [(4, i * n) for i in range(4)]
        assert [s.q for s in segs] == [(i, 0) for i in range(4)]
        # ub_s and ub_e write through the (k, qe) order, lb_e and lb_s
        # through the (k, qs) order
        assert segs[0].ord is segs[2].ord and segs[1].ord is segs[3].ord
        assert segs[0].ord is not segs[1].ord
        assert all(s.ord.dtype == torch.int64 and s.n_real == n for s in segs)
        assert all(s.raw[3] == tmc.PROBE_PAD for s in segs)
        assert tplan.packs[0][0] is tplan.packs[2][0]  # both (k, qe) packs read one view

    def test_want4_false_gives_the_probe_count_plan(self, rng):
        b, a = _tables(rng, 600, 400, lkeys=4, rkeys=6, neg=True)
        jplan, tplan, n = _plans(b, a, want4=False)
        assert isinstance(tplan, tmc.ProbeCountPlan)
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        np.testing.assert_array_equal(tmc.merge_probe_count_passes(tplan).numpy(), want)

    @pytest.mark.parametrize("want4", [False, True])
    @pytest.mark.parametrize("shape", ["empty_build", "empty_probe", "null_keys", "degenerate",
                                       "inverted", "mixed_key_types", "span"])
    def test_declined_like_jax(self, rng, want4, shape):
        b, a = _tables(rng, 200, 300)
        if shape == "empty_build":
            b = b.slice(0, 0)
        elif shape == "empty_probe":
            a = a.slice(0, 0)
        elif shape == "null_keys":
            keys = a.column("contig").to_pylist()
            keys[::5] = [None] * len(keys[::5])
            a = a.set_column(0, "contig", pa.array(keys))
        elif shape == "degenerate":
            b, a = _degenerate_probe(rng)
        elif shape == "inverted":
            b, a = _inverted_build(rng)
        elif shape == "mixed_key_types":
            a = a.set_column(0, "contig", pa.array(rng.integers(0, 4, a.num_rows)))
        else:
            b, a = _wide(500, 1), _wide(700, 2)
        jplan, tplan, _ = _plans(b, a, want4=want4)
        assert jplan is None and tplan is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_warm_verb_rank4_launches_b1_once(rng, cuda_device):
    b, a = _tables(rng, 3000, 5000, lkeys=4, rkeys=6)
    _, cpu_plan, _ = _plans(b, a, want4=True)
    want = tmc.merge_verb_rank4(cpu_plan)
    _, plan, _ = _plans(b, a, want4=True, device=cuda_device)
    tmc.merge_verb_rank4(plan)
    b1, packs = tmc.merge_rank_sorted.launches, tmc.pack_view.launches
    got = tmc.merge_verb_rank4(plan)
    torch.cuda.synchronize()
    assert tmc.merge_rank_sorted.launches == b1 + 1
    assert tmc.pack_view.launches == packs + 4
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(tmc.merge_verb_rank4_plain(plan).cpu().numpy(), want.numpy())
