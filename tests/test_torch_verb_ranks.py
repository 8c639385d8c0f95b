"""Port parity: the genomic verbs' merge rank passes (B1's verb mode).

plan_verb_ranks of sequila_tpu_torch (``device="cpu"``) and of the JAX
package on the same arrow tables: merge_verb_rank4 through the segmented
launch's plain path (ranks in view order, then unpermute_ranks' plain
version through the cached inverse orders) and
merge_verb_rank4_plain (no segment machinery) against the JAX
merge_verb_rank4 (its four Pallas B1 calls in interpret mode on the CPU),
element for element, also on probes already in view order, reversed, of
one key, one row past a 2048 multiple and of one row; the inverse-order
cache; coverage_from_ranks against the JAX finish and the DataFrame
coverage on the merge route against the JAX package's; the want4=False
plan's per-probe counts (ranks in view order, then unpermute_counts)
against the JAX merge_probe_count_passes on every shape; the
preconditions that decline a plan.  The ``cuda`` test holds a warm
merge_verb_rank4 to four pack_view launches, one B1 launch and one
un-permute launch, and the un-permute kernel to its plain version.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu import dataframe as jdf
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu.ops.pallas import merge_count as jmc
from sequila_tpu_torch import dataframe as tdf
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from sequila_tpu_torch.utils import metrics
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
    _, v, _ = TorchTable(t).sorted_interval_view(0, t.schema.get_field_index(col), "cpu")
    return np.concatenate([[0], np.cumsum(v.numpy().astype(np.int64))])


def _probe_in_view_order(rng, m, reverse=False):
    """(build, probe): the probe's rows already in the order of both its
    sorted views, (contig, s) and (contig, e) (distinct starts a key, one
    length), or in the reverse order."""
    keys = rng.integers(0, 4, m)
    s = rng.choice(8000, m, replace=False)
    order = np.lexsort((s, keys))[::-1 if reverse else 1]
    probe = pa.table({"contig": [f"c{k}" for k in keys[order]], "s": s[order],
                      "e": s[order] + 700})
    return _tables(rng, 600, 1, lkeys=4)[0], probe


def _one_probe_row(rng):
    probe = pa.table({"contig": ["c0"], "s": [100], "e": [6000]})
    return _tables(rng, 400, 1, lkeys=2)[0], probe


SHAPES = {
    "several_keys": lambda rng: _tables(rng, 500, 700, lkeys=4, rkeys=6),
    "negative_missing_keys": lambda rng: _tables(rng, 700, 300, lkeys=3, rkeys=9, neg=True),
    "probe_larger": lambda rng: _tables(rng, 300, 2000),
    "build_larger": lambda rng: _tables(rng, 2000, 300),
    "dense_ties": lambda rng: (_dup(1500, 3), _dup(2000, 4)),
    "identity_orders": lambda rng: _probe_in_view_order(rng, 900),
    "reverse_orders": lambda rng: _probe_in_view_order(rng, 900, reverse=True),
    "one_key": lambda rng: _tables(rng, 700, 900, lkeys=1, rkeys=1),
    "pad_tail": lambda rng: _tables(rng, 500, 2 * 2048 + 1),
    "one_probe_row": _one_probe_row,
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

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_dataframe_coverage_equals_jax(self, rng, monkeypatch, shape):
        """DataFrame coverage on the port's merge route (through
        merge_verb_rank4) against the JAX package's coverage."""
        b, a = SHAPES[shape](rng)
        cols = ("contig", "s", "e")
        want = jdf.coverage(JaxTable(a), JaxTable(b), cols=cols)
        ran = []
        fn = tmc.merge_verb_rank4
        monkeypatch.setattr(tmc, "merge_verb_rank4", lambda plan: ran.append(plan) or fn(plan))
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        got = tdf.coverage(TorchTable(a), TorchTable(b), cols=cols, device="cpu")
        assert len(ran) == 1
        assert got.arrow.equals(want.arrow)

    def test_plan_is_four_segments_of_one_launch(self, rng):
        b, a = _tables(rng, 300, 500)
        _, tplan, n = _plans(b, a, want4=True)
        segs = tplan.segplan.segs
        assert len(segs) == 4 and len(tplan.packs) == 4 and tplan.n == n
        assert [s.strict for s in segs] == [False, True, False, True]
        # ranks direct, in view order, into row i of the [4, n] ranks
        assert [s.out for s in segs] == [(4, i * n) for i in range(4)]
        assert [s.q for s in segs] == [(i, 0) for i in range(4)]
        assert all(s.ord is None and s.n_real == n for s in segs)
        assert tplan.segplan.need[4] == (torch.int32, 4 * n)
        assert all(s.raw[3] == tmc.PROBE_PAD for s in segs)
        assert tplan.packs[0][0] is tplan.packs[2][0]  # both (k, qe) packs read one view
        assert tplan.inv_qe.dtype == tplan.inv_qs.dtype == torch.int32

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_inverse_orders_are_cached(self, rng, shape):
        """inv[order] = arange(n) for both probe views, int32, one tensor
        a view and device, the one the plan carries."""
        b, a = SHAPES[shape](rng)
        tb, ta = TorchTable(b), TorchTable(a)
        tplan = tmc.plan_verb_ranks(tb, ta, COLS, COLS, want4=True, device="cpu")
        n = a.num_rows
        for col, inv in ((2, tplan.inv_qe), (1, tplan.inv_qs)):
            order = ta.sorted_interval_order(0, col, "cpu").numpy()
            assert inv.dtype == torch.int32 and inv.shape == (n,)
            np.testing.assert_array_equal(inv.numpy()[order], np.arange(n))
            assert ta.sorted_interval_inverse(0, col, "cpu") is inv
            other = ta.sorted_interval_inverse(0, col, torch.device("cpu", 0))
            assert other is not inv and torch.equal(other, inv)
            if shape in ("identity_orders", "reverse_orders"):
                step = 1 if shape == "identity_orders" else -1
                np.testing.assert_array_equal(inv.numpy(), np.arange(n)[::step])

    def test_want4_false_gives_the_probe_count_plan(self, rng):
        b, a = _tables(rng, 600, 400, lkeys=4, rkeys=6, neg=True)
        jplan, tplan, n = _plans(b, a, want4=False)
        assert isinstance(tplan, tmc.ProbeCountPlan)
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        np.testing.assert_array_equal(tmc.merge_probe_count_passes(tplan).numpy(), want)

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_probe_counts_equal_jax(self, rng, shape):
        """The want4=False plan: merge_probe_count_passes (ranks in view
        order, then unpermute_counts' plain version) and its plain twin
        against the JAX merge_probe_count_passes, through the probe's
        cached inverse orders."""
        b, a = SHAPES[shape](rng)
        (jb, ja), (tb, ta) = _pair(b, a)
        jplan = jmc.plan_verb_ranks(jb, ja, COLS, COLS, want4=False)
        tplan = tmc.plan_verb_ranks(tb, ta, COLS, COLS, want4=False, device="cpu")
        n = a.num_rows
        assert tplan.inv_qe is ta.sorted_interval_inverse(0, 2, "cpu")
        assert tplan.inv_qs is ta.sorted_interval_inverse(0, 1, "cpu")
        want = np.asarray(jmc.merge_probe_count_passes(*jplan))[:n]
        got = tmc.merge_probe_count_passes(tplan)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmc.merge_probe_count_passes_plain(tplan).numpy(), want)

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


def _ranks_and_inverses(rng, n):
    ranks = torch.from_numpy(rng.integers(0, 2**31 - 1, (4, n)).astype(np.int32))
    inv_e, inv_s = (torch.from_numpy(rng.permutation(n).astype(np.int32)) for _ in range(2))
    return ranks, inv_e, inv_s


class TestUnpermuteRanks:
    @pytest.mark.parametrize("n", [1, 2, 257, 5000])
    def test_equals_row_by_row(self, rng, n):
        ranks, inv_e, inv_s = _ranks_and_inverses(rng, n)
        got = tmc.unpermute_ranks(ranks, inv_e, inv_s)
        r, ie, is_ = ranks.numpy(), inv_e.numpy(), inv_s.numpy()
        want = np.stack([r[0, ie], r[1, is_], r[2, ie], r[3, is_]])
        assert got.dtype == torch.int32 and got.shape == (4, n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tmc.unpermute_ranks_plain(ranks, inv_e, inv_s).numpy(), want)

    @pytest.mark.parametrize("bad", ["ranks_shape", "ranks_dtype", "ranks_strided",
                                     "inv_length", "inv_dtype"])
    def test_rejects(self, rng, bad):
        ranks, inv_e, inv_s = _ranks_and_inverses(rng, 64)
        if bad == "ranks_shape":
            ranks = ranks.reshape(2, 128)
        elif bad == "ranks_dtype":
            ranks = ranks.to(torch.int64)
        elif bad == "ranks_strided":
            ranks = ranks.t().contiguous().t()
        elif bad == "inv_length":
            inv_s = inv_s[:-1]
        else:
            inv_e = inv_e.to(torch.int64)
        with pytest.raises((TypeError, ValueError)):
            tmc.unpermute_ranks(ranks, inv_e, inv_s)


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
    with metrics.recording() as rec:
        got = tmc.merge_verb_rank4(plan)
    torch.cuda.synchronize()
    launches = rec.counts()
    assert [launches[f"launch.{k}"] for k in ("merge_path", "pack_view", "unpermute_ranks")] \
        == [1, 4, 1]
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(tmc.merge_verb_rank4_plain(plan).cpu().numpy(), want.numpy())
    # the un-permute kernel alone against its plain version
    ranks, inv_e, inv_s = (t.to(cuda_device) for t in _ranks_and_inverses(rng, 70_001))
    got = tmc.unpermute_ranks(ranks, inv_e, inv_s)
    torch.cuda.synchronize()
    assert torch.equal(got, tmc.unpermute_ranks_plain(ranks, inv_e, inv_s))
