"""Port parity: sequila_tpu_torch/ops/cuda/stream_rank.py (B2) vs
sequila_tpu/ops/pallas/stream_rank.py.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode on the CPU) and through the port's (the kernel's plain
PyTorch version on CPU tensors): duplicate runs that cross chunk
boundaries, empty sides, query counts that are not a multiple of the
block, PAD tails, and real table pairs with the planner's ±1 deltas.
Every comparison is exact.  The ``cuda`` tests hold the kernel against
its plain version on the card.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from sequila_tpu.ops.pallas import stream_rank as jsr
from sequila_tpu_torch.ops.cuda import stream_rank as tsr
from sequila_tpu_torch.utils import metrics

PAD = 2**31 - 1


def _t(a, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sorted_build(rng, n_pad, n_real, nkeys=3):
    """Sorted (key, value) build of n_pad rows: long duplicate runs that
    cross chunk boundaries, then a (PAD, PAD) tail."""
    k = np.sort(rng.integers(-1, nkeys, n_real)).astype(np.int32)
    v = rng.integers(-50, 50, n_real).astype(np.int32)
    v[: n_real // 2] = 7  # one big tie run, across chunks when sorted
    order = np.lexsort((v, k))
    ka = np.full(n_pad, PAD, np.int32)
    va = np.full(n_pad, PAD, np.int32)
    ka[:n_real], va[:n_real] = k[order], v[order]
    return ka, va


def _sorted_queries(rng, m, m_real, nkeys=4):
    k = rng.integers(-2, nkeys, m_real).astype(np.int32)
    v = rng.integers(-60, 60, m_real).astype(np.int32)
    v[::5] = 7
    order = np.lexsort((v, k))
    qk = np.full(m, PAD, np.int32)
    qv = np.full(m, PAD - 1, np.int32)  # the probe PAD convention
    qk[:m_real], qv[:m_real] = k[order], v[order]
    return qk, qv


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("n_real,m_real", [(5000, 1200), (2048, 512), (1, 300), (4096, 0)])
def test_stream_rank_sorted_matches_jax(rng, strict, n_real, m_real):
    n_pad = max(-(-n_real // tsr.CHUNK), 1) * tsr.CHUNK
    m = max(-(-m_real // tsr.BLOCK), 1) * tsr.BLOCK
    ak, av = _sorted_build(rng, n_pad, n_real)
    qk, qv = _sorted_queries(rng, m, m_real)
    c_lo, n_ch = tsr.host_windows(ak, av, qk, qv)
    for got, want in zip((c_lo, n_ch), jsr.host_windows(ak, av, qk, qv)):
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jsr._stream_rank_sorted(
        jnp.stack([jnp.asarray(ak), jnp.asarray(av)]), jnp.asarray(c_lo),
        jnp.asarray(n_ch), jnp.asarray(qk), jnp.asarray(qv), strict=strict,
    ))
    a2 = _t(np.stack([ak, av]))
    args = (a2, _t(c_lo), _t(n_ch), _t(qk), _t(qv))
    got = tsr.stream_rank_sorted(*args, strict=strict)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    total = tsr.stream_rank_sorted(*args, strict=strict, reduce=True)
    assert total.dtype == torch.int64 and int(total) == int(want.astype(np.int64).sum())
    # the windows are exact: the same ranks as one global rank
    comp_a = (ak.astype(np.int64) << 32) | (av.astype(np.int64) + 2**31)
    comp_q = (qk.astype(np.int64) << 32) | (qv.astype(np.int64) + 2**31)
    np.testing.assert_array_equal(
        want, np.searchsorted(comp_a, comp_q, side="left" if strict else "right")
    )


def test_plain_version_keeps_the_window_contract(rng):
    """With windows too narrow for the queries, the TPU kernel returns
    ``c_lo * CHUNK + #{window rows before q}`` — and so does the plain
    version (the window clamp), not the global rank."""
    ak, av = _sorted_build(rng, 3 * tsr.CHUNK, 3 * tsr.CHUNK - 100)
    qk, qv = _sorted_queries(rng, 512, 512)
    c_lo = np.array([1, 0], np.int32)
    n_ch = np.array([1, 0], np.int32)
    for strict in (True, False):
        want = np.asarray(jsr._stream_rank_sorted(
            jnp.stack([jnp.asarray(ak), jnp.asarray(av)]), jnp.asarray(c_lo),
            jnp.asarray(n_ch), jnp.asarray(qk), jnp.asarray(qv), strict=strict,
        ))
        got = tsr.stream_rank_sorted(_t(np.stack([ak, av])), _t(c_lo), _t(n_ch),
                                     _t(qk), _t(qv), strict=strict)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,m", [(5000, 1300), (2 * 2048, 700), (3, 257)])
def test_rank_lex_stream_matches_jax(rng, side, n, m):
    bk = rng.integers(0, 4, n).astype(np.int32)
    bv = rng.integers(-9000, 9000, n).astype(np.int32)
    bv[: n // 2] = 11  # duplicate run across chunk boundaries
    qk = rng.integers(0, 5, m).astype(np.int32)
    qv = rng.integers(-9500, 9500, m).astype(np.int32)
    qv[::3] = 11
    want = np.asarray(jsr.rank_lex_stream(
        (jnp.asarray(bk), jnp.asarray(bv)), (jnp.asarray(qk), jnp.asarray(qv)), side
    ))
    got = tsr.rank_lex_stream((_t(bk), _t(bv)), (_t(qk), _t(qv)), side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rank_lex_stream_empty_sides():
    e = torch.empty(0, dtype=torch.int32)
    b = torch.arange(10, dtype=torch.int32)
    assert tsr.rank_lex_stream((e, e), (b, b)).tolist() == [0] * 10
    assert tsr.rank_lex_stream((b, b), (e, e)).shape == (0,)


def _table_pair(rng, n, m):
    def t(k, nkeys):
        s = rng.integers(0, 8000, k).astype(np.int64)
        return pa.table({
            "contig": [f"c{int(x)}" for x in rng.integers(0, nkeys, k)],
            "s": s,
            "e": s + rng.integers(2, 3000, k),
        })

    return t(n, 5), t(m, 6)


@pytest.mark.parametrize("deltas", [(0, 0, 0, 0), (0, -1, 0, -1), (1, 0, 0, -1)])
def test_stream_count_passes_matches_jax_partials(rng, deltas):
    """The port's int64 two-pass count over a real plan (remapped,
    delta-adjusted cached views, host windows) == the sum of the JAX
    package's 64-bucket partials over the same arrays == brute force."""
    from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec
    from sequila_tpu_torch.exec.plan import ScanExec
    from sequila_tpu_torch.models.table import Table
    from sequila_tpu_torch.planner.expr import BinaryExpr, Column, Literal
    from sequila_tpu_torch.planner.intervals import ColInterval, ColIntervals

    def bound(idx, d):
        col = Column("x", idx)
        return col if d == 0 else BinaryExpr(col, "+" if d > 0 else "-", Literal(abs(d)))

    left, right = _table_pair(rng, 900, 1300)
    lt, rt = Table(left), Table(right)
    d_bs, d_be, d_qs, d_qe = deltas
    join = IntervalJoinExec(
        ScanExec("l", lt), ScanExec("r", rt),
        on=[(Column("contig", 0), Column("contig", 0))], filter_=None,
        intervals=ColIntervals(ColInterval(bound(1, d_bs), bound(2, d_be)),
                               ColInterval(bound(1, d_qs), bound(2, d_qe))),
        device="cpu",
    )
    plan = join._stream_count_plan(lt, rt, *join._sorted_count_inputs(lt, rt))
    kw = dict(d_bs=d_bs, d_be=d_be, d_qs=d_qs, d_qe=d_qe)
    got = tsr.stream_count_passes(*plan, **kw)
    assert got.dtype == torch.int64
    want = int(np.asarray(jsr.stream_count_partials(
        *(jnp.asarray(x.numpy()) for x in plan), **kw
    )).astype(np.int64).sum())
    assert int(got) == want
    lk, rk = left["contig"].to_numpy(), right["contig"].to_numpy()
    ls, le = left["s"].to_numpy() + d_bs, left["e"].to_numpy() + d_be
    rs, re = right["s"].to_numpy() + d_qs, right["e"].to_numpy() + d_qe
    brute = sum(int(((lk == rk[i]) & (ls <= re[i]) & (le >= rs[i])).sum())
                for i in range(len(rk)))
    assert want == brute


class TestWrapperContract:
    def test_rejects_bad_shapes(self):
        a2 = torch.zeros((2, 2048), dtype=torch.int32)
        q = torch.zeros(300, dtype=torch.int32)
        w = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple of 2048"):
            tsr.stream_rank_sorted(a2[:, :100].contiguous(), w, w, q, q, strict=True)
        with pytest.raises(ValueError, match="windows"):
            tsr.stream_rank_sorted(a2, w[:1], w[:1], q, q, strict=True)
        with pytest.raises(TypeError):
            tsr.stream_rank_sorted(a2.to(torch.int64), w, w, q, q, strict=True)
        with pytest.raises(ValueError, match="different devices"):
            tsr.stream_rank_sorted(a2, w, w, q, q.to("meta"), strict=True)

    def test_cpu_tensors_launch_no_kernel(self, rng):
        with metrics.recording() as rec:
            tsr.rank_lex_stream((_t(np.arange(5000, dtype=np.int32)),) * 2,
                                (_t(np.arange(300, dtype=np.int32)),) * 2)
        assert rec.counts()["launch.pair_merge"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("strict", [True, False])
    def test_stream_rank_kernel_equals_plain(self, rng, cuda_device, strict):
        n_real, m_real = 300_001, 70_003
        n_pad = -(-n_real // tsr.CHUNK) * tsr.CHUNK
        m = -(-m_real // tsr.BLOCK) * tsr.BLOCK
        ak, av = _sorted_build(rng, n_pad, n_real, nkeys=40)
        qk, qv = _sorted_queries(rng, m, m_real, nkeys=41)
        c_lo, n_ch = tsr.host_windows(ak, av, qk, qv)
        args = [_t(x, cuda_device) for x in (np.stack([ak, av]), c_lo, n_ch, qk, qv)]
        with metrics.recording() as rec:
            got = tsr.stream_rank_sorted(*args, strict=strict)
            total = tsr.stream_rank_sorted(*args, strict=strict, reduce=True)
        torch.cuda.synchronize()
        assert rec.counts()["launch.pair_merge"] == 2
        want = tsr.stream_rank_plain(*args, strict=strict)
        assert torch.equal(got, want)
        assert int(total) == int(want.to(torch.int64).sum())

    def test_stream_count_passes_is_one_launch(self, rng, cuda_device):
        """Both passes of a stream count(*) in one B2 launch, the same
        count as the plain version over the same plan on the CPU."""
        from sequila_tpu_torch.exec.joins.interval_join import IntervalJoinExec
        from sequila_tpu_torch.exec.plan import ScanExec
        from sequila_tpu_torch.models.table import Table
        from sequila_tpu_torch.planner.expr import BinaryExpr, Column, Literal
        from sequila_tpu_torch.planner.intervals import ColInterval, ColIntervals

        left, right = _table_pair(rng, 20_000, 30_000)
        lt, rt = Table(left), Table(right)
        end = BinaryExpr(Column("x", 2), "-", Literal(1))
        counts = []
        for device in ("cpu", cuda_device.type):
            join = IntervalJoinExec(
                ScanExec("l", lt), ScanExec("r", rt),
                on=[(Column("contig", 0), Column("contig", 0))], filter_=None,
                intervals=ColIntervals(ColInterval(Column("x", 1), end),
                                       ColInterval(Column("x", 1), Column("x", 2))),
                device=device,
            )
            plan = join._stream_count_plan(lt, rt, *join._sorted_count_inputs(lt, rt))
            with metrics.recording() as rec:
                counts.append(int(tsr.stream_count_passes(*plan, d_bs=0, d_be=-1, d_qs=0,
                                                          d_qe=0)))
            torch.cuda.synchronize()
            assert rec.counts()["launch.pair_merge"] == (device != "cpu")
        assert counts[0] == counts[1] > 0

    def test_rank_lex_stream_on_card(self, rng, cuda_device):
        bk = rng.integers(0, 30, 200_000).astype(np.int32)
        bv = rng.integers(-(10**6), 10**6, 200_000).astype(np.int32)
        qk = rng.integers(0, 31, 50_001).astype(np.int32)
        qv = rng.integers(-(10**6), 10**6, 50_001).astype(np.int32)
        for side in ("left", "right"):
            got = tsr.rank_lex_stream((_t(bk, cuda_device), _t(bv, cuda_device)),
                                      (_t(qk, cuda_device), _t(qv, cuda_device)), side)
            want = tsr.rank_lex_stream((_t(bk), _t(bv)), (_t(qk), _t(qv)), side)
            assert torch.equal(got.cpu(), want)
