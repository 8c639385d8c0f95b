"""Port parity end to end: SQL through sequila_tpu_torch vs sequila_tpu.

The same arrow tables are registered in a JAX SessionContext and in the
port's SessionContext(device="cpu"); count(*) overlap queries compare
exactly, on the host route (default threshold) and on the merge route
(SEQUILA_HOST_THRESHOLD=0, the kernels' plain versions on the CPU).  A
subprocess proves the port runs the q1 fixture without importing JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench
from sequila_tpu.session import SessionContext as JaxSession
from sequila_tpu_torch import bench_data
from sequila_tpu_torch.session import SessionContext as TorchSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrow(rng, n, nkeys, span=20_000):
    s = rng.integers(0, span, n).astype(np.int64)
    return pa.table({
        "contig": [f"chr{int(k)}" for k in rng.integers(0, nkeys, n)],
        "pos_start": s,
        "pos_end": s + rng.integers(1, 900, n),
    })


QUERIES = {
    "overlap": "SELECT count(1) FROM a JOIN b ON a.contig = b.contig "
               "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end",
    "strict": "SELECT count(*) FROM a JOIN b ON a.contig = b.contig "
              "AND a.pos_end > b.pos_start AND a.pos_start < b.pos_end",
    "swapped": "SELECT count(*) FROM b JOIN a ON a.contig = b.contig "
               "AND b.pos_start <= a.pos_end AND b.pos_end >= a.pos_start",
    "filtered": "SELECT count(1) FROM a JOIN b ON a.contig = b.contig "
                "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end "
                "WHERE a.contig <> 'chr2' AND b.pos_start > 500",
}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(7)
    a, b = _arrow(rng, 3000, 4), _arrow(rng, 4000, 5)
    jax_ctx, torch_ctx = JaxSession(), TorchSession(device="cpu")
    for name, t in (("a", a), ("b", b)):
        jax_ctx.register_table(name, t)
        torch_ctx.register_table(name, t)
    return jax_ctx, torch_ctx


def _count(ctx, q) -> int:
    return int(ctx.sql(q).column_np(0)[0])


@pytest.mark.parametrize("threshold", ["0", None], ids=["merge_route", "host_route"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_sql_count_matches_jax(sessions, monkeypatch, threshold, query):
    if threshold is None:
        monkeypatch.delenv("SEQUILA_HOST_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
    jax_ctx, torch_ctx = sessions
    want = _count(jax_ctx, QUERIES[query])
    assert want > 0
    assert _count(torch_ctx, QUERIES[query]) == want


def test_explain_matches_jax(sessions):
    jax_ctx, torch_ctx = sessions
    q = "EXPLAIN " + QUERIES["overlap"]
    assert torch_ctx.sql(q).to_pylist() == jax_ctx.sql(q).to_pylist()


def test_chr1_pair_count():
    """The synthetic databio chr1 pair through the port's merge route (the
    kernels' plain versions on the CPU)."""
    ctx = TorchSession(device="cpu")
    ctx.register_table("s1", pa.table(bench_data.gen_chain_table(bench_data.N_LEFT, seed=1)))
    ctx.register_table("s2", pa.table(bench_data.gen_chain_table(bench_data.N_RIGHT, seed=2)))
    assert _count(ctx, bench_data.QUERY) == 153_690_858


def test_bench_data_matches_bench():
    for got, want in (
        (bench_data.gen_chain_table(5000, 3), bench.gen_chain_table(5000, 3)),
        (bench_data.gen_genome_table(5000, 4), bench.gen_genome_table(5000, 4)),
    ):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert bench_data.QUERY == bench.QUERY
    assert (bench_data.N_LEFT, bench_data.N_RIGHT) == (bench.N_LEFT, bench.N_RIGHT)


def test_profile_writes_a_trace(sessions, monkeypatch, tmp_path):
    monkeypatch.setenv("SEQUILA_PROFILE", str(tmp_path))
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    _, torch_ctx = sessions
    assert _count(torch_ctx, QUERIES["overlap"]) > 0
    assert any(p.suffix == ".json" for p in tmp_path.iterdir())


def test_cuda_session_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSession()


_NO_JAX = """
import importlib, pkgutil, sys
import sequila_tpu_torch
from sequila_tpu_torch import cli
for m in pkgutil.walk_packages(sequila_tpu_torch.__path__, "sequila_tpu_torch."):
    importlib.import_module(m.name)
rc = cli.main(sys.argv[1:])
assert "jax" not in sys.modules, "the port imported jax"
assert not any(n == "sequila_tpu" or n.startswith("sequila_tpu.") for n in sys.modules)
sys.exit(rc)
"""


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )


def test_q1_subprocess_imports_no_jax():
    res = _run_cli("--device", "cpu", "--file", "queries/q1-coitrees.sql")
    assert res.returncode == 0, res.stderr
    assert "| 16 " in res.stdout


def test_cli_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_cli("--file", "queries/q1-coitrees.sql")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "| 16 " not in res.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sql_count_on_card_matches_jax(sessions, monkeypatch, cuda_device):
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    jax_ctx, cpu_ctx = sessions
    ctx = TorchSession(device=cuda_device)
    for name in ("a", "b"):
        ctx.register_table(name, cpu_ctx.table(name))
    before = mc.merge_rank_sorted.launches
    for q in QUERIES.values():
        assert _count(ctx, q) == _count(jax_ctx, q)
    assert mc.merge_rank_sorted.launches > before
