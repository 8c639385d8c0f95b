"""Port parity across OS processes: sequila_tpu_torch.parallel.multihost_dryrun
(2 processes x 4 host devices joined over Gloo) against the JAX package
run in this process on the conftest's 8-device mesh, on the JAX tool's
seeds.

The dry run's workers hold every count, per-probe count and pair set to
the brute-force oracle themselves; here their JSON must equal the JAX
package's results exactly (the per-probe counts and the sorted pair sets
by sha256 of their int64 bytes).  The other cases run two ranks in
subprocesses: ``initialize`` is idempotent, ``local_host_info`` has the
JAX function's keys, the engine's mesh records each shard's owner, and a
rank that raises inside a shard program makes the run fail without
hanging.  Every rendezvous is a file under the test's tmp_path, never a
fixed port (tests/test_multihost.py holds one), and every subprocess has
its own timeout."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import sequila_tpu.parallel.distributed as jdist
import sequila_tpu.parallel.partitioned_join as jpj
import sequila_tpu.parallel.shuffle as jsh
import sequila_tpu.parallel.skew as jsk
from sequila_tpu_torch.parallel import multihost_dryrun as dry

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PROCS, LOCAL = 2, 4
TIMEOUT_S = 120


def _env(**extra) -> dict:
    """The children's environment: an explicit host device count (the
    conftest's 8 would leak into them otherwise) and two threads a rank."""
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={LOCAL}"
    return env


def _dryrun(tmp_path, **env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "sequila_tpu_torch.parallel.multihost_dryrun",
         "--procs", str(PROCS), "--local-devices", str(LOCAL), "--device", "cpu",
         "--init-method", f"file://{tmp_path / 'rendezvous'}", "--timeout", str(TIMEOUT_S)],
        cwd=ROOT, env=_env(**env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _communicate(proc) -> str:
    try:
        return proc.communicate(timeout=TIMEOUT_S)[0]
    finally:
        proc.kill()


def _jax_results() -> dict:
    """The JAX package's results on the dry run's inputs, over the
    conftest's 8 devices as a (2, 4) mesh."""
    mesh = Mesh(np.array(jax.devices()[: PROCS * LOCAL]).reshape(PROCS, LOCAL), ("part", "probe"))
    out = {}
    for label, cols in dry.datasets().items():
        out[label] = {
            "partitioned": jpj.partitioned_count(mesh, *cols),
            "collect_left": jpj.collect_left_count(mesh, *cols),
            "shuffle": jsh.all_to_all_partitioned_count(mesh, *cols),
            "skew": jsk.skew_partitioned_count_mesh(mesh, *cols),
            "probe_counts": dry.digest(jpj.partitioned_probe_counts(mesh, *cols)),
            "pair_set": dry.pair_digest(*jpj.partitioned_pairs(mesh, *cols)),
            "shuffle_pair_set": dry.pair_digest(*jsh.all_to_all_partitioned_pairs(mesh, *cols)),
        }
    return out


def test_dryrun_two_processes_equals_jax(tmp_path):
    proc = _dryrun(tmp_path)  # the workers run while JAX computes here
    try:
        want = _jax_results()
    finally:
        out = _communicate(proc)
    assert proc.returncode == 0, out[-4000:]
    lines = out.strip().splitlines()
    assert lines[-1].startswith("MULTIHOST PASSED: 2 ranks agree"), out[-4000:]
    got = json.loads(lines[-2])
    assert got["mesh"] == {"part": PROCS, "probe": LOCAL}
    assert got["owners"] == [[0] * LOCAL, [1] * LOCAL]
    for label, results in want.items():
        assert {k: got[label][k] for k in results} == results, label
        assert got[label]["rows"] == results["partitioned"]
    assert got["sql_partitioned"]["engine_mesh"] == {"part": PROCS, "probe": LOCAL}


# Two ranks of a small program each; the program prints one JSON line.
RANK_PROGRAMS = {
    "initialize_idempotent": """
        distributed.initialize(INIT, 2, RANK, device="cpu")
        distributed.initialize(INIT, 2, RANK, device="cpu")
        try:
            distributed.initialize(INIT, 2, 1 - RANK, device="cpu")
            other = "returned"
        except RuntimeError:
            other = "raised"
        out = {"world": list(distributed.world()), "other_rank": other,
               "sum": distributed.all_reduce_sum(RANK + 1)}
    """,
    "local_host_info": """
        distributed.initialize(INIT, 2, RANK, device="cpu")
        out = distributed.local_host_info("cpu")
    """,
    "mesh_owners": """
        distributed.initialize(INIT, 2, RANK, device="cpu")
        from sequila_tpu_torch.parallel import engine
        full = engine.get_engine_mesh(8, "cpu")
        out = {"full": [full.shape, full.owners.tolist(),
                        [[full.is_local(p, q) for q in range(4)] for p in range(2)]],
               "half": engine.get_engine_mesh(4, "cpu").owners.tolist(),
               "flat": engine.get_flat_mesh(full).owners.tolist()}
    """,
}


def _run_ranks(tmp_path, body: str) -> list[dict]:
    code = "\n".join([
        "import json, sys",
        "from sequila_tpu_torch.parallel import distributed",
        "RANK, INIT = int(sys.argv[1]), sys.argv[2]",
        textwrap.dedent(body),
        "print(json.dumps(out))",
        "distributed.shutdown()",
    ])
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [_communicate(p) for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


@pytest.mark.parametrize("case", [*RANK_PROGRAMS, "rank_fault"])
def test_two_ranks(tmp_path, case):
    if case == "rank_fault":
        # rank 1 raises in its first shard program: both ranks raise, the
        # parent fails, and nothing waits for the collective timeout
        proc = _dryrun(tmp_path, **{dry.FAULT_ENV: "1"})
        out = _communicate(proc)
        assert proc.returncode != 0, out[-4000:]
        assert out.strip().splitlines()[-1].startswith("MULTIHOST FAILED"), out[-4000:]
        assert "fault injected on rank 1" in out, out[-4000:]
        assert "peer rank(s) failed" in out, out[-4000:]
        assert "killed" not in out, out[-4000:]
        return
    got = _run_ranks(tmp_path, RANK_PROGRAMS[case])
    if case == "initialize_idempotent":
        assert got == [{"world": [r, 2], "other_rank": "raised", "sum": 3} for r in range(2)]
    elif case == "local_host_info":
        assert all(set(g) == set(jdist.local_host_info()) for g in got)
        assert got == [{"process_id": r, "num_processes": 2, "local_devices": ["cpu"] * LOCAL,
                        "global_devices": 2 * LOCAL} for r in range(2)]
    else:
        owners = [[0] * 4, [1] * 4]
        for r, g in enumerate(got):
            assert g["full"] == [{"part": 2, "probe": 4}, owners,
                                 [[o == r for o in row] for row in owners]]
            # four of the eight devices: rank 0's, in a (2, 2) mesh
            assert g["half"] == [[0, 0], [0, 0]]
            assert g["flat"] == [[o] for row in owners for o in row]


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_dryrun_on_cards_equals_jax(tmp_path, cards, backend):
    """The dry run on the cards: two ranks sharing card 0 over Gloo, or one
    rank a card over NCCL, each rank's shards on its card; the results
    equal the JAX package's on the CPU mesh."""
    procs = 2 if backend == "gloo" else cards
    proc = subprocess.Popen(
        [sys.executable, "-m", "sequila_tpu_torch.parallel.multihost_dryrun",
         "--procs", str(procs), "--device", "cuda", "--backend", backend,
         "--init-method", f"file://{tmp_path / 'rendezvous'}", "--timeout", str(TIMEOUT_S)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        want = _jax_results()
    finally:
        out = _communicate(proc)
    assert proc.returncode == 0, out[-4000:]
    lines = out.strip().splitlines()
    assert lines[-1].startswith(f"MULTIHOST PASSED: {procs} ranks agree"), out[-4000:]
    got = json.loads(lines[-2])
    assert got["mesh"] == {"part": procs, "probe": 1}
    assert got["owners"] == [[r] for r in range(procs)]
    for label, results in want.items():
        assert {k: got[label][k] for k in results} == results, label
