"""The on-card checks (tools/cuda_sweep.py, tools/cuda_fuzz.py,
tools/cuda_sanitize.py) run on the CPU at small sizes: the device routes
(the kernels' plain versions) against the host route and the oracle, and
the guard bands and the sanitizer log parsing on their own.  On the card
chip_smoke.py phases 9-11 run them at full size."""

import numpy as np
import pytest
import torch

from tools import cuda_fuzz, cuda_sanitize, cuda_sweep


def test_sweep_device_routes_equal_the_host_route(monkeypatch):
    monkeypatch.setattr(cuda_sweep, "MAT_PAIR", ((300, 13), (3000, 14)))
    monkeypatch.setattr(cuda_sweep, "MAT_EXPECTED", None)  # no count to hold it to
    lines = []
    sw = cuda_sweep.sweep(report=lines.append, device="cpu")
    assert len(sw.checks) == 20 and not sw.failed(), lines
    assert all(line.startswith("OK") for line in lines)


@pytest.mark.parametrize("seed", [1, 2])
def test_fuzz_public_paths_equal_the_oracle(monkeypatch, seed):
    monkeypatch.setattr(cuda_fuzz, "MAX_ROWS", 6000)
    monkeypatch.setattr(cuda_fuzz, "EDGES", tuple(min(e, 6000) for e in cuda_fuzz.EDGES))
    stats = cuda_fuzz.fuzz(seed, trials=8, rounds=2, device="cpu", kernel_rows=6000,
                           report=lambda line: None)
    assert len(stats["sizes"]) == 8
    assert {"merge", "stream", "level"} <= stats["count_routes"]
    assert not any(stats["err"].values())


def test_fuzz_failure_names_the_trial(monkeypatch):
    from sequila_tpu_torch.ops import oracle

    monkeypatch.setattr(cuda_fuzz, "MAX_ROWS", 500)
    monkeypatch.setattr(cuda_fuzz, "EDGES", (1, 2, 300))
    monkeypatch.setattr(oracle, "oracle_counts",
                        lambda *cols: np.ones(len(cols[3]), np.int32) * 10**6)
    with pytest.raises(cuda_fuzz.FuzzFailure,
                       match=r"trial 0 \(replay: --seed 5 --trials 1 --rounds 0\)"):
        cuda_fuzz.fuzz(5, trials=1, rounds=0, device="cpu", report=lambda line: None)


def test_guard_bands_hold_and_catch_a_write(monkeypatch):
    monkeypatch.setattr(cuda_sanitize, "GUARD_ROUNDS", ((1, 5000),))
    res = cuda_sanitize.guard_rounds(torch.device("cpu"), lambda line: None)
    assert res == {"rounds": 2, "faults": []}
    guards = cuda_sanitize.Guards(np.random.default_rng(0))
    t = guards.place(torch.arange(10, dtype=torch.int32).view(2, 5))
    assert t.shape == (2, 5) and t.flatten().tolist() == list(range(10))
    assert guards.check() == []
    buf = guards.held[0][0]
    buf[cuda_sanitize.GUARD + 10] += 1
    assert guards.check() == ["tensor 0 (10 elements): the band after it changed"]


def test_sanitizer_logs_are_read():
    log = (
        "========= COMPUTE-SANITIZER\n"
        "========= Invalid __global__ read of size 4 bytes\n"
        "=========     at merge_path_kernel(Params)+0x1a0\n"
        "========= \n"
        "========= Invalid __global__ write of size 8 bytes\n"
        "=========     at void at::native::vectorized_elementwise_kernel<4>(int)+0x40\n"
        "========= \n"
        "========= ERROR SUMMARY: 2 errors\n"
    )
    assert cuda_sanitize._errors(log) == 2
    assert cuda_sanitize._blame(log) == (1, 1)
    assert cuda_sanitize._errors("========= RACECHECK SUMMARY: 0 hazards displayed") == 0
    assert cuda_sanitize._errors("no summary") is None
