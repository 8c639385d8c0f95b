"""Port parity: the genomic verbs through SQL.

queries/q2-genomic-verbs.sql through ``python -m sequila_tpu_torch.cli
--device cpu`` and ``python -m sequila_tpu.cli`` prints the same tables
once the query times are removed, and so does each of its statements
through the two sessions; every SQL block of docs/COOKBOOK.md gives
through the port's ``cpu`` session what the JAX session gives; every
genomic table function (the binder's _genomic_table_function) equals the
JAX session's on the fixtures, on the host and device routes, and the
verbs that reach a kernel run on the session's device.  Both packages
load their native library in-process (tests/torch_native.py).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sequila_tpu.session import SessionContext as JaxSession
from sequila_tpu_torch import dataframe as tdf
from sequila_tpu_torch.session import SessionContext as TorchSession
from torch_native import jax_native_cache, jax_native_loaded  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
Q2 = ROOT / "queries" / "q2-genomic-verbs.sql"
COOKBOOK = ROOT / "docs" / "COOKBOOK.md"
TIMING = re.compile(r"Query took [0-9.]+ seconds\.")
# the JAX session's closest goes through its native library's available()
pytestmark = pytest.mark.usefixtures("jax_native_loaded")


def _cli(module: str, *args: str) -> str:
    res = subprocess.run(
        [sys.executable, "-m", module, *args, "--file", str(Q2)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    return TIMING.sub("", res.stdout)


def test_q2_through_both_clis():
    got = _cli("sequila_tpu_torch.cli", "--device", "cpu")
    assert got == _cli("sequila_tpu.cli")
    assert "jaccard" in got and "n_intersections" in got


def _statements(text: str) -> list[str]:
    body = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("--"))
    return [s.strip() for s in body.split(";") if s.strip()]


def _sessions():
    return TorchSession(device="cpu"), JaxSession()


def _same(got, want):
    if want is None:
        assert got is None
        return
    assert got.column_names == want.column_names
    assert got.to_pylist() == want.to_pylist()


def test_q2_statements_equal_jax():
    (tctx, jctx), stmts = _sessions(), _statements(Q2.read_text())
    assert len(stmts) == 5
    for stmt in stmts:
        _same(tctx.sql(stmt), jctx.sql(stmt))


def _cookbook_blocks() -> list[str]:
    return re.findall(r"```sql\n(.*?)```", COOKBOOK.read_text(), re.S)


@pytest.fixture(scope="module")
def cookbook_sessions():
    setup = _cookbook_blocks()[0]
    tctx, jctx = _sessions()
    tctx.sql(setup)
    jctx.sql(setup)
    return tctx, jctx


@pytest.mark.parametrize("block", range(1, len(_cookbook_blocks())))
def test_cookbook_block_equals_jax(cookbook_sessions, block):
    tctx, jctx = cookbook_sessions
    sql = _cookbook_blocks()[block]
    _same(tctx.sql(sql), jctx.sql(sql))


TABLE_FUNCTIONS = [
    "merge('reads')", "merge('reads', 500)", "cluster('reads', 100)", "depth('targets')",
    "overlap('reads', 'targets')", "count_overlaps('reads', 'targets')",
    "nearest('reads', 'targets')", "closest('reads', 'targets')",
    "closest('reads', 'targets', 3)", "coverage('reads', 'targets')",
    "coverage('targets', 'reads')", "subtract('reads', 'targets')",
    "window('reads', 'targets', 2000)", "reldist('reads', 'targets')",
    "jaccard('reads', 'targets')",
]


@pytest.mark.parametrize("threshold", [None, "0"])
@pytest.mark.parametrize("tf", TABLE_FUNCTIONS)
def test_table_function_equals_jax(cookbook_sessions, monkeypatch, tf, threshold):
    tctx, jctx = cookbook_sessions
    monkeypatch.delenv("SEQUILA_HOST_THRESHOLD", raising=False)
    sql = f"SELECT * FROM {tf}"
    want = jctx.sql(sql)
    if threshold is not None:
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", threshold)
    got = tctx.sql(sql)
    assert got.column_names == want.column_names
    assert sorted(map(repr, got.to_pylist())) == sorted(map(repr, want.to_pylist()))


@pytest.mark.parametrize("verb", ["overlap", "count_overlaps", "nearest", "closest",
                                  "coverage", "window", "jaccard"])
def test_kernel_verbs_take_the_session_device(cookbook_sessions, monkeypatch, verb):
    seen = []
    fn = getattr(tdf, verb)
    monkeypatch.setattr(tdf, verb, lambda *a, **kw: seen.append(kw.get("device")) or fn(*a, **kw))
    tctx, _ = cookbook_sessions
    args = "'reads', 'targets', 100" if verb == "window" else "'reads', 'targets'"
    tctx.sql(f"SELECT * FROM {verb}({args})")
    assert seen == [tctx.device]
