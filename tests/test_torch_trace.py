"""The port's spans and counters (sequila_tpu_torch/utils/metrics.py).

On the CPU: nothing is recorded unless a recording() block or a
torch.profiler session is open; spans nest, across the worker thread of
the materializing join too; counters add up, into the records and into
the statement's metrics; the recorder's clock is the profiler's; a warm
count records the table views on its first query only; EXPLAIN ANALYZE,
``last_metrics`` and SEQUILA_PROFILE's Chrome trace show the program's
counters and spans.  The ``cuda`` test holds a span around a hand
kernel's launch and its synchronise to contain that kernel's interval on
the card's timeline, as the benchmark reads it.
"""

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu_torch.config import SequilaConfig
from sequila_tpu_torch.exec.context import ExecContext
from sequila_tpu_torch.session import SessionContext
from sequila_tpu_torch.utils import metrics

COUNT = ("SELECT count(*) FROM s2 b JOIN s1 a ON a.contig = b.contig "
         "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")
SELECT = ("SELECT * FROM s2 b JOIN s1 a ON a.contig = b.contig "
          "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end")


def _table(rng, n):
    s = rng.integers(0, 200_000, n)
    return pa.table({"contig": rng.choice(["chr1", "chr2", "chr3"], n),
                     "pos_start": s, "pos_end": s + rng.integers(0, 2_000, n)})


@pytest.fixture
def session(rng, monkeypatch):
    """A CPU session on the device route (the kernels' plain versions)."""
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    ctx = SessionContext(device="cpu")
    ctx.register_table("s1", _table(rng, 3_000))
    ctx.register_table("s2", _table(rng, 4_000))
    return ctx


def test_nothing_recorded_while_off(session):
    t0 = time.time_ns()
    assert not metrics.is_recording()
    session.sql(COUNT)
    with metrics.span("outer"):
        metrics.count("x", 3)
    got = metrics.events(t0)
    assert got.spans == [] and got.counts == []
    assert metrics.span("a") is metrics.span("b")  # the shared no-op


def test_recording_block(session):
    with metrics.recording() as rec:
        assert metrics.is_recording()
        session.sql(COUNT)
    assert not metrics.is_recording()
    names = [s.name for s in rec.events().spans]
    assert {"session.sql", "session.parse", "session.plan", "join.count"} <= set(names)
    with metrics.span("after"):
        pass
    assert "after" not in [s.name for s in rec.events().spans]


def test_spans_nest_under_one_root(session):
    with metrics.recording() as rec:
        session.sql(COUNT)
    spans = rec.events().spans
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "session.sql"
    for s in spans:
        assert s.root == root.id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    count = next(s for s in spans if s.name == "join.count")
    assert count.attrs == {"route": "merge"}
    assert by_id[count.parent].name == "session.sql"
    timer = next(s for s in spans if s.name == "join_time")
    assert timer.parent == count.id and timer.attrs["op"].startswith("IntervalJoinExec")


def test_worker_thread_spans_take_the_callers_parent(session, monkeypatch):
    """_device_pair_chunks produces its chunks on a worker thread: their
    spans nest under the span open where the chunks were asked for."""
    monkeypatch.setenv("SEQUILA_EMIT_BACKEND", "cosort")
    with metrics.recording() as rec:
        rows = session.sql(SELECT).num_rows
    assert rows > 0
    spans = rec.events().spans
    by_id = {s.id: s for s in spans}
    main = threading.get_native_id()
    pairs = [s for s in spans if s.name == "join.pairs"]
    assert pairs and all(s.thread != main for s in pairs)
    for s in pairs:
        parent = by_id[s.parent]
        assert parent.thread == main and parent.name == "join_time"
        assert s.root == parent.root == next(x.id for x in spans if x.name == "session.sql")
    assert any(s.name == "join.assemble" and s.thread == main for s in spans)


def test_counters_add_up():
    reg = metrics.MetricsRegistry()
    with metrics.recording() as rec, metrics.collecting(reg):
        for n in (1, 2, 3):
            metrics.count("things", n)
        reg.add("op", "output_rows", 5)
    assert rec.counts() == {"things": 6, "output_rows": 5}
    assert reg.counters[metrics.PROGRAM] == {"things": 6}
    assert reg.counters["op"] == {"output_rows": 5}
    metrics.count("things")  # no registry collecting, nothing recording
    assert reg.counters[metrics.PROGRAM]["things"] == 6


def test_profiler_session_records():
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.is_recording()
        with metrics.span("inside"):
            metrics.count("n", 2)
    with metrics.span("outside"):
        metrics.count("n", 1)
    got = metrics.events(t0)
    assert [s.name for s in got.spans] == ["inside"]
    assert [(c.name, c.n) for c in got.counts] == [("n", 2)]


def test_clock_is_the_profilers():
    """An aten::add run inside a span lies inside it on the profiler's
    own timestamps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(10_000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("around_add") as sp:
            x + x
    span = next(s for s in metrics.events(sp.start).spans if s.id == sp.id)
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add" and e.device_type() == DeviceType.CPU]
    assert adds
    for e in adds:
        assert span.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.end_ns


def test_warm_count_records_views_only_on_its_first_query(session):
    with metrics.recording() as first:
        a = session.sql(COUNT).to_pylist()
    views = [s for s in first.events().spans if s.name.startswith("table.")]
    assert {"table.dict_device", "table.column_device", "table.min_gap", "table.view_sort",
            "table.key_minmax"} <= {s.name for s in views}
    assert all(s.attrs["rows"] in (3_000, 4_000) for s in views)
    assert "join.plan" in {s.name for s in first.events().spans}
    with metrics.recording() as second:
        b = session.sql(COUNT).to_pylist()
    assert a == b
    names = {s.name for s in second.events().spans}
    assert not [n for n in names if n.startswith("table.")] and "join.plan" not in names


def test_timer_is_a_span_and_keeps_its_time():
    ctx = ExecContext(SequilaConfig(), collect_metrics=True)
    with metrics.recording() as rec:
        with ctx.timer("Op@1", "build_time", "join.plan"):
            time.sleep(0.002)
    (s,) = rec.events().spans
    assert (s.name, s.attrs) == ("join.plan", {"op": "Op@1"})
    assert ctx.metrics.times["Op@1"]["build_time"] >= 0.002


def test_verb_route_in_last_metrics_and_explain(session):
    with metrics.recording() as rec:
        session.sql("SELECT * FROM coverage('s2', 's1')")
    # the first query codes both key columns, narrows the int64 bounds the
    # views read by index on the device (the verb's by-name reads upload its
    # host narrowing) and builds both tables' two views
    assert session.last_metrics.counters[metrics.PROGRAM] == {
        "verb_route_merge": 1, "dict_device_builds": 2, "view_device_builds": 4,
        "i32_device_narrowings": 4}
    names = [s.name for s in rec.events().spans]
    assert {"verb.coverage", "verb.assemble"} <= set(names)
    assert rec.counts()["verb_route_merge"] == 1
    text = session.sql("EXPLAIN ANALYZE SELECT * FROM coverage('s2', 's1')").column_np(1)[0]
    assert text.splitlines()[-1] == "Program: metrics=[verb_route_merge=1]"


def test_copies_on_the_cpu_record_nothing():
    a = np.arange(10, dtype=np.int32)
    with metrics.recording() as rec:
        t = metrics.to_device(a, "cpu")
        back = metrics.to_host(t)
        one = metrics.to_host(t.sum())
    assert np.array_equal(back, a) and one == 45
    assert rec.events().spans == [] and rec.counts() == {}


def test_split_by_span():
    S = metrics.Span
    spans = [S("outer", 0, 100, None, 1, None, 1, 1),
             S("inner", 20, 40, 1, 1, None, 2, 1),
             S("late", 90, 130, None, 2, None, 3, 3)]
    idle = [(10, 30), (35, 95), (120, 150)]
    got = metrics.split_by_span(idle, spans)
    assert got == {"outer": 10 + 50, "inner": 10 + 5, "late": 5 + 10, None: 20}
    assert sum(got.values()) == sum(e - s for s, e in idle)


def test_profile_trace_holds_the_program(session, tmp_path, monkeypatch):
    monkeypatch.setenv("SEQUILA_PROFILE", str(tmp_path))
    session.sql(COUNT)
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program"]
    assert {"join.count", "join_time"} <= {e["name"] for e in ours if e["ph"] == "X"}
    assert "count_route_merge" in {e["name"] for e in ours if e["ph"] == "i"}
    add = [e for e in events if e.get("name") == "aten::add" or e.get("cat") == "cpu_op"]
    span = next(e for e in ours if e["name"] == "join.count")
    assert any(span["ts"] <= e["ts"] <= span["ts"] + span["dur"] for e in add)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_card(cuda_device):
    """A span around a pack_view launch and its synchronise holds the
    kernel's interval on the card's timeline, as the benchmark reads the
    profiler's trace (``benchmark.tracing.device_events``)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import tracing
    from sequila_tpu_torch.ops.cuda import merge_count as mc

    n = 1 << 22
    k = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    v = torch.arange(n, dtype=torch.int32, device=cuda_device)
    c_tab = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    mc.pack_view(k, v, c_tab, mc.BUILD_PAD)  # the build and a first launch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with metrics.span("around_launch") as sp:
            mc.pack_view(k, v, c_tab, mc.BUILD_PAD)
            torch.cuda.synchronize()
    span = next(s for s in metrics.events(sp.start).spans if s.id == sp.id)
    kernels = [e for e in tracing.device_events(prof) if "pack_view" in e[0]]
    assert len(kernels) == 1
    _, start, end = kernels[0]
    assert span.start_ns <= start < end <= span.end_ns
    assert metrics.events(sp.start).counts[0].name == "launch.pack_view"
