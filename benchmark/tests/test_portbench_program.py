"""The readers of the program's own spans and counters
(``benchmark/program.py`` and the per-layer metrics that use it), on a
run built from synthetic records: known values in, the right per-query
mean out, and ``None`` where the program recorded nothing in the window
or has no recorder."""

import pytest

from benchmark import harness
from sequila_tpu_torch.utils import metrics

MS = 1_000_000
NEW = ("table_views_ms", "upload_mb", "operator_self_ms", "device_wait_ms",
       "hand_kernel_launches")


def _span(name, start_ms, end_ms, id_, parent=None):
    return metrics.Span(name, start_ms * MS, end_ms * MS, parent, 1, None, id_, 1)


SPANS = [
    _span("session.plan", 0, 5, 1),
    _span("join.count", 5, 105, 2),
    _span("join.plan", 10, 40, 3, 2),
    _span("table.view_sort", 10, 30, 4, 3),
    _span("table.dict_codes", 12, 16, 5, 4),  # inside the sort's span
    _span("h2d", 15, 20, 6, 4),  # an upload inside a view's span
    _span("h2d", 32, 36, 7, 3),
    _span("join_time", 50, 90, 8, 2),
    _span("device_wait", 80, 90, 9, 8),
    _span("join.count", 200, 210, 10),
    _span("table.min_gap", 300, 302, 11),  # under no join.count
    _span("device_wait", 400, 401, 12),
]
COUNTS = [metrics.Count("h2d_bytes", 15 * MS, 61_488_128),
          metrics.Count("h2d_bytes", 32 * MS, 61_488_128),
          metrics.Count("launch.pack_view", 60 * MS, 4),
          metrics.Count("launch.merge_path", 61 * MS, 1),
          metrics.Count("launch.pack_view", 201 * MS, 4),
          metrics.Count("launch.merge_path", 202 * MS, 1),
          metrics.Count("count_route_merge", 90 * MS, 1)]


def _run(queries=2, window=(0, 10**12)):
    run = harness.Run(cell=None, inputs=None, seed=0, traced=True)
    run.queries = [{"i": i} for i in range(queries)]
    run.window_ns = window
    return run


@pytest.fixture
def recorded(monkeypatch):
    seen = []

    def events(lo, hi):
        seen.append((lo, hi))
        return metrics.Events([s for s in SPANS if lo <= s.start_ns < hi],
                              [c for c in COUNTS if lo <= c.t_ns < hi])

    monkeypatch.setattr(metrics, "events", events)
    return seen


@pytest.mark.parametrize("name, want", [
    ("table_views_ms", (20 + 2) / 2),  # the union of every table.* span
    ("upload_mb", 2 * 61.488128 / 2),
    # each join.count less its table views, uploads and waits:
    # 100 - (10..30 and 32..36 and 80..90 = 34), and 10
    ("operator_self_ms", (100 - 34 + 10) / 2),
    ("device_wait_ms", (10 + 1) / 2),
    ("hand_kernel_launches", 10 / 2),
])
def test_reader_means_per_query(recorded, name, want):
    run = _run()
    assert harness.metric_reader(name)(run) == pytest.approx(want)
    assert recorded[-1] == run.window_ns


def test_readers_keep_to_the_window(recorded):
    run = _run(queries=1, window=(195 * MS, 250 * MS))
    read = {name: harness.metric_reader(name)(run) for name in NEW}
    assert read == {"table_views_ms": 0.0, "upload_mb": 0.0, "operator_self_ms": 10.0,
                    "device_wait_ms": 0.0, "hand_kernel_launches": 5.0}


@pytest.mark.parametrize("name", NEW)
def test_nothing_in_the_window_reads_none(recorded, name):
    assert harness.metric_reader(name)(_run(window=(10**10, 10**11))) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_reads_none(monkeypatch, name):
    monkeypatch.delattr(metrics, "events")
    assert harness.metric_reader(name)(_run()) is None


def test_the_new_metrics_are_declared():
    declared = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["moves"] == "pairs_per_s" and m["workloads"]
