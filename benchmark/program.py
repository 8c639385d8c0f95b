"""The program's own spans and counters over a traced window, for the
per-layer readers of ``benchmark/metrics``.

``sequila_tpu_torch.utils.metrics`` records them while a
``torch.profiler`` session runs, which the harness starts around a traced
window: spans (name, start_ns, end_ns, parent, thread, attrs, id, root)
and counts (name, t_ns, n), stamped with ``time.time_ns()`` like the
harness's own spans.  A program that records none (one older than its
recorder) gives ``None`` here, and so does every reader.
"""

from __future__ import annotations


def window_events(run):
    """(spans, counts) of the program in the run's window, or None when
    the program recorded nothing there or has no recorder."""
    try:
        from sequila_tpu_torch.utils import metrics
    except ImportError:
        return None
    events = getattr(metrics, "events", None)
    if events is None or not run.queries:
        return None
    got = events(*run.window_ns)
    if not got.spans and not got.counts:
        return None
    return got


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of (start, end) intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s >= reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def span_ms_per_query(run, wanted) -> float | None:
    """Mean time per query (ms) under the union of the window's spans
    whose name ``wanted(name)`` accepts."""
    got = window_events(run)
    if got is None:
        return None
    covered = union_ns((s.start_ns, s.end_ns) for s in got.spans if wanted(s.name))
    return covered / 1e6 / len(run.queries)


def count_per_query(run, wanted) -> float | None:
    """Mean per query of the window's counts whose name ``wanted(name)``
    accepts."""
    got = window_events(run)
    if got is None:
        return None
    return sum(c.n for c in got.counts if wanted(c.name)) / len(run.queries)
