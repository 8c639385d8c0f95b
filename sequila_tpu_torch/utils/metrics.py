"""Per-operator execution metrics, and the program's spans and counters.

``MetricsRegistry`` is the analog of the reference's BuildProbeJoinMetrics
(reference joins/utils.rs:438-495: build_time, build_input_batches/rows,
build_mem_used, join_time, input_batches/rows, output_batches/rows),
surfaced through EXPLAIN ANALYZE and ``SessionContext.last_metrics``.

The recorder beside it keeps spans and counters in memory while a
``torch.profiler`` session records (any activities) or inside an explicit
``recording()`` block, and nothing otherwise:

- ``span(name, **attrs)`` records (name, start_ns, end_ns, parent, thread,
  attrs, id, root): ``parent`` is the id of the span it opened in on the
  same thread (or the thread ``carry`` handed it from), ``root`` the id of
  the outermost one, so the spans of one statement share its root's id;
- ``count(name, n)`` records (name, t_ns, n), and adds ``n`` to the
  registry of the statement that runs (``collecting``) under the op
  ``PROGRAM``, whether or not the recorder records.

Every stamp is ``time.time_ns()``, the clock on which ``torch.profiler``
stamps its CPU events and the card's kernels and copies, so a span and a
kernel compare directly.  Readers take ``events(lo_ns, hi_ns)``; the
device's idle intervals split by the innermost span the host was in
through ``split_by_span``.  ``to_device`` and ``to_host`` are the copies
between the host and a card, recorded as ``h2d`` and ``device_wait``
spans and ``h2d_bytes`` / ``d2h_bytes`` counters.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import itertools
import json
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

# the registry's op for counters that no operator owns (kernel launches,
# verb routes, bytes copied)
PROGRAM = "program"


class MetricsRegistry:
    def __init__(self):
        self.counters: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter
        )
        self.times: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter
        )

    def add(self, op: str, name: str, value: int = 1) -> None:
        self.counters[op][name] += value
        if _REC.forced or _profiler._is_profiler_enabled:
            _REC.counts.append(Count(name, time.time_ns(), value))

    def add_time(self, op: str, name: str, seconds: float) -> None:
        self.times[op][name] += seconds

    def format_op(self, op: str) -> str:
        parts = []
        for name, v in sorted(self.counters.get(op, {}).items()):
            parts.append(f"{name}={v}")
        for name, v in sorted(self.times.get(op, {}).items()):
            parts.append(f"{name}={v*1000:.3f}ms")
        return ", ".join(parts)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # id of the enclosing span, None at a root
    thread: int  # native thread id
    attrs: dict | None
    id: int
    root: int  # id of the outermost enclosing span (its own at a root)


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


class Events(NamedTuple):
    spans: list
    counts: list


class _ThreadState(threading.local):
    registry: MetricsRegistry | None = None  # where count() adds, per thread

    def __init__(self):
        self.stack = []  # open spans, innermost last
        self.thread = threading.get_native_id()


class _Recorder:
    """The records and the per-thread state behind the module's functions."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: list[Count] = []
        self.forced = 0  # open recording() blocks
        self.ids = itertools.count(1)
        self.local = _ThreadState()


_REC = _Recorder()


def is_recording() -> bool:
    """True while a torch.profiler session or a recording() block records."""
    return bool(_REC.forced) or _profiler._is_profiler_enabled


class _NoSpan:
    """The shared span of a site while nothing records."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start")

    def __init__(self, name: str, attrs: dict | None):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a route that answered)."""
        self.attrs = {**(self.attrs or {}), **attrs}

    def __enter__(self):
        st = _REC.local.stack
        top = st[-1] if st else None
        self.id = next(_REC.ids)
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        local = _REC.local
        st = local.stack
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # closed out of order (a generator's span)
            st.remove(self)
        _REC.spans.append(Span(self.name, self.start, end, self.parent, local.thread,
                               self.attrs, self.id, self.root))
        return False


def span(name: str, **attrs):
    """Context manager recording one span; a shared no-op while nothing
    records.  ``set(**attrs)`` on the value it gives adds attributes."""
    if _REC.forced or _profiler._is_profiler_enabled:
        return _OpenSpan(name, attrs or None)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: into the running statement's registry
    (op ``PROGRAM``), and into the records while recording."""
    reg = _REC.local.registry
    if reg is not None:
        reg.counters[PROGRAM][name] += n
    if _REC.forced or _profiler._is_profiler_enabled:
        _REC.counts.append(Count(name, time.time_ns(), n))


class collecting:
    """Route ``count`` on this thread (and threads ``carry`` hands work to)
    into ``registry`` while the block runs."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry

    def __enter__(self) -> MetricsRegistry:
        self.was, _REC.local.registry = _REC.local.registry, self.registry
        return self.registry

    def __exit__(self, exc_type, exc, tb):
        _REC.local.registry = self.was
        return False


def carry(fn):
    """``fn`` wrapped to run, on another thread, inside the caller's open
    span and registry: its spans take that span as their parent."""
    st = _REC.local.stack
    top = st[-1] if st else None
    registry = _REC.local.registry

    def run(*args, **kwargs):
        mine = _REC.local.stack
        depth = len(mine)
        if top is not None:
            mine.append(top)
        was = _REC.local.registry
        _REC.local.registry = registry
        try:
            return fn(*args, **kwargs)
        finally:
            _REC.local.registry = was
            del mine[depth:]

    return run


class Recorded:
    """The records of one ``recording()`` block: ``events()`` and
    ``counts()`` over the time it was open (so far, while it is)."""

    def __init__(self):
        self.lo_ns, self.hi_ns = time.time_ns(), None

    def events(self) -> Events:
        return events(self.lo_ns, self.hi_ns)

    def counts(self) -> collections.Counter:
        return counts(self.lo_ns, self.hi_ns)


@contextlib.contextmanager
def recording():
    """Record spans and counters while the block runs, with or without a
    profiler (tests and tools); gives the block's ``Recorded``."""
    _REC.forced += 1
    rec = Recorded()
    try:
        yield rec
    finally:
        rec.hi_ns = time.time_ns() + 1
        _REC.forced -= 1


def events(lo_ns: int = 0, hi_ns: int | None = None) -> Events:
    """Spans that start, and counts taken, in [lo_ns, hi_ns)."""
    hi = hi_ns if hi_ns is not None else 2**63
    return Events([s for s in _REC.spans if lo_ns <= s.start_ns < hi],
                  [c for c in _REC.counts if lo_ns <= c.t_ns < hi])


def counts(lo_ns: int = 0, hi_ns: int | None = None) -> collections.Counter:
    """Counter totals by name over [lo_ns, hi_ns)."""
    out = collections.Counter()
    for c in events(lo_ns, hi_ns).counts:
        out[c.name] += c.n
    return out


def split_by_span(intervals, spans) -> dict:
    """Nanoseconds of ``intervals`` ((start, end), such as the device's idle
    intervals) by the name of the innermost span the host was in: of the
    spans covering an instant, the one that opened last.  Time in no span
    goes to ``None``."""
    bounds = sorted({t for iv in intervals for t in iv}
                    | {t for s in spans for t in (s.start_ns, s.end_ns)})
    starts = sorted(spans, key=lambda s: s.start_ns)
    ivs = sorted(intervals)
    out = collections.Counter()
    heap, j, k = [], 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(starts) and starts[j].start_ns <= a:
            s = starts[j]
            heapq.heappush(heap, (-s.start_ns, -s.id, s.end_ns, s.name))
            j += 1
        while heap and heap[0][2] <= a:
            heapq.heappop(heap)
        while k < len(ivs) and ivs[k][1] <= a:
            k += 1
        if k < len(ivs) and ivs[k][0] <= a:
            out[heap[0][3] if heap else None] += b - a
    return dict(out)


# -- copies between the host and a card -------------------------------------


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``torch.tensor(a, device=device)``: a copy of a host array (pageable
    memory), recorded on a card as an ``h2d`` span and ``h2d_bytes``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.tensor(a)
    nbytes = int(a.nbytes)
    with span("h2d", bytes=nbytes):
        out = torch.tensor(a, device=dev)
    count("h2d_bytes", nbytes)
    return out


def to_host(t: torch.Tensor):
    """A tensor's values on the host: a Python number for a 0-d tensor
    (``item()``), else a NumPy array (``.cpu().numpy()``).  From a card the
    host blocks until the card has computed them: a ``device_wait`` span
    and ``d2h_bytes``."""
    if t.device.type == "cpu":
        return t.item() if t.dim() == 0 else t.numpy()
    nbytes = t.numel() * t.element_size()
    with span("device_wait", bytes=nbytes):
        out = t.item() if t.dim() == 0 else t.cpu().numpy()
    count("d2h_bytes", nbytes)
    return out


def synchronize() -> None:
    """Wait for every card's queued work, recorded as a ``device_wait``."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        with span("device_wait"):
            torch.cuda.synchronize()


# -- export -----------------------------------------------------------------


def merge_into_chrome_trace(path: str, lo_ns: int, hi_ns: int) -> None:
    """Append the records of [lo_ns, hi_ns) to a ``torch.profiler`` Chrome
    trace, on its clock (``baseTimeNanoseconds``), and take them out of the
    records: spans as complete events, counts as instant events, category
    ``program``."""
    import os

    got = events(lo_ns, hi_ns)
    _REC.spans = [s for s in _REC.spans if not lo_ns <= s.start_ns < hi_ns]
    _REC.counts = [c for c in _REC.counts if not lo_ns <= c.t_ns < hi_ns]
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    out = trace.setdefault("traceEvents", [])
    for s in got.spans:
        args = {"id": s.id, "parent": s.parent, "root": s.root, **(s.attrs or {})}
        out.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    for c in got.counts:
        out.append({"ph": "i", "s": "p", "cat": "program", "name": c.name, "pid": pid,
                    "tid": 0, "ts": (c.t_ns - base) / 1e3, "args": {"n": c.n}})
    with open(path, "w") as f:
        json.dump(trace, f)
