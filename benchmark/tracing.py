"""Reduction of a ``torch.profiler`` trace of the window to device time.

The profiler records the device's kernels, copies and fills (CUPTI) with
timestamps in nanoseconds on the same clock as ``time.time_ns()``, which
is what the harness stamps its own spans with.  From those: the union of
the device's busy intervals, the top device operations by time, and the
idle time of the device by the harness span the host was in.
"""

from __future__ import annotations

import collections

TRANSFER_PREFIXES = ("Memcpy", "Memset")


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every operation that ran on the card."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    out.sort(key=lambda ev: ev[1])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(TRANSFER_PREFIXES)


def busy_intervals(events, lo: int, hi: int) -> list:
    """Merged [start, end) intervals, clipped to [lo, hi), in which some
    operation ran on the device."""
    merged = []
    for _, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_intervals(busy, lo: int, hi: int) -> list:
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _overlap_by_name(intervals, spans) -> dict:
    """Seconds of ``intervals`` inside spans of each name (both sorted)."""
    acc = collections.Counter()
    j = 0
    for name, s0, s1 in spans:
        while j < len(intervals) and intervals[j][1] <= s0:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < s1:
            a, b = max(intervals[k][0], s0), min(intervals[k][1], s1)
            if b > a:
                acc[name] += (b - a) / 1e9
            k += 1
    return acc


def breakdown(events, idle, spans, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    the span the host was in (``unattributed`` where it was in none)."""
    ops = collections.Counter()
    for name, s, e in events:
        ops[name[:200]] += (e - s) / 1e9
    gaps = _overlap_by_name(idle, sorted(spans, key=lambda sp: sp[1]))
    covered = sum(gaps.values())
    total = sum((e - s) / 1e9 for s, e in idle)
    if total - covered > 0:
        gaps["unattributed"] += total - covered
    return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}
