"""Per-operator execution metrics.

Analog of the reference's BuildProbeJoinMetrics (reference
joins/utils.rs:438-495: build_time, build_input_batches/rows, build_mem_used,
join_time, input_batches/rows, output_batches/rows), surfaced through
EXPLAIN ANALYZE.
"""

from __future__ import annotations

import collections


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

    def add_time(self, op: str, name: str, seconds: float) -> None:
        self.times[op][name] += seconds

    def format_op(self, op: str) -> str:
        parts = []
        for name, v in sorted(self.counters.get(op, {}).items()):
            parts.append(f"{name}={v}")
        for name, v in sorted(self.times.get(op, {}).items()):
            parts.append(f"{name}={v*1000:.3f}ms")
        return ", ".join(parts)
