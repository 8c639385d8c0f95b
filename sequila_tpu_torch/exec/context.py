"""Execution context: config, metrics, memory accounting.

The memory pool mirrors the reference's use of DataFusion's pool: the
build phase reserves its estimated bytes before materializing and the
query fails with a resources error when the configured limit would be
exceeded (reference interval_join.rs:624-660 `try_grow` + hashtable
size estimate; metric `build_mem_used`, joins/utils.rs:438-495).
`SEQUILA_MEMORY_LIMIT` bytes (0 = unlimited).
"""

from __future__ import annotations

import dataclasses
import os
import time

from sequila_tpu_torch.config import SequilaConfig
from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.utils.metrics import MetricsRegistry


class MemoryPool:
    def __init__(self, limit_bytes: int | None = None):
        if limit_bytes is None:
            limit_bytes = int(os.environ.get("SEQUILA_MEMORY_LIMIT", 0))
        self.limit = limit_bytes
        self.reserved = 0
        self.peak = 0

    def try_grow(self, op: str, nbytes: int) -> None:
        if self.limit and self.reserved + nbytes > self.limit:
            raise ExecutionError(
                f"Resources exhausted: {op} needs {nbytes} more bytes; "
                f"{self.reserved} of {self.limit} already reserved "
                "(raise SEQUILA_MEMORY_LIMIT or enable low-memory mode)"
            )
        self.reserved += nbytes
        self.peak = max(self.peak, self.reserved)

    def shrink(self, nbytes: int) -> None:
        self.reserved = max(0, self.reserved - nbytes)


@dataclasses.dataclass
class ExecContext:
    config: SequilaConfig
    metrics: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    collect_metrics: bool = False
    memory: MemoryPool = dataclasses.field(default_factory=MemoryPool)

    def timer(self, op: str, name: str):
        return _Timer(self, op, name)


class _Timer:
    def __init__(self, ctx: ExecContext, op: str, name: str):
        self.ctx, self.op, self.name = ctx, op, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ctx.metrics.add_time(self.op, self.name, time.perf_counter() - self.t0)
        return False
