"""glibc allocator tuning for steady-state query throughput (a copy of
sequila_tpu/_malloc.py).

Materializing joins allocate hundreds of MB of fresh output buffers per
query; with glibc defaults those arrive via mmap and are returned to the
kernel on free, so every query re-pays soft page faults for its whole
output (about 0.3 s per GB on the host where the JAX package measured
it).  Keeping freed memory in the process heap turns steady-state query
memory into recycled, already-faulted pages — the allocator-level analog of the
reference engine running on a long-lived memory pool (DataFusion's
MemoryPool over a persistent tokio runtime).

Applied once at engine import; disable with SEQUILA_MALLOC_TUNE=0.
No-op on non-glibc platforms.
"""

from __future__ import annotations

import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = False


def tune_malloc() -> None:
    global _applied
    if _applied or os.environ.get("SEQUILA_MALLOC_TUNE", "1") == "0":
        return
    _applied = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        # never trim the heap back to the OS...
        libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        # ...and serve large buffers from that retained heap, not mmap
        libc.mallopt(_M_MMAP_THRESHOLD, 2**31 - 1)
    except Exception:
        pass
