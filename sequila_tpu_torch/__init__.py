"""sequila-tpu-torch: the PyTorch / CUDA port of sequila-tpu.

A second package beside ``sequila_tpu`` (the JAX / TPU reference, which it
never imports).  The device-free layers (SQL parser, binder, planner,
host operators, the native C++ host index) are copies of the reference's;
the device work runs as torch tensors on the device the session names,
with hand-written CUDA kernels for Hopper (``csrc/``) where the reference
used Pallas.  The port covers the SQL interval join (count(*), grouped
count(*), SELECT * and its streamed forms, nearest), the genomic verbs
(``sequila_tpu_torch.dataframe`` and their SQL table functions) and
``IntervalMap``; see ROADMAP.md for the slices still to come.

Importing the package tunes glibc's allocator as the reference does
(``_malloc.tune_malloc``; SEQUILA_MALLOC_TUNE=0 turns it off).
"""

from sequila_tpu_torch._malloc import tune_malloc
from sequila_tpu_torch.config import Algorithm, SequilaConfig

tune_malloc()

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy import: keeps `import sequila_tpu_torch.ops` cheap for kernel-only use.
    if name == "SessionContext":
        from sequila_tpu_torch.session import SessionContext

        return SessionContext
    if name == "IntervalMap":
        # the superintervals-wheel API surface (reference intervalmap.pyx)
        from sequila_tpu_torch.intervalmap import IntervalMap

        return IntervalMap
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Algorithm",
    "IntervalMap",
    "SequilaConfig",
    "SessionContext",
    "__version__",
]
