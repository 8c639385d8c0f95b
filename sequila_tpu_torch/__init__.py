"""sequila-tpu-torch: the PyTorch / CUDA port of sequila-tpu.

A second package beside ``sequila_tpu`` (the JAX / TPU reference, which it
never imports).  The device-free layers (SQL parser, binder, planner,
host operators, the native C++ host index) are copies of the reference's;
the device work runs as torch tensors on the device the session names,
with hand-written CUDA kernels for Hopper (``csrc/``) where the reference
used Pallas.  This slice ports the SQL count(*) interval-join path; see
ROADMAP.md for the slices still to come.
"""

from sequila_tpu_torch.config import Algorithm, SequilaConfig

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy import: keeps `import sequila_tpu_torch.ops` cheap for kernel-only use.
    if name == "SessionContext":
        from sequila_tpu_torch.session import SessionContext

        return SessionContext
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Algorithm",
    "SequilaConfig",
    "SessionContext",
    "__version__",
]
