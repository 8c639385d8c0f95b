"""The JAX package's `tests/test_cookbook.py`, run against the port on the CPU
(tests/torch_suites.py).  Its Setup block names the fixture tables
relative to the repository root (``testing/data/...``), where
``port_on_cpu`` runs the module."""

from torch_suites import load, port_on_cpu  # noqa: F401

globals().update(load("test_cookbook").exported)
