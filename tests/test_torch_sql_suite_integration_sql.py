"""The JAX package's `tests/test_integration_sql.py`, run against the port on the CPU
(tests/torch_suites.py)."""

from torch_suites import load, port_on_cpu  # noqa: F401

globals().update(load("test_integration_sql").exported)
