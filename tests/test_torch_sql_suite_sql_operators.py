"""The JAX package's `tests/test_sql_operators.py`, run against the port on the CPU
(tests/torch_suites.py)."""

from torch_suites import load, port_on_cpu  # noqa: F401

globals().update(load("test_sql_operators").exported)
