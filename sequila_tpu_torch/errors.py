"""Engine error hierarchy (analog of the reference's DataFusionError)."""

from __future__ import annotations


class SequilaError(Exception):
    """Base class for all engine errors."""


class PlanError(SequilaError):
    """Raised when a query cannot be planned (bad SQL, unknown table, ...)."""


class ExecutionError(SequilaError):
    """Raised when a physical plan fails during execution."""


class CastOverflowError(ExecutionError):
    """Interval bound does not fit in i32.

    The reference hard-errors when casting interval start/end columns to
    Int32 overflows (interval_join.rs:1661-1672, tested at :1927-1968); we
    preserve that contract.
    """


class ConfigError(SequilaError):
    """Raised for invalid `SET sequila.*` keys or values."""
