"""Column statistics + join-cardinality estimation.

Role-equivalent of the reference's statistics plumbing (reference
joins/utils.rs:136-370 — `estimate_join_statistics` /
`estimate_inner_join_cardinality` over per-column min/max/distinct
stats — and the operator `statistics()` surface,
interval_join.rs:586-593).  Values carry a DataFusion-style precision
tag (Exact / Inexact / Absent) so consumers can tell measured facts from
estimates.

Estimation model (original, tuned for interval joins):
- equi-key cardinality: |L| x |R| / max(ndv(keys)) — the textbook
  containment assumption the reference also uses; disjoint key ranges
  short-circuit to 0;
- the interval-overlap conjunct multiplies in a selectivity estimate
  from interval geometry: two random intervals of mean lengths a and b
  dropped on a span W overlap with probability ~ (a + b) / W.
"""

from __future__ import annotations

import dataclasses


EXACT = "Exact"
INEXACT = "Inexact"
ABSENT = "Absent"


@dataclasses.dataclass(frozen=True)
class Precision:
    """A statistic value with its precision tag (DataFusion's Precision)."""

    value: float | int | None = None
    kind: str = ABSENT

    @classmethod
    def exact(cls, v) -> "Precision":
        return cls(v, EXACT)

    @classmethod
    def inexact(cls, v) -> "Precision":
        return cls(v, INEXACT)

    @classmethod
    def absent(cls) -> "Precision":
        return cls(None, ABSENT)

    @property
    def is_absent(self) -> bool:
        return self.kind == ABSENT

    def to_inexact(self) -> "Precision":
        return self if self.is_absent else Precision(self.value, INEXACT)

    def display(self) -> str:
        if self.is_absent:
            return "Absent"
        v = self.value
        if isinstance(v, float) and float(v).is_integer():
            v = int(v)
        return f"{self.kind}({v})"


@dataclasses.dataclass(frozen=True)
class ColumnStatistics:
    null_count: Precision = Precision.absent()
    min_value: Precision = Precision.absent()
    max_value: Precision = Precision.absent()
    distinct_count: Precision = Precision.absent()
    mean_value: Precision = Precision.absent()  # engine extension: interval
    # selectivity needs E[length], which min/max alone cannot give


@dataclasses.dataclass(frozen=True)
class Statistics:
    num_rows: Precision = Precision.absent()
    total_byte_size: Precision = Precision.absent()
    column_statistics: tuple = ()

    @classmethod
    def unknown(cls) -> "Statistics":
        return cls()

    def to_inexact(self) -> "Statistics":
        return Statistics(
            self.num_rows.to_inexact(),
            self.total_byte_size.to_inexact(),
            tuple(
                ColumnStatistics(
                    c.null_count.to_inexact(), c.min_value.to_inexact(),
                    c.max_value.to_inexact(), c.distinct_count.to_inexact(),
                    c.mean_value.to_inexact(),
                )
                for c in self.column_statistics
            ),
        )

    def display(self) -> str:
        """DataFusion-style `Rows=..., Bytes=...` rendering for EXPLAIN
        (enabled by `SET datafusion.explain.show_statistics = true`)."""
        return f"Rows={self.num_rows.display()}, Bytes={self.total_byte_size.display()}"


def _ndv(col: ColumnStatistics, num_rows: Precision) -> float | None:
    """Number-of-distinct-values estimate for one key column."""
    if not col.distinct_count.is_absent:
        return max(float(col.distinct_count.value), 1.0)
    lo, hi = col.min_value, col.max_value
    if not lo.is_absent and not hi.is_absent:
        try:
            width = float(hi.value) - float(lo.value) + 1.0
        except (TypeError, ValueError):
            return None
        if width >= 1.0:
            cap = float(num_rows.value) if not num_rows.is_absent else width
            return max(min(width, cap), 1.0)
    return None


def _ranges_disjoint(a: ColumnStatistics, b: ColumnStatistics) -> bool:
    try:
        if not a.max_value.is_absent and not b.min_value.is_absent:
            if float(a.max_value.value) < float(b.min_value.value):
                return True
        if not b.max_value.is_absent and not a.min_value.is_absent:
            if float(b.max_value.value) < float(a.min_value.value):
                return True
    except (TypeError, ValueError):
        return False
    return False


def estimate_inner_join_cardinality(
    left: Statistics, right: Statistics, on: list[tuple[int, int]]
) -> Precision:
    """|L| x |R| / prod(max(ndv_l, ndv_r)) over the equi-key columns; 0
    when any key column's value ranges are provably disjoint (reference
    joins/utils.rs:estimate_inner_join_cardinality semantics)."""
    if left.num_rows.is_absent or right.num_rows.is_absent:
        return Precision.absent()
    n, m = float(left.num_rows.value), float(right.num_rows.value)
    if n == 0 or m == 0:
        return Precision.inexact(0)
    est = n * m
    for li, ri in on:
        lc = (
            left.column_statistics[li]
            if li < len(left.column_statistics)
            else ColumnStatistics()
        )
        rc = (
            right.column_statistics[ri]
            if ri < len(right.column_statistics)
            else ColumnStatistics()
        )
        if _ranges_disjoint(lc, rc):
            return Precision.inexact(0)
        ndv_l, ndv_r = _ndv(lc, left.num_rows), _ndv(rc, right.num_rows)
        if ndv_l is None and ndv_r is None:
            continue  # no information on this key: containment over others
        est /= max(ndv_l or 1.0, ndv_r or 1.0)
    return Precision.inexact(int(est))


def interval_overlap_selectivity(
    ls: ColumnStatistics, le: ColumnStatistics,
    rs: ColumnStatistics, re: ColumnStatistics,
) -> float | None:
    """P(two random intervals overlap | same key) ~ (E[len_L] + E[len_R])
    / span, from mean start/end statistics; None when unavailable."""
    need = (ls.mean_value, le.mean_value, rs.mean_value, re.mean_value,
            ls.min_value, le.max_value, rs.min_value, re.max_value)
    if any(p.is_absent for p in need):
        return None
    len_l = max(float(le.mean_value.value) - float(ls.mean_value.value) + 1, 1.0)
    len_r = max(float(re.mean_value.value) - float(rs.mean_value.value) + 1, 1.0)
    span = (
        max(float(le.max_value.value), float(re.max_value.value))
        - min(float(ls.min_value.value), float(rs.min_value.value))
        + 1.0
    )
    if span <= 0:
        return None
    return min((len_l + len_r) / span, 1.0)


def estimate_join_statistics(
    join_type: str,
    left: Statistics,
    right: Statistics,
    on: list[tuple[int, int]],
    selectivity: float | None = None,
) -> Statistics:
    """Output statistics of a join node (reference
    joins/utils.rs:estimate_join_statistics): the inner estimate,
    adjusted per join type's row-preservation guarantees and scaled by an
    optional extra filter selectivity (the interval conjunct)."""
    inner = estimate_inner_join_cardinality(left, right, on)
    if inner.is_absent:
        return Statistics.unknown()
    est = float(inner.value)
    if selectivity is not None:
        est *= selectivity
    n = float(left.num_rows.value) if not left.num_rows.is_absent else 0.0
    m = float(right.num_rows.value) if not right.num_rows.is_absent else 0.0
    if join_type == "left":
        est = max(est, n)
    elif join_type == "right":
        est = max(est, m)
    elif join_type == "full":
        est = max(est, n + m)
    elif join_type in ("left semi", "left anti"):
        est = min(est, n)
    elif join_type in ("right semi", "right anti"):
        est = min(est, m)
    rows = int(est)
    # bytes scale from the inputs' per-row byte sizes
    bytes_ = Precision.absent()
    if (
        not left.total_byte_size.is_absent
        and not right.total_byte_size.is_absent
        and n > 0
        and m > 0
    ):
        per_row = (
            float(left.total_byte_size.value) / n
            + float(right.total_byte_size.value) / m
        )
        bytes_ = Precision.inexact(int(rows * per_row))
    return Statistics(Precision.inexact(rows), bytes_, ())
