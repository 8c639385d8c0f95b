"""The NumPy reference against a brute-force O(n*m) loop on small
random tables: counts and coverage."""

import numpy as np
import pytest

from benchmark import gen, reference


def _random(rng, n, contigs):
    code = rng.integers(0, contigs, n).astype(np.int32)
    start = rng.integers(0, 2_000, n).astype(np.int64)
    end = start + rng.integers(0, 120, n)  # zero-length rows too
    return gen.Intervals(tuple(f"chr{i + 1}" for i in range(contigs)), code, start, end)


def _matrix(a, b):
    return ((a.code[:, None] == b.code[None, :])
            & (a.start[:, None] <= b.end[None, :]) & (b.start[None, :] <= a.end[:, None]))


@pytest.fixture(params=range(12))
def tables(request):
    rng = np.random.default_rng(request.param)
    contigs = int(rng.integers(1, 4))
    return (_random(rng, int(rng.integers(0, 300)), contigs),
            _random(rng, int(rng.integers(0, 300)), contigs))


def test_per_row_counts(tables):
    a, b = tables
    np.testing.assert_array_equal(reference.per_row_counts(a, b), _matrix(a, b).sum(1))


def test_coverage(tables):
    a, b = tables
    m = _matrix(a, b)
    width = np.minimum(a.end[:, None], b.end[None, :]) - np.maximum(a.start[:, None], b.start[None, :])
    counts, bases = reference.coverage(a, b)
    np.testing.assert_array_equal(counts, m.sum(1))
    np.testing.assert_array_equal(bases, (width * m).sum(1))


def test_rounded_control_differs_at_genome_positions():
    a = gen.chain(20_000, 13)
    b = gen.chain(30_000, 14)
    exact = int(reference.per_row_counts(a, b).sum())
    low = int(reference.per_row_counts(reference.rounded(a), reference.rounded(b)).sum())
    assert exact != low
