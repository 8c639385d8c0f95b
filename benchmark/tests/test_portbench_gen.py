"""The frozen generators against the program's copy, and the databio pair
counts they give through the NumPy reference."""

import inspect

import numpy as np
import pytest

from benchmark import gen, harness, reference
from sequila_tpu_torch import bench_data


def _same(frozen: gen.Intervals, original: dict) -> None:
    assert frozen.arrow().column("contig").to_pylist() == list(original["contig"])
    np.testing.assert_array_equal(frozen.start, original["pos_start"])
    np.testing.assert_array_equal(frozen.end, original["pos_end"])
    assert frozen.start.dtype == np.int64 and frozen.end.dtype == np.int64


@pytest.mark.parametrize("n, seed", [(1, 0), (1_000, 1), (20_000, 2), (3_333, 2**31 + 7)])
def test_chain_equals_bench_data(n, seed):
    _same(gen.chain(n, seed), bench_data.gen_chain_table(n, seed))


@pytest.mark.parametrize("n, seed", [(1, 0), (1_000, 21), (50_000, 22), (4_321, 6_000_000_045)])
def test_genome_equals_bench_data(n, seed):
    _same(gen.genome(n, seed), bench_data.gen_genome_table(n, seed))


def test_within_contig_cuts_only_ends_past_the_contig():
    free, cut = gen.genome(30_000, 9, median_len=98_000, sigma=1.5), \
        gen.genome(30_000, 9, median_len=98_000, sigma=1.5, within_contig=True)
    last = (np.array([248 - 8 * i for i in range(24)]) * 1_000_000 - 1)[cut.code]
    np.testing.assert_array_equal(cut.start, free.start)
    np.testing.assert_array_equal(cut.end, np.minimum(free.end, last))
    assert (free.end > last).any() and (cut.end <= last).all() and (cut.start <= cut.end).all()
    assert int(reference.per_row_counts(cut, cut).sum()) == int(reference.per_row_counts(free, free).sum())


def test_pool_window_is_the_generator_stream():
    pool = gen.genome(10_000, 5)
    window = pool.slice(1_234, 5_000)
    np.testing.assert_array_equal(window.start, pool.start[1_234:6_234])
    assert window.arrow().column("contig").to_pylist() == \
        pool.arrow().slice(1_234, 5_000).column("contig").to_pylist()


@pytest.mark.parametrize("make, rows, seeds, pairs", [
    (gen.chain, (207_146, 302_381), (1, 2), 153_690_858),
    (gen.genome, (2_350_965, 7_684_066), (21, 22), 99_159_827),
])
def test_databio_pair_counts(make, rows, seeds, pairs):
    """bench.py's sizes and default lengths; the chr1 pair is the
    calibration of the genome configuration's lengths."""
    a, b = (make(n, s) for n, s in zip(rows, seeds))
    assert int(reference.per_row_counts(a, b).sum()) == pairs
    assert int(reference.per_row_counts(b, a).sum()) == pairs


@pytest.mark.parametrize("name", [c["name"] for c in harness.manifest()["configs"]])
def test_configuration_pairs_at_seed_0(name):
    c = harness.cell(next(w["name"] for w in harness.manifest()["workloads"]
                          if w["config"] == name)).config
    chr1 = inspect.signature(gen.chain).parameters  # the calibrated lengths
    assert c["params"]["median_len"] == chr1["median_len"].default
    assert c["params"]["sigma"] == chr1["sigma"].default
    t = harness.make_inputs(c, {}, 0).tables
    assert int(reference.per_row_counts(t["s1"], t["s2"]).sum()) == c["pairs_at_seed_0"]
