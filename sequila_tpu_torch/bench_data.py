"""Synthetic benchmark tables (copies of bench.py's generators).

The port's smoke run and tests need the databio-style tables without
importing bench.py's JAX-side harness.  Same seeds, same numpy streams,
same rows as ``bench.gen_chain_table`` / ``bench.gen_genome_table``.
"""

from __future__ import annotations

import numpy as np

N_LEFT, N_RIGHT = 207_146, 302_381  # chainRn4_chr1 / chainVicPac2_chr1 rows
GENOME_LEFT, GENOME_RIGHT = 2_350_965, 7_684_066  # whole-genome pair
CHR1_SPAN = 245_000_000

QUERY = (
    "SELECT count(1) FROM s1 a JOIN s2 b ON a.contig = b.contig "
    "AND a.pos_end >= b.pos_start AND a.pos_start <= b.pos_end"
)


def gen_chain_table(n, seed, median_len=98_000, sigma=1.5):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, CHR1_SPAN, n).astype(np.int64)
    lens = np.exp(rng.normal(np.log(median_len), sigma, n)).astype(np.int64)
    ends = np.minimum(starts + np.maximum(lens, 1), 2**31 - 2)
    contig = np.full(n, "chr1")
    return {
        "contig": contig,
        "pos_start": starts.astype(np.int64),
        "pos_end": ends.astype(np.int64),
    }


def gen_genome_table(n, seed, num_contigs=24, median_len=5_000, sigma=1.2):
    """Whole-genome-like table: contig sizes follow a realistic skew
    (chr1 largest), lognormal interval lengths."""
    rng = np.random.default_rng(seed)
    sizes = np.array([248 - 8 * i for i in range(num_contigs)], np.float64)
    probs = sizes / sizes.sum()
    contig_ids = rng.choice(num_contigs, n, p=probs)
    spans = (sizes * 1e6).astype(np.int64)
    starts = (rng.random(n) * spans[contig_ids]).astype(np.int64)
    lens = np.exp(rng.normal(np.log(median_len), sigma, n)).astype(np.int64)
    ends = np.minimum(starts + np.maximum(lens, 1), 2**31 - 2)
    return {
        "contig": np.array([f"chr{i+1}" for i in contig_ids]),
        "pos_start": starts,
        "pos_end": ends,
    }
