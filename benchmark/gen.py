"""Frozen copies of the databio table generators.

Same seeds, same NumPy streams, same rows as ``gen_chain_table`` and
``gen_genome_table`` of ``sequila_tpu_torch/bench_data.py`` (itself a copy
of ``bench.py``'s), kept here so that a change to the program cannot move
the benchmark's inputs.  Only the contig column is built differently: by
an arrow ``take`` of the contig names, not a Python loop over the rows;
and ``genome`` can cut ends at the contig's end (``within_contig``).

A table is returned twice over: as plain NumPy arrays for the reference
(``Intervals``: contig codes into ``names``, int64 starts and ends) and as
the arrow table the program is given (``arrow``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pyarrow as pa

CHR1_SPAN = 245_000_000
MAX_POS = 2**31 - 2


@dataclasses.dataclass(frozen=True)
class Intervals:
    names: tuple  # contig name of each code
    code: np.ndarray  # int32 contig code per row
    start: np.ndarray  # int64, end-inclusive intervals
    end: np.ndarray

    @property
    def rows(self) -> int:
        return len(self.start)

    def slice(self, lo: int, n: int) -> "Intervals":
        return Intervals(self.names, self.code[lo:lo + n], self.start[lo:lo + n],
                         self.end[lo:lo + n])

    def arrow(self) -> pa.Table:
        contig = pa.array(list(self.names), pa.string()).take(pa.array(self.code))
        return pa.table({"contig": contig, "pos_start": self.start, "pos_end": self.end})


def _ends(rng, starts, n, median_len, sigma):
    lens = np.exp(rng.normal(np.log(median_len), sigma, n)).astype(np.int64)
    return np.minimum(starts + np.maximum(lens, 1), MAX_POS)


def chain(n: int, seed: int, median_len=98_000, sigma=1.5, span=CHR1_SPAN) -> Intervals:
    """One contig of ``span`` bases, uniform starts, lognormal lengths."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, span, n).astype(np.int64)
    ends = _ends(rng, starts, n, median_len, sigma)
    return Intervals(("chr1",), np.zeros(n, np.int32), starts, ends)


def genome(n: int, seed: int, num_contigs=24, median_len=5_000, sigma=1.2,
           within_contig=False) -> Intervals:
    """Whole-genome-like: contig sizes 248, 240, ... Mb drawn in proportion
    to their size (chr1 largest), uniform starts, lognormal lengths.  With
    ``within_contig`` every end is cut at its contig's last base, as a real
    table's rows lie within their chromosome (``bench_data`` has no such
    cut; the rows are otherwise the same)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([248 - 8 * i for i in range(num_contigs)], np.float64)
    contig_ids = rng.choice(num_contigs, n, p=sizes / sizes.sum())
    spans = (sizes * 1e6).astype(np.int64)
    starts = (rng.random(n) * spans[contig_ids]).astype(np.int64)
    ends = _ends(rng, starts, n, median_len, sigma)
    if within_contig:
        ends = np.minimum(ends, spans[contig_ids] - 1)
    names = tuple(f"chr{i + 1}" for i in range(num_contigs))
    return Intervals(names, contig_ids.astype(np.int32), starts, ends)


GENERATORS = {"chain": chain, "genome": genome}
