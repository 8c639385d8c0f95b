"""The yardstick of a kernel's share of its roofline on one H100.

A copy of ``chip_smoke.py``'s arithmetic (``nbytes``, ``bound``) for the
bytes side: the least time the card could take for the work is its bytes
over the HBM bandwidth, where each input is read once and each output
written once, whatever the kernels read again.  The counts' integer
compares and adds are far below the card's scalar rate (67 TFLOP/s
float32 outside the tensor cores), so bytes bound them.  Peak: NVIDIA's
H100 SXM data sheet, 80 GB of HBM3 at 3.35 TB/s, at the card's full
700 W.
"""

HBM_BYTES_PER_S = 3.35e12

# int32 start, end and contig code of a row, as the count reads them
INTERVAL_ROW_BYTES = 3 * 4
COUNT_BYTES = 8  # the int64 count written


def count_bound_s(*row_counts: int) -> float:
    """Least time of an overlap count over tables of these row counts:
    each side's bounds and keys read once, the count written once."""
    return (INTERVAL_ROW_BYTES * sum(row_counts) + COUNT_BYTES) / HBM_BYTES_PER_S
