"""Mean time per query (ms) in the table views of ``models/table.py``:
the union of the program's ``table.*`` spans (key coding, i32 columns,
min gaps, the sorted views' radix sort and gathers, per-key extrema,
inverse orders, statistics), each recorded on a cache miss only, so a
query on cached views reads near 0."""

from benchmark import program


def read(run):
    return program.span_ms_per_query(run, lambda name: name.startswith("table."))
