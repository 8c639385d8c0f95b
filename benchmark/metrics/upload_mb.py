"""Mean bytes per query (MB, 1e6 B) copied from the host to the card:
the program's ``h2d_bytes`` counter, which every upload of
``utils/metrics.to_device`` adds to (table views, key codes, inverse
orders, C tables, segment descriptors, key remaps)."""

from benchmark import program


def read(run):
    v = program.count_per_query(run, lambda name: name == "h2d_bytes")
    return None if v is None else v / 1e6
