"""Mean time per query (ms) the host spent blocked on the card: the union
of the program's ``device_wait`` spans, each around a copy of a result
to the host (``utils/metrics.to_host``: the card's queued work, then the
copy) or a synchronise."""

from benchmark import program


def read(run):
    return program.span_ms_per_query(run, lambda name: name == "device_wait")
