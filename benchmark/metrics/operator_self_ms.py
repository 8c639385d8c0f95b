"""Mean time per query (ms) in the count operator's own host path: each
``join.count`` span (``IntervalJoinExec.count_rows``) less the part of it
that its descendant spans of the other layers cover (table views
``table.*``, uploads ``h2d``, waits on the card ``device_wait``).  What
is left is the operator's Python: routing, plan lookups and builds, key
remaps and the kernels' launches."""

from benchmark import program

OTHER_LAYERS = ("table.", "h2d", "device_wait")


def read(run):
    got = program.window_events(run)
    if got is None:
        return None
    by_id = {s.id: s for s in got.spans}
    inside = {}  # join.count id -> intervals of its descendants of the other layers
    for s in got.spans:
        if not s.name.startswith(OTHER_LAYERS):
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != "join.count":
            p = by_id.get(p.parent)
        if p is not None:
            inside.setdefault(p.id, []).append((s.start_ns, s.end_ns))
    total = 0
    for s in got.spans:
        if s.name == "join.count":
            total += s.end_ns - s.start_ns - program.union_ns(inside.get(s.id, ()))
    return total / 1e6 / len(run.queries)
