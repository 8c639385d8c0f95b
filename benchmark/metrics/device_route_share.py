"""Share (%) of the window's queries that the operator's own route
counters (``count_route_<name>``, ``emit_route_<name>``,
``probe_count_route_<name>``, ``nearest_route_<name>`` in the query's
metrics) put on a device route, of those that recorded a route."""


def read(run):
    routed = [q["routes"] for q in run.queries if q.get("routes")]
    if not routed:
        return None
    device = sum(1 for r in routed if any(not k.endswith("_route_host") for k in r))
    return 100.0 * device / len(routed)
