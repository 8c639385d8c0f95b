"""Mean time per query in the SQL front end: parse and physical plan
(``session.py``, ``sql/``, ``planner/``), from the harness's span around
``parse_sql`` and ``create_physical_plan``.  Only for queries whose plan
does no more than that: a genomic table function runs its verb while the
plan is bound, and its span is ``verb_ms``'s."""


def read(run):
    t = [q["front_end_s"] for q in run.queries if "front_end_s" in q]
    return 1e3 * sum(t) / len(t) if t else None
