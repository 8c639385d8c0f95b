"""Mean time per query from the physical plan to the result on the host
(``exec/``, the table views of ``models/table.py``, ``ops/``, the native
host index), from the harness's span around the plan's execution, ended
by a synchronise."""


def read(run):
    t = [q["execute_s"] for q in run.queries if "execute_s" in q]
    return 1e3 * sum(t) / len(t) if t else None
