"""Mean time per query of a genomic table function's verb, with the
binding it runs in (``planner/binder.py::_genomic_table_function``, the
verb's route in ``dataframe.py``, ``exec/`` and its kernels down to the
copy of the result to the host): the harness's span around
``parse_sql`` and ``create_physical_plan``, which a traffic that names
it ``verb`` (``plan_span``) puts around a ``FROM coverage(...)``."""


def read(run):
    t = [q["verb_s"] for q in run.queries if "verb_s" in q]
    return 1e3 * sum(t) / len(t) if t else None
