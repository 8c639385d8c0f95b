"""``coverage(probe, build)``: each probe row in probe order, with the
number of build rows that overlap it and the bases they cover,
sum(min(end) - max(start)).

In the window each query's rows are counted, and the tables of the
sampled queries (the harness's ``Reservoir``: ``keep`` of them, drawn
from the seed among all the window issued) are kept.  After the window,
for each kept table: ``probe_off`` counts the rows whose (contig, start,
end) are not the probe's row at that position, ``count_off`` and
``bases_off`` the rows whose count or bases differ from the reference's;
``rows_off`` is the largest gap between a query's rows and the probe's,
and ``unjudged`` the answered queries short of ``keep`` whose table
was not judged.
"""

from __future__ import annotations

import pyarrow as pa
import pyarrow.compute as pc

from benchmark import reference


def take(result, keep: bool) -> dict:
    """In the window: the result table is on the host; keep it if sampled."""
    return {"rows": result.num_rows, "kept": result.arrow if keep else None}


def _offs(t: pa.Table, probe, counts, bases) -> tuple:
    names = pa.array(list(probe.names), pa.string())
    code = pc.fill_null(pc.index_in(t.column("contig"), value_set=names), -1).to_numpy()
    same = ((code == probe.code) & (t.column("pos_start").to_numpy() == probe.start)
            & (t.column("pos_end").to_numpy() == probe.end))
    return (int((~same).sum()),
            int((t.column("count").to_numpy() != counts).sum()),
            int((t.column("bases").to_numpy() != bases).sum()))


def judge(run) -> dict:
    probe_name, build_name = run.traffic["join"]
    probe, build = run.inputs.tables[probe_name], run.inputs.tables[build_name]
    counts, bases = reference.coverage(probe, build)
    pairs = int(counts.sum())
    worst = {"rows_off": 0, "probe_off": 0, "count_off": 0, "bases_off": 0}
    judged = answered = 0
    for q in run.queries:
        q["pairs"] = pairs
        if "answer" not in q:
            continue
        a = q["answer"]
        answered += 1
        worst["rows_off"] = max(worst["rows_off"], abs(a["rows"] - probe.rows))
        q["wrong"] = a["rows"] != probe.rows
        if a["kept"] is not None and a["rows"] == probe.rows:
            judged += 1
            offs = _offs(a["kept"], probe, counts, bases)
            for k, v in zip(("probe_off", "count_off", "bases_off"), offs):
                worst[k] = max(worst[k], v)
            q["wrong"] = q["wrong"] or any(offs)
        a["kept"] = None
    checks = {k: (v, 0) for k, v in worst.items()}
    checks["unjudged"] = (max(min(run.traffic.get("keep", 0), answered) - judged, 0), 0)
    return checks
