"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything is found by name.  A cell (``workloads`` entry) names a
configuration, whose file of sizes and seeds is given in ``configs``, and a
traffic mix, ``benchmark/traffic/<traffic>.json``.  The traffic names its
query, the two tables it joins, the kind of answer
(``benchmark/answers/<kind>.py``: how an answer is taken in the window and
judged after it), which table, if any, is registered afresh for every
query, how many answers are kept whole for the check, and the name of the
span around parse and plan (``plan_span``, ``front_end`` unless the plan
does more, as a table function's does).  A per-layer metric is read by
``benchmark/metrics/<name>.py``.  A new cell, configuration, traffic mix
or metric is new files and new entries; no file here changes.

A run: inputs from ``--seed`` (set-up), a session on the card, one
warm-up query (set-up), then a closed loop of one client for
``--seconds``: each query is issued through ``SessionContext.sql`` when
the last has come back to the host.  With ``trace`` the loop drives the
session's own two steps, its physical plan and then its execution,
inside the harness's spans (the plan span, ``execute``, ``client``)
under ``torch.profiler``.  Once the window has closed and the program's
state is freed, the answers are judged against the NumPy reference
(``benchmark/reference.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np

from benchmark import gen, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sequila_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(name: str, root: str = ROOT) -> Cell:
    m = manifest(root)
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, c["file"]))
    traffic = _json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(w, config, traffic, [x for x in m["end_to_end"] if mine(x)],
                [x for x in m["per_layer"] if mine(x)])


def answer_kind(kind: str):
    return importlib.import_module(f"benchmark.answers.{kind}")


def metric_reader(name: str, root: str = ROOT):
    """``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Inputs:
    tables: dict  # name -> gen.Intervals, as the reference sees them
    arrow: dict  # name -> pyarrow table, as the program is given them
    fresh: str | None = None  # table registered afresh for every query
    pool: gen.Intervals | None = None  # rows the fresh windows are cut from
    pool_arrow: object = None

    def window(self, offset: int):
        n = self.tables[self.fresh].rows
        return self.pool_arrow.slice(offset, n)


def make_inputs(config: dict, traffic: dict, seed: int, scale: int = 1) -> Inputs:
    """The cell's tables from ``--seed``: table seed = its ``seed`` +
    ``seed_stride`` * ``--seed`` (the configuration's rule).  ``scale``
    divides every row count (the CPU tests' small sizes)."""
    make = gen.GENERATORS[config["generator"]]
    params = config.get("params", {})
    fresh = traffic.get("fresh")
    tables, arrow, pool = {}, {}, None
    for name, spec in config["tables"].items():
        rows = max(spec["rows"] // scale, 1)
        tseed = spec["seed"] + config["seed_stride"] * seed
        if fresh and name == fresh["table"]:
            pool = make(rows * fresh["pool_factor"], tseed, **params)
            tables[name] = pool.slice(0, rows)
        else:
            tables[name] = make(rows, tseed, **params)
            arrow[name] = tables[name].arrow()
    if pool is None:
        return Inputs(tables, arrow)
    return Inputs(tables, arrow, fresh["table"], pool, pool.arrow())


@dataclasses.dataclass
class Run:
    """What a run saw, for the answers' judges and the metric readers."""
    cell: Cell
    inputs: Inputs
    seed: int
    traced: bool
    queries: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)  # (name, start_ns, end_ns)
    window_s: float = 0.0
    window_ns: tuple = (0, 0)
    device_events: list | None = None
    busy_s: float | None = None
    idle: list | None = None
    memory_window_peak: int | None = None

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


class Reservoir:
    """Which queries keep their answer whole for the check: ``keep`` of
    them, drawn from the seed uniformly among all that the window issues
    (Algorithm R).  The choice is made before a query is issued; a query
    that leaves the sample has its kept answer dropped at once."""

    def __init__(self, keep: int, seed: int):
        self.keep, self.slots = keep, []
        self.rng = np.random.default_rng([seed, 1])

    def admit(self, i: int, queries: list) -> bool:
        if len(self.slots) < self.keep:
            self.slots.append(i)
            return True
        if not self.keep:
            return False
        j = int(self.rng.integers(0, i + 1))
        if j >= self.keep:
            return False
        old = queries[self.slots[j]].get("answer")
        if old is not None:
            old["kept"] = None
        self.slots[j] = i
        return True


class _Loop:
    """Issues the traffic's queries against one session."""

    def __init__(self, run: Run, session, device, torch):
        self.run, self.session, self.device, self.torch = run, session, device, torch
        t = run.traffic
        self.text = t["query"]
        self.plan_span = t.get("plan_span", "front_end")
        self.answer = answer_kind(t["answer"])
        self.offsets = np.random.default_rng([run.seed, 2])
        self.n_fresh = run.inputs.tables[run.inputs.fresh].rows if run.inputs.fresh else 0
        self.last_end = None  # end of the last traced query (time.time_ns)

    def _register_fresh(self, q: dict) -> None:
        inp = self.run.inputs
        if inp.fresh is None:
            return
        off = int(self.offsets.integers(0, inp.pool.rows - self.n_fresh + 1))
        q["offset"] = off
        self.session.register_table(inp.fresh, inp.window(off))

    def plain(self, q: dict, keep: bool) -> None:
        self._register_fresh(q)
        q["answer"] = self.answer.take(self.session.sql(self.text), keep)

    def traced(self, q: dict, keep: bool, spans: list) -> None:
        """The session's own steps, as ``sql`` takes them for one SELECT,
        inside spans; the execute span ends on a synchronise."""
        from sequila_tpu_torch.exec.context import ExecContext
        from sequila_tpu_torch.sql.parser import parse_sql

        c0 = self.last_end or time.time_ns()
        self._register_fresh(q)
        t0 = time.time_ns()
        plan = self.session.create_physical_plan(parse_sql(self.text)[-1])
        t1 = time.time_ns()
        ectx = ExecContext(self.session.config.copy())
        q["answer"] = self.answer.take(plan.execute(ectx), keep)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        t2 = self.last_end = time.time_ns()
        spans += [("client", c0, t0), (self.plan_span, t0, t1), ("execute", t1, t2)]
        q[f"{self.plan_span}_s"] = (t1 - t0) / 1e9
        q["execute_s"] = (t2 - t1) / 1e9
        q["routes"] = sorted(k for c in ectx.metrics.counters.values() for k in c
                             if "_route_" in k)


def _window(run: Run, loop: _Loop, seconds: float, torch, device) -> None:
    prof = None
    if run.traced and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    sample = Reservoir(run.traffic.get("keep", 0), run.seed)
    i = 0
    while True:
        q = {"i": i}
        keep = sample.admit(i, run.queries)
        s = time.perf_counter()
        try:
            if run.traced:
                loop.traced(q, keep, run.spans)
            else:
                loop.plain(q, keep)
        except Exception:  # a query that fails is counted and the loop goes on
            q.pop("answer", None)
            q["error"] = traceback.format_exc(limit=4)
            print(q["error"], file=sys.stderr)
        e = time.perf_counter()
        q["latency_s"] = e - s
        run.queries.append(q)
        i += 1
        if e >= deadline:
            break
    run.window_s = e - t0
    run.window_ns = (start_ns, start_ns + int(run.window_s * 1e9))
    if device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_window_peak = torch.cuda.max_memory_allocated()
    if prof is not None:
        prof.stop()
        lo, hi = run.window_ns
        run.device_events = [ev for ev in tracing.device_events(prof) if ev[2] > lo and ev[1] < hi]
        busy = tracing.busy_intervals(run.device_events, lo, hi)
        run.busy_s = sum(e - s for s, e in busy) / 1e9
        run.idle = tracing.idle_intervals(busy, lo, hi)
        del prof


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, each
    compared whole (``sequila_tpu_torch`` is not ``sequila_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", scale: int = 1, root: str = ROOT) -> dict:
    """One run; returns {"result": the result line's object, "checks":
    {name: (value, limit)}, "run": the Run}."""
    c = cell(name, root)
    settings = c.traffic.get("settings", {})
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update({k: str(v) for k, v in settings.items()})
    try:
        return _run_cell(c, seed, seconds, trace, t_start, device, scale, root)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_cell(c: Cell, seed, seconds, trace, t_start, device, scale, root) -> dict:
    import torch

    from sequila_tpu_torch.session import SessionContext

    dev = torch.device(device)
    inputs = make_inputs(c.config, c.traffic, seed, scale)
    run = Run(c, inputs, seed, trace)
    session = SessionContext(device=device)
    for tname, t in inputs.arrow.items():
        session.register_table(tname, t)
    loop = _Loop(run, session, dev, torch)
    loop.plain({}, False)  # warm-up: the cell's own query, once
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    _window(run, loop, seconds, torch, dev)
    memory_peak = None
    if dev.type == "cuda":
        memory_peak = max(torch.cuda.max_memory_allocated(), run.memory_window_peak)
    del loop, session
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    checks = answer_kind(c.traffic["answer"]).judge(run)
    judge_s = time.perf_counter() - t_judge
    failed = sum(1 for q in run.queries if "error" in q or q.get("wrong"))
    checks = {"failed": (failed, 0), **checks}
    correct = all(v <= lim for v, lim in checks.values())

    lat = [q["latency_s"] for q in run.queries]
    done = [q for q in run.queries if "answer" in q]
    values = {
        "pairs_per_s": sum(q["pairs"] for q in done) / run.window_s,
        "query_p50_ms": statistics.median(lat) * 1e3,
        "query_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "setup_s": setup_s,
    }
    wanted = c.per_layer if trace else c.end_to_end
    metrics = {}
    for m in wanted:
        v = values.get(m["name"]) if not trace else metric_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "count": c.workload["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(run.queries), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace and run.busy_s is not None:
        dev_info["busy_s"] = run.busy_s
        dev_info["window_s"] = run.window_s
        result["breakdown"] = tracing.breakdown(run.device_events, run.idle, run.spans)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    timing = {"setup_s": setup_s, "window_s": run.window_s, "judge_s": judge_s}
    return {"result": result, "checks": checks, "run": run, "timing": timing}
