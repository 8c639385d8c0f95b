"""Port parity: Partitioned mode through SQL (``SET
datafusion.execution.target_partitions = N``), sequila_tpu_torch on the
CPU against the JAX package on the conftest's 8-device virtual mesh.

The matrix of tests/test_partitioned_sql.py: the EXPLAIN text, inner,
LEFT, RIGHT and FULL joins, strict operators, nearest, the grouped count,
low memory with max_output_batch_size 7, filter pushdown, the NLJ without
an equi-key staying CollectLeft, every distribution (auto, hash, shuffle,
skew) and auto routing a skewed table to skew.  Each query runs in one
session of each package on the same arrow tables; rows compare exactly
(sorted where the query orders nothing), and the ``distribution_<name>``
metric the operator records must be the same in both packages.  Both
packages build a (2, 2) mesh at target_partitions = 4 and a (2, 4) mesh
at 8 from the same XLA_FLAGS.  The tests marked ``cuda`` run the port on
the card against the port on the CPU."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu.session import SessionContext as JaxSession
from sequila_tpu_torch.session import SessionContext as TorchSession

OVERLAP_ON = (
    "ON s1.contig = s2.contig AND s1.pos_end >= s2.pos_start "
    "AND s1.pos_start <= s2.pos_end"
)
COUNT = f"SELECT count(1) FROM s1 JOIN s2 {OVERLAP_ON}"
PAIRS = f"SELECT s1.pos_start, s1.pos_end, s2.pos_start, s2.pos_end FROM s1 JOIN s2 {OVERLAP_ON}"
DISTS = ["auto", "hash", "shuffle", "skew"]


def _table(n, seed, num_keys=5, span=10_000, maxlen=500, hot=0.0, deg=0.0, nulls=0.0):
    """Random intervals: ``hot`` of the rows on chr0, ``deg`` degenerate
    (end < start) rows, ``nulls`` NULL contigs."""
    r = np.random.default_rng(seed)
    k = np.where(r.random(n) < hot, 0, r.integers(0, num_keys, n))
    st = r.integers(0, span, n)
    en = st + r.integers(0, maxlen, n)
    en = np.where(r.random(n) < deg, st - r.integers(1, 20, n), en)
    contig = [None if x < nulls else f"chr{i}" for i, x in zip(k, r.random(n))]
    return pa.table({"contig": contig, "pos_start": st, "pos_end": en})


TABLES = {
    "plain": lambda: (_table(400, 1), _table(600, 2)),
    "small": lambda: (_table(150, 3, num_keys=8), _table(200, 4, num_keys=8)),
    # degenerate probes, inverted builds and NULL keys on both sides
    "dirty": lambda: (_table(300, 5, deg=0.05, nulls=0.05), _table(400, 6, deg=0.05, nulls=0.05)),
    # one hot key: 90 % of both sides on chr0
    "hot": lambda: (_table(300, 7, num_keys=4, span=2_000, hot=0.9),
                    _table(500, 8, num_keys=4, span=2_000, hot=0.9)),
}


def _session(pkg, tables, partitions, setup):
    ctx = JaxSession() if pkg == "jax" else TorchSession(device="cpu")
    t1, t2 = TABLES[tables]()
    ctx.register_table("s1", t1)
    ctx.register_table("s2", t2)
    if partitions > 1:
        ctx.sql(f"SET datafusion.execution.target_partitions = {partitions}")
    for s in setup:
        ctx.sql(s)
    return ctx


def _distributions(ctx) -> list[str]:
    return sorted(k for c in ctx.last_metrics.counters.values() for k in c
                  if k.startswith("distribution_"))


def _both(query, tables="plain", setup=(), partitions=4, ordered=False):
    """(port rows, JAX rows, port distribution metrics, JAX ones) of one
    query; rows sorted unless ``ordered``."""
    out = []
    for pkg in ("torch", "jax"):
        ctx = _session(pkg, tables, partitions, setup)
        rows = [tuple(r.values()) for r in ctx.sql(query).to_pylist()]
        key = lambda r: tuple((x is None, x) for x in r)  # noqa: E731
        out.append((rows if ordered else sorted(rows, key=key), _distributions(ctx)))
    (got, got_d), (want, want_d) = out
    return got, want, got_d, want_d


def test_explain_shows_partitioned_mode():
    for pkg in ("torch", "jax"):
        ctx = _session(pkg, "plain", 4, ["SET sequila.partitioned_distribution = shuffle"])
        plan = ctx.sql(f"EXPLAIN {COUNT}").column_np(1)[0]
        assert "IntervalJoinExec: mode=Partitioned(shuffle)" in plan, pkg
        ctx.sql("SET datafusion.execution.target_partitions = 1")
        assert "IntervalJoinExec: mode=CollectLeft" in ctx.sql(f"EXPLAIN {COUNT}").column_np(1)[0]


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("tables", ["plain", "dirty", "hot"])
def test_count_every_distribution(tables, dist):
    got, want, got_d, want_d = _both(COUNT, tables, [f"SET sequila.partitioned_distribution = {dist}"])
    assert got == want and got_d == want_d and len(got_d) == 1


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("tables", ["plain", "dirty", "hot"])
def test_select_every_distribution(tables, dist):
    got, want, got_d, want_d = _both(PAIRS, tables, [f"SET sequila.partitioned_distribution = {dist}"])
    assert got == want and len(got) > 0
    assert got_d == want_d and len(got_d) == 1


def test_select_star_in_probe_order():
    """SELECT * over the mesh keeps the probe order contract: equal to the
    JAX package's rows in its own order, not only as a set."""
    got, want, _, _ = _both(f"SELECT * FROM s1 JOIN s2 {OVERLAP_ON}", "small",
                            ["SET sequila.partitioned_distribution = hash"], ordered=True)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("jt", ["LEFT", "RIGHT", "FULL"])
def test_outer_joins(jt):
    q = f"SELECT s1.pos_start, s2.pos_end FROM s1 {jt} JOIN s2 {OVERLAP_ON}"
    got, want, got_d, want_d = _both(q, "small")
    assert got == want and any(None in r for r in got) and got_d == want_d


def test_strict_operators():
    q = ("SELECT count(1) FROM s1 JOIN s2 ON s1.contig = s2.contig "
         "AND s1.pos_end > s2.pos_start AND s1.pos_start < s2.pos_end")
    got, want, got_d, want_d = _both(q)
    assert got == want and got_d == want_d


@pytest.mark.parametrize("dist", ["auto", "hash", "skew"])
def test_nearest(dist):
    q = f"SELECT s1.pos_start, s1.pos_end, s2.pos_start, s2.pos_end FROM s1 JOIN s2 {OVERLAP_ON}"
    setup = ["SET sequila.interval_join_algorithm = coitreesnearest",
             f"SET sequila.partitioned_distribution = {dist}"]
    got, want, got_d, want_d = _both(q, "hot", setup, ordered=True)
    assert got == want and len(got) == 500  # one row a probe row
    assert got_d == want_d


def test_grouped_count():
    q = (f"SELECT s2.contig, count(1) AS c FROM s1 JOIN s2 {OVERLAP_ON} "
         "GROUP BY s2.contig ORDER BY s2.contig")
    got, want, _, _ = _both(q, "dirty", ordered=True)
    assert got == want and len(got) > 1


@pytest.mark.parametrize("dist", ["hash", "shuffle", "skew"])
def test_low_memory_batch_7(dist):
    """low memory drains the shards through capped chunks (4 x 7 pair
    slots a chunk); the rows are the JAX package's."""
    setup = [f"SET sequila.partitioned_distribution = {dist}",
             "SET sequila.interval_join_low_memory = true",
             "SET sequila.max_output_batch_size = 7"]
    got, want, got_d, want_d = _both(PAIRS, "small", setup)
    assert got == want and len(got) > 28 and got_d == want_d


def test_sql_batches_slices_the_partitioned_pairs():
    """execute_batches over the mesh: batches of at most 4 x 7 rows whose
    union is the JAX package's streamed rows."""
    out = []
    for pkg in ("torch", "jax"):
        ctx = _session(pkg, "small", 4, ["SET sequila.max_output_batch_size = 7"])
        batches = list(ctx.sql_batches(PAIRS))
        out.append(([b.num_rows for b in batches],
                    sorted(tuple(r.values()) for b in batches for r in b.to_pylist())))
    (sizes, got), (_, want) = out
    assert got == want and len(sizes) > 1 and max(sizes) <= 28


def test_filter_pushdown():
    got, want, got_d, want_d = _both(f"{COUNT} WHERE s1.contig = 'chr1'")
    assert got == want and got[0][0] > 0 and got_d == want_d


def test_no_equi_key_nlj_stays_collect_left():
    q = ("SELECT count(1) FROM s1 JOIN s2 ON "
         "s1.pos_end >= s2.pos_start AND s1.pos_start <= s2.pos_end")
    for pkg in ("torch", "jax"):
        ctx = _session(pkg, "small", 8, [])
        assert "IntervalJoinExec: mode=CollectLeft" in ctx.sql(f"EXPLAIN {q}").column_np(1)[0]
    got, want, _, _ = _both(q, "small", partitions=8)
    assert got == want


@pytest.mark.parametrize("partitions", [4, 8])
def test_auto_routes_a_skewed_table_to_skew(partitions):
    """auto picks skew for a dominant key in both packages, and EXPLAIN
    ANALYZE shows the choice."""
    got, want, got_d, want_d = _both(COUNT, "hot", partitions=partitions)
    assert got == want and got_d == want_d == ["distribution_skew"]
    ctx = _session("torch", "hot", partitions, [])
    assert "distribution_skew=1" in ctx.sql(f"EXPLAIN ANALYZE {COUNT}").column_np(1)[0]


def test_partitioned_equals_single_device():
    """The port's Partitioned answer equals its own CollectLeft answer."""
    for q in (COUNT, PAIRS):
        rows = []
        for parts in (1, 4):
            ctx = _session("torch", "dirty", parts, [])
            rows.append(sorted(tuple(r.values()) for r in ctx.sql(q).to_pylist()))
        assert rows[0] == rows[1]


@pytest.fixture(params=["engine", "repeated"])
def cuda_session(request, monkeypatch):
    """Sessions at target_partitions = 4: on the card over the engine's
    mesh, or over a (2, 2) mesh that repeats the first card (every
    multi-shard path on one card); on the CPU over the (2, 2) CPU mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sequila_tpu_torch.parallel import engine
    from sequila_tpu_torch.parallel.mesh import make_mesh

    if request.param == "repeated":
        engine_mesh = engine.get_engine_mesh
        repeated = make_mesh([torch.device("cuda", 0)] * 4)

        def get_engine_mesh(target, device):
            if torch.device(device).type == "cuda" and target > 1:
                return repeated
            return engine_mesh(target, device)

        monkeypatch.setattr(engine, "get_engine_mesh", get_engine_mesh)

    def make(device, tables, dist):
        ctx = TorchSession(device=device)
        t1, t2 = TABLES[tables]()
        ctx.register_table("s1", t1)
        ctx.register_table("s2", t2)
        ctx.sql("SET datafusion.execution.target_partitions = 4")
        ctx.sql(f"SET sequila.partitioned_distribution = {dist}")
        return ctx

    return make


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS)
def test_cuda_count_and_select_equal_cpu(cuda_session, dist):
    """A partitioned count and SELECT * on the card equal the CPU's (rows
    sorted: a probe row's matches come in its shard's emission order,
    which follows the mesh's shape), with the same distribution metric
    when both meshes have the same shape."""
    for q in (COUNT, f"SELECT * FROM s1 JOIN s2 {OVERLAP_ON}"):
        cuda, cpu = cuda_session("cuda", "hot", dist), cuda_session("cpu", "hot", dist)
        got, want = cuda.sql(q).to_pylist(), cpu.sql(q).to_pylist()
        assert sorted(map(repr, got)) == sorted(map(repr, want)) and len(got) > 0
        if dist != "auto":
            assert _distributions(cuda) == _distributions(cpu)
