"""Port parity: streamed join output (sql_batches, COPY ... TO) of
sequila_tpu_torch vs sequila_tpu (the operator cases of
tests/test_streaming.py on the port's session).

The same arrow tables are registered in a JAX SessionContext and in the
port's SessionContext(device="cpu").  Contracts:
- concatenated sql_batches equal sql() in the port, and equal the JAX
  package's result: row for row on the device route (both emit
  probe-major, level-minor), as sorted rows on the host route;
- batches are bounded by ~4x max_output_batch_size on both routes;
- filters, projections and limits forward the join's batching;
- COPY of a query streams to parquet, CSV and a parquet directory and reads
  back to the whole-query result; empty results keep their schema;
- barrier plans and outer joins fall back to one batch;
- the operator's metrics count the streamed rows, and the fused native
  emission equals the pair + take path.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest

from sequila_tpu.session import SessionContext as JaxSession
from sequila_tpu_torch.exec.joins import interval_join as tij
from sequila_tpu_torch.session import SessionContext as TorchSession

Q_JOIN = (
    "SELECT s2.pos_start, s2.pos_end, s1.pos_start, s1.pos_end "
    "FROM s1 JOIN s2 ON s1.contig = s2.contig "
    "AND s1.pos_end >= s2.pos_start AND s1.pos_start <= s2.pos_end"
)
Q_STAR = Q_JOIN.replace("SELECT s2.pos_start, s2.pos_end, s1.pos_start, s1.pos_end",
                        "SELECT *")


def _mk(k, s, e):
    return pa.table({
        "contig": np.asarray([f"chr{int(i)}" for i in k], dtype=object),
        "pos_start": np.asarray(s, np.int64),
        "pos_end": np.asarray(e, np.int64),
    })


def _sessions(rng, n, m):
    """A JAX session and a port session over the same two tables."""
    ls = rng.integers(0, 25 * n, n)
    rs = rng.integers(0, 25 * n, m)
    s1 = _mk(rng.integers(0, 4, n), ls, ls + rng.integers(1, 400, n))
    s2 = _mk(rng.integers(0, 4, m), rs, rs + rng.integers(1, 400, m))
    jax_ctx, torch_ctx = JaxSession(), TorchSession(device="cpu")
    for ctx in (jax_ctx, torch_ctx):
        ctx.register_table("s1", s1)
        ctx.register_table("s2", s2)
    return jax_ctx, torch_ctx


def _route_sessions(route, rng, monkeypatch):
    """Sessions whose joins take ``route``: the host route at the default
    threshold, the device route with SEQUILA_HOST_THRESHOLD=0 (smaller
    tables: the JAX package interprets its Pallas kernel on the CPU)."""
    if route == "device":
        monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
        return _sessions(rng, 600, 700)
    return _sessions(rng, 3000, 3000)


@pytest.fixture
def host_ctxs(rng, monkeypatch):
    return _route_sessions("host", rng, monkeypatch)


@pytest.fixture
def device_ctxs(rng, monkeypatch):
    return _route_sessions("device", rng, monkeypatch)


def _concat(batches):
    return pa.concat_tables([b.arrow for b in batches])


def _rows_sorted(t: pa.Table):
    """Rows as a sorted list (NULLs of an outer join sort first)."""
    rows = zip(*[c.to_pylist() for c in t.columns])
    return sorted(rows, key=lambda r: [(v is not None, v) for v in r])


def _route(ctx) -> str:
    routes = [k for c in ctx.last_metrics.counters.values() for k in c
              if k.startswith("emit_route_")]
    assert len(routes) == 1
    return routes[0][len("emit_route_"):]


@pytest.mark.parametrize("route", ["host", "device"])
def test_sql_batches_equals_sql(route, rng, monkeypatch):
    jax_ctx, ctx = _route_sessions(route, rng, monkeypatch)
    whole = ctx.sql(Q_JOIN).arrow
    want = jax_ctx.sql(Q_JOIN).arrow
    ctx.sql("SET sequila.max_output_batch_size = 100")
    batches = list(ctx.sql_batches(Q_JOIN))
    assert _route(ctx) == ("host" if route == "host" else "merge")
    assert len(batches) > 1, "expected bounded multi-batch streaming"
    # every batch bounded; only a single probe row alone may exceed the cap
    assert all(b.num_rows <= 400 for b in batches)
    got = _concat(batches)
    assert got.equals(whole)
    if route == "device":
        assert got.equals(want)  # device routes emit in the same order
    else:
        assert _rows_sorted(got) == _rows_sorted(want)


@pytest.mark.parametrize("backend", ["merge", "cosort"])
def test_sql_batches_device_select_star(device_ctxs, monkeypatch, backend):
    """SELECT * streamed on the device route equals the JAX package's
    streamed result row for row, on both emission backends."""
    monkeypatch.setenv("SEQUILA_EMIT_BACKEND", backend)
    jax_ctx, ctx = device_ctxs
    for c in (jax_ctx, ctx):
        c.sql("SET sequila.max_output_batch_size = 100")
    got = list(ctx.sql_batches(Q_STAR))
    assert _route(ctx) == ("merge" if backend == "merge" else "sort")
    want = _concat(list(jax_ctx.sql_batches(Q_STAR)))
    assert len(got) > 1 and _concat(got).equals(want)


def test_sql_batches_filter_project_forwarding(host_ctxs):
    jax_ctx, ctx = host_ctxs
    q = (
        "SELECT s2.pos_start + 1 AS a FROM s1 JOIN s2 "
        "ON s1.contig = s2.contig AND s1.pos_end >= s2.pos_start "
        "AND s1.pos_start <= s2.pos_end WHERE s2.pos_start % 3 = 0"
    )
    whole = ctx.sql(q).arrow
    ctx.sql("SET sequila.max_output_batch_size = 100")
    batches = list(ctx.sql_batches(q))
    assert len(batches) > 1, "filter/project should forward join batching"
    got = _concat(batches)
    assert got.column("a").to_pylist() == whole.column("a").to_pylist()
    assert sorted(got.column("a").to_pylist()) == sorted(jax_ctx.sql(q).column_np("a").tolist())


@pytest.mark.parametrize("route", ["host", "device"])
def test_sql_batches_limit_early_stop(route, rng, monkeypatch):
    jax_ctx, ctx = _route_sessions(route, rng, monkeypatch)
    q = Q_JOIN + " LIMIT 700 OFFSET 100"
    whole = ctx.sql(q).arrow
    ctx.sql("SET sequila.max_output_batch_size = 50")
    batches = list(ctx.sql_batches(q))
    got = _concat(batches)
    assert got.num_rows == sum(b.num_rows for b in batches) == 700
    assert got.equals(whole)
    if route == "device":
        assert got.equals(jax_ctx.sql(q).arrow)


def test_sql_batches_single_batch_fallbacks(host_ctxs):
    """Aggregates, sorts and outer joins: one batch, the same result."""
    jax_ctx, ctx = host_ctxs
    ctx.sql("SET sequila.max_output_batch_size = 100")
    for q in (
        "SELECT count(1) FROM s1 JOIN s2 ON s1.contig = s2.contig "
        "AND s1.pos_end >= s2.pos_start AND s1.pos_start <= s2.pos_end",
        Q_JOIN + " ORDER BY 1, 2, 3, 4",
        Q_JOIN.replace(" JOIN ", " LEFT JOIN ", 1),
    ):
        whole = ctx.sql(q).arrow
        batches = list(ctx.sql_batches(q))
        assert len(batches) == 1
        assert batches[0].arrow.equals(whole)
        assert _rows_sorted(whole) == _rows_sorted(jax_ctx.sql(q).arrow)


def test_sql_batches_set_and_ddl_prefix(host_ctxs):
    _, ctx = host_ctxs
    batches = list(ctx.sql_batches("SET sequila.max_output_batch_size = 100; " + Q_JOIN))
    assert len(batches) > 1
    assert ctx.config.max_output_batch_size == 100


def test_sql_batches_empty_result(device_ctxs):
    jax_ctx, ctx = device_ctxs
    q = Q_JOIN.replace("s1.pos_end >= s2.pos_start", "s1.pos_end >= s2.pos_start + 100000000")
    batches = list(ctx.sql_batches(q))
    want = jax_ctx.sql(q).arrow
    assert len(batches) == 1 and batches[0].num_rows == 0 == want.num_rows
    assert batches[0].arrow.schema.names == want.schema.names


@pytest.mark.parametrize("route", ["host", "device"])
def test_copy_query_to_parquet_streams(route, rng, monkeypatch, tmp_path):
    jax_ctx, ctx = _route_sessions(route, rng, monkeypatch)
    whole = jax_ctx.sql(Q_JOIN).arrow
    ctx.sql("SET sequila.max_output_batch_size = 100")
    out = tmp_path / "out.parquet"
    res = ctx.sql(f"COPY ({Q_JOIN}) TO '{out}'")
    assert int(res.column_np(0)[0]) == whole.num_rows
    # several row groups show that the incremental writer streamed
    assert pq.ParquetFile(out).num_row_groups > 1
    assert _rows_sorted(pq.read_table(out)) == _rows_sorted(whole)


def test_copy_query_to_csv_streams(host_ctxs, tmp_path):
    jax_ctx, ctx = host_ctxs
    whole = jax_ctx.sql(Q_JOIN).arrow
    ctx.sql("SET sequila.max_output_batch_size = 100")
    out = tmp_path / "out.csv"
    res = ctx.sql(f"COPY ({Q_JOIN}) TO '{out}'")
    assert int(res.column_np(0)[0]) == whole.num_rows
    assert _rows_sorted(pacsv.read_csv(out)) == _rows_sorted(whole)


def test_copy_query_to_parquet_directory(device_ctxs, tmp_path):
    """Directory sink: the writer pool fans out part files whose dataset
    reads back to the whole SELECT * result."""
    jax_ctx, ctx = device_ctxs
    whole = jax_ctx.sql(Q_STAR).arrow
    ctx.sql("SET sequila.max_output_batch_size = 100")
    out = str(tmp_path / "parts") + "/"
    res = ctx.sql(f"COPY ({Q_STAR}) TO '{out}' STORED AS PARQUET")
    assert int(res.column_np(0)[0]) == whole.num_rows
    assert [f for f in os.listdir(out) if f.endswith(".parquet")]
    back = pq.read_table(out)
    assert back.num_rows == whole.num_rows
    key = [c.cast(pa.string()).to_pylist() if pa.types.is_dictionary(c.type) else c.to_pylist()
           for c in back.columns]
    want = [c.cast(pa.string()).to_pylist() if pa.types.is_dictionary(c.type) else c.to_pylist()
            for c in whole.columns]
    assert sorted(zip(*key)) == sorted(zip(*want))


def test_copy_empty_result_writes_schema(device_ctxs, tmp_path):
    _, ctx = device_ctxs
    out = tmp_path / "empty.parquet"
    q = Q_JOIN + " WHERE s2.pos_start < -1"
    res = ctx.sql(f"COPY ({q}) TO '{out}'")
    assert int(res.column_np(0)[0]) == 0
    back = pq.read_table(out)
    assert back.num_rows == 0 and back.num_columns == 4


@pytest.mark.parametrize("route", ["host", "device"])
def test_streaming_metrics_output_rows(route, rng, monkeypatch):
    _, ctx = _route_sessions(route, rng, monkeypatch)
    ctx.sql("SET sequila.max_output_batch_size = 100")
    total = sum(t.num_rows for t in ctx.sql_batches(Q_JOIN))
    ops = [k for k in ctx.last_metrics.counters if k.startswith("IntervalJoinExec")]
    assert ops and total > 0
    assert ctx.last_metrics.counters[ops[0]]["output_rows"] == total


def test_fused_emission_parity(host_ctxs, monkeypatch):
    """The fused native emission equals the pair + take path, whole and
    streamed, SELECT * included (dictionary contig columns)."""
    _, ctx = host_ctxs
    for q in (Q_JOIN, Q_STAR):
        monkeypatch.setenv("SEQUILA_FUSED_EMIT", "0")
        whole_plain = ctx.sql(q).arrow
        monkeypatch.setenv("SEQUILA_FUSED_EMIT", "1")
        assert ctx.sql(q).arrow.equals(whole_plain)
        ctx.sql("SET sequila.max_output_batch_size = 100")
        assert _concat(list(ctx.sql_batches(q))).equals(whole_plain)
        ctx.sql("SET sequila.max_output_batch_size = 100000")
    assert any(pa.types.is_dictionary(t) for t in whole_plain.schema.types)


def test_materialize_route_host_defaults(monkeypatch):
    """The measured defaults keep every measured pairing (the 15M-row
    SELECT *, the chr1 pair, and the genome build against 100,000 and
    1,000,000 probe rows) on the host route; the overrides move it."""
    for var in ("SEQUILA_HOST_THRESHOLD", "SEQUILA_LINK_RTT", "SEQUILA_LINK_BW"):
        monkeypatch.delenv(var, raising=False)
    assert tij.materialize_route_host(20_000, 300_000)
    assert tij.materialize_route_host(207_146, 302_381)
    assert tij.materialize_route_host(2_350_965, 100_000)
    assert tij.materialize_route_host(2_350_965, 1_000_000)
    assert tij.materialize_route_host(100, 100)  # under the threshold
    monkeypatch.setenv("SEQUILA_LINK_BW", "1e12")
    assert not tij.materialize_route_host(20_000, 300_000)
    monkeypatch.setenv("SEQUILA_LINK_RTT", "10")
    assert tij.materialize_route_host(20_000, 300_000)
    monkeypatch.setenv("SEQUILA_HOST_THRESHOLD", "0")
    assert not tij.materialize_route_host(100, 100)
