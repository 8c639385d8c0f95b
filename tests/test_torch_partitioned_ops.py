"""Port parity: the Partitioned-mode programs of sequila_tpu_torch.parallel
against sequila_tpu.parallel on the conftest's 8-device virtual mesh.

Each program of the port runs on a CPU mesh of the same (part, probe)
shape (part = 2 and 4 over 8 devices, as the JAX package's tests split
them) and must equal the JAX package's result on the same numpy inputs:
counts exactly, pairs as sorted pair sets, nearest picks, per-probe counts
and coverage element by element.  Two inputs, both with one hot key: a
clean one, and one with degenerate probes, inverted builds and the NULL
key codes (-1 build side, -2 probe side) of models/table.encode_join_keys.
The shuffle count and the skew programs take only the clean input (their
rank arithmetic needs non-degenerate probes, non-inverted builds and
non-negative codes, and the operator routes other inputs to hash); the
per-probe counts and coverage have a hash program only, in both packages.
The port runs each with both rank strategies (SEQUILA_MESH_BOUNDS).  The
JAX results are computed once per module."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import sequila_tpu.ops.interval_join as jij
import sequila_tpu.parallel.partitioned_join as jpj
import sequila_tpu.parallel.shuffle as jsh
import sequila_tpu.parallel.skew as jsk
import sequila_tpu_torch.ops.interval_join as tij
import sequila_tpu_torch.parallel.partitioned_join as tpj
import sequila_tpu_torch.parallel.shuffle as tsh
import sequila_tpu_torch.parallel.skew as tsk
from sequila_tpu.errors import ExecutionError as JaxExecutionError
from sequila_tpu.parallel import engine as jengine
from sequila_tpu.parallel.mesh import make_mesh as jax_mesh
from sequila_tpu_torch.errors import ExecutionError
from sequila_tpu_torch.parallel import engine as tengine
from sequila_tpu_torch.parallel.mesh import make_mesh

CPU8 = [torch.device("cpu")] * 8


def _inputs(name):
    """(lk, ls, le, rk, rs, re) of one input, from a fixed seed."""
    r = np.random.default_rng({"clean": 11, "dirty": 12, "dense": 13}[name])
    n, m = 300, 400
    if name == "dense":  # one key, every pair overlapping: 60,000 pairs
        lk, rk = np.zeros(200, np.int32), np.zeros(300, np.int32)
        ls = r.integers(0, 100, 200).astype(np.int32)
        rs = r.integers(0, 100, 300).astype(np.int32)
        return lk, ls, ls + 10_000, rk, rs, rs + 10_000
    lk = np.where(r.random(n) < 0.6, 0, r.integers(1, 6, n)).astype(np.int32)
    rk = np.where(r.random(m) < 0.6, 0, r.integers(1, 8, m)).astype(np.int32)
    ls = r.integers(0, 8_000, n).astype(np.int32)
    le = (ls + r.integers(0, 400, n)).astype(np.int32)
    rs = r.integers(0, 8_000, m).astype(np.int32)
    re = (rs + r.integers(0, 400, m)).astype(np.int32)
    if name == "dirty":
        lk[r.random(n) < 0.05] = -1
        rk[r.random(m) < 0.05] = -2
        inv = r.random(n) < 0.1
        le[inv] = ls[inv] - r.integers(1, 30, int(inv.sum()))
        deg = r.random(m) < 0.1
        re[deg] = rs[deg] - r.integers(1, 3, int(deg.sum()))
    return lk, ls, le, rk, rs, re


def _pairs(out):
    b, p = out
    return sorted(zip(np.asarray(p).tolist(), np.asarray(b).tolist()))


def _coverage(out):
    return [np.asarray(x).tolist() for x in out]


def _as_list(out):
    return np.asarray(out).tolist()


# (op, distribution): (JAX program, port program, mesh kind, result key,
# inputs it is exact on)
PROGRAMS = {
    ("count", "hash"): (jpj.partitioned_count, tpj.partitioned_count, "mesh", int, ("clean", "dirty")),
    ("count", "shuffle"): (jsh.all_to_all_partitioned_count, tsh.all_to_all_partitioned_count,
                           "flat", int, ("clean",)),
    ("count", "skew"): (jsk.skew_partitioned_count_mesh, tsk.skew_partitioned_count_mesh,
                        "mesh", int, ("clean",)),
    ("pairs", "hash"): (jpj.partitioned_pairs, tpj.partitioned_pairs, "mesh", _pairs,
                        ("clean", "dirty")),
    ("pairs", "shuffle"): (jsh.all_to_all_partitioned_pairs, tsh.all_to_all_partitioned_pairs,
                           "flat", _pairs, ("clean", "dirty")),
    ("pairs", "skew"): (jsk.skew_partitioned_pairs, tsk.skew_partitioned_pairs, "mesh", _pairs,
                        ("clean",)),
    ("nearest", "hash"): (jpj.partitioned_nearest, tpj.partitioned_nearest, "mesh", _as_list,
                          ("clean", "dirty")),
    ("nearest", "skew"): (jsk.skew_partitioned_nearest, tsk.skew_partitioned_nearest, "mesh",
                          _as_list, ("clean",)),
    ("probe_counts", "hash"): (jpj.partitioned_probe_counts, tpj.partitioned_probe_counts,
                               "mesh", _as_list, ("clean", "dirty")),
    ("coverage", "hash"): (jpj.partitioned_coverage, tpj.partitioned_coverage, "mesh",
                           _coverage, ("clean", "dirty")),
}
CASES = [
    (op, dist, data, part)
    for (op, dist), (_, _, kind, _, inputs) in PROGRAMS.items()
    for data in inputs
    for part in (2, 4, 8)
    if part < 8 or kind == "mesh"  # the flat programs take the (8, 1) mesh at every part
]

_JAX = {}


def _jax_result(op, dist, data, part, **kw):
    key = (op, dist, data, part, tuple(sorted(kw.items())))
    if key not in _JAX:
        jfn, _, kind, result, _ = PROGRAMS[op, dist]
        mesh = jax_mesh(8, part=8 if kind == "flat" else part)
        _JAX[key] = result(jfn(mesh, *_inputs(data), **kw))
    return _JAX[key]


def _port_result(op, dist, data, part, **kw):
    _, tfn, kind, result, _ = PROGRAMS[op, dist]
    mesh = make_mesh(CPU8, part=8 if kind == "flat" else part)
    return result(tfn(mesh, *_inputs(data), **kw))


@pytest.mark.parametrize("strategy", ["sort", "bsearch"])
@pytest.mark.parametrize("op,dist,data,part", CASES)
def test_program_equals_jax(monkeypatch, op, dist, data, part, strategy):
    want = _jax_result(op, dist, data, part)
    monkeypatch.setenv("SEQUILA_MESH_BOUNDS", strategy)
    assert _port_result(op, dist, data, part) == want
    assert want not in (0, [])


@pytest.mark.parametrize("dist,limit", [("hash", 1024), ("shuffle", 2048), ("skew", 1024)])
def test_chunked_emission_equals_unchunked(dist, limit):
    """A shard far past the chunk cap drains over several chunks: the same
    pairs as one unchunked pass, in the port and in the JAX package."""
    want = _jax_result("pairs", dist, "dense", 2)
    assert len(want) == 200 * 300
    assert _port_result("pairs", dist, "dense", 2, chunk_limit=limit) == want
    assert _port_result("pairs", dist, "dense", 2) == want


@pytest.mark.parametrize("dist", ["hash", "skew"])
def test_emit_limit_raises_execution_error(monkeypatch, dist):
    """A shard over the emit limit is an ExecutionError in both packages,
    never a silent wrap (the limit lowered to make one)."""
    monkeypatch.setattr(tij, "_EMIT_LIMIT", 1000)
    monkeypatch.setattr(jij, "_EMIT_LIMIT", 1000)
    jfn, tfn = PROGRAMS["pairs", dist][:2]
    with pytest.raises(JaxExecutionError, match="2\\^31"):
        jfn(jax_mesh(8, part=2), *_inputs("dense"))
    with pytest.raises(ExecutionError, match="2\\^31"):
        tfn(make_mesh(CPU8, part=2), *_inputs("dense"))


def test_skew_plan_equals_jax():
    """The hot key is range-split, and both packages plan the same shards."""
    lk, _, _, rk, rs, _ = _inputs("clean")
    got, want = (mod.plan_partitions(lk, rk, rs, 4) for mod in (tsk, jsk))
    assert 0 in got.splits and got.shard_of_key == want.shard_of_key
    assert got.splits.keys() == want.splits.keys()
    for key, (bounds, ids) in want.splits.items():
        np.testing.assert_array_equal(got.splits[key][0], bounds)
        np.testing.assert_array_equal(got.splits[key][1], ids)
    np.testing.assert_array_equal(got.shard_part, want.shard_part)


@pytest.mark.parametrize("target", [1, 2, 3, 4, 5, 8, 16])
def test_engine_mesh_shape_equals_jax(target):
    """The CPU mesh has the shape of the JAX package's at every
    target_partitions, from the conftest's XLA_FLAGS (8 devices)."""
    want = jengine.get_engine_mesh(target)
    got = tengine.get_engine_mesh(target, "cpu")
    if want is None:
        assert got is None
        return
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert all(d == torch.device("cpu") for d in got.devices.reshape(-1))
    flat = tengine.get_flat_mesh(got)
    assert flat.shape == dict(jengine.get_flat_mesh(want).shape)


def test_host_device_count(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--foo --xla_force_host_platform_device_count=6")
    assert tengine.host_device_count() == 6
    monkeypatch.delenv("XLA_FLAGS")
    assert tengine.host_device_count() == 1
    assert tengine.get_engine_mesh(4, "cpu").shape == {"part": 1, "probe": 1}


def test_mesh_bounds_strategy(monkeypatch):
    mesh = make_mesh(CPU8)
    monkeypatch.delenv("SEQUILA_MESH_BOUNDS", raising=False)
    assert tpj.mesh_bounds_strategy(mesh) == "bsearch"
    monkeypatch.setenv("SEQUILA_MESH_BOUNDS", "sort")
    assert tpj.mesh_bounds_strategy(mesh) == "sort"


def test_build_partitioned_index_equals_jax():
    """The per-part level views and their shared layout are the JAX
    package's arrays."""
    lk, ls, le = _inputs("dirty")[:3]
    got, gmeta = tpj.build_partitioned_index(lk, ls, le, 4)
    want, wmeta = jpj.build_partitioned_index(lk, ls, le, 4)
    assert gmeta == wmeta and len(wmeta["layout"]) > 1
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(params=["engine", "repeated"])
def cuda_mesh(request):
    """The engine's mesh of the cards there are, and a (2, 2) mesh that
    repeats the first card as the CPU mesh repeats the host device: on
    one card the second still runs every multi-shard path (the exchange,
    split hot keys, the nearest fringe) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == "engine":
        return tengine.get_engine_mesh(4, "cuda")
    return make_mesh([torch.device("cuda", 0)] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dist", [("count", "hash"), ("count", "shuffle"), ("count", "skew"),
                                     ("pairs", "hash"), ("pairs", "shuffle"), ("pairs", "skew"),
                                     ("nearest", "hash"), ("nearest", "skew")])
def test_cuda_program_equals_cpu(cuda_mesh, op, dist):
    """On the card: the program's shards live on the card, and the result
    equals the CPU mesh's."""
    _, tfn, kind, result, _ = PROGRAMS[op, dist]
    mesh = tengine.get_flat_mesh(cuda_mesh) if kind == "flat" else cuda_mesh
    assert all(d.type == "cuda" for d in mesh.devices.reshape(-1))
    assert result(tfn(mesh, *_inputs("clean"))) == _port_result(op, dist, "clean", 2)


def _verb_table(seed, n, contigs):
    r = np.random.default_rng(seed)
    s = r.integers(0, 6000, n)
    e = s + r.integers(0, 400, n)
    e[: n // 20] = s[: n // 20] - 1  # degenerate / inverted rows
    return pa.table({
        "contig": r.choice(contigs, n), "pos_start": s, "pos_end": e,
        "strand": r.choice(["+", "-"], n), "score": r.integers(-50, 50, n),
    })


VERBS = {
    "overlap": lambda df, a, b, **kw: df.overlap(a, b, **kw),
    "count_overlaps": lambda df, a, b, **kw: df.count_overlaps(a, b, **kw),
    "count_overlaps_strand": lambda df, a, b, **kw: df.count_overlaps(a, b, strand="same", **kw),
    "coverage": lambda df, a, b, **kw: df.coverage(a, b, **kw),
    "map_overlaps": lambda df, a, b, **kw: df.map_overlaps(
        a, b, "score", ops=("count", "sum", "min", "max"), **kw),
    "window": lambda df, a, b, **kw: df.window(a, b, window=30, **kw),
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_verb_partitions_4_equals_jax(verb):
    """The DataFrame verbs with partitions=4 over the port's CPU mesh equal
    the JAX package's over the virtual mesh, row for row (both order a
    mesh's pairs by probe row, then build row)."""
    from sequila_tpu import dataframe as jdf
    from sequila_tpu.models.table import Table as JaxTable
    from sequila_tpu_torch import dataframe as tdf
    from sequila_tpu_torch.models.table import Table as TorchTable

    a = _verb_table(21, 300, ["chr1", "chr2", "chr3", "chrA"])
    b = _verb_table(22, 400, ["chr1", "chr2", "chr3", "chrB"])
    call = VERBS[verb]

    def rows(t):  # repr: an empty group's NaN equals itself
        return [repr(r) for r in t.to_pylist()]

    want = rows(call(jdf, JaxTable(a), JaxTable(b), partitions=4))
    got = rows(call(tdf, TorchTable(a), TorchTable(b), device="cpu", partitions=4))
    assert got == want and len(got) > 0
    single = rows(call(tdf, TorchTable(a), TorchTable(b), device="cpu"))
    assert sorted(got) == sorted(single)
