"""Port parity: the genomic verbs (sequila_tpu_torch.dataframe).

Every verb of the port (``device="cpu"``: the kernels' plain versions)
against sequila_tpu.dataframe on the same arrow tables, made from a numpy
seed: contigs present on one side only, strands, a float score column,
inverted build rows, degenerate probe rows and coordinates at the int32
extremes.  The port runs each pair verb on three routes: the host route at
the default threshold, and the device route (SEQUILA_HOST_THRESHOLD=0)
with the merge backend (count_overlaps and coverage on B1's rank passes)
and with the cosort backend (the level index's torch ops).  The reference
is the JAX package at its defaults; a few cases also run the JAX package
on its own device route.  Ints and counts must be equal; pair verbs
compare sorted rows; reldist, jaccard and the map_overlaps means and sums
hold to rtol=1e-12 (sums taken in another order).  The pair verbs run
with both packages' native libraries loaded (tests/torch_native.py), and
the closest cases again with both on their NumPy paths.  Partitioned mode
(partitions=2) equals the JAX package's over its virtual mesh, and a verb
called with no device on a machine without CUDA raises.
"""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from sequila_tpu import dataframe as jdf
from sequila_tpu.models.table import Table as JaxTable
from sequila_tpu_torch import dataframe as tdf
from sequila_tpu_torch.models.table import Table as TorchTable
from sequila_tpu_torch.ops import genomic as tgen
from sequila_tpu_torch.ops.cuda import merge_count as tmc
from torch_native import jax_native_cache, jax_native_loaded, numpy_on_both  # noqa: F401

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
RTOL = 1e-12


def _table(rng, n, contigs, lo=0, hi=6000, maxlen=400):
    s = rng.integers(lo, hi, n)
    return pa.table({
        "contig": rng.choice(contigs, n),
        "pos_start": s,
        "pos_end": s + rng.integers(0, maxlen, n),
        "strand": rng.choice(["+", "-", "."], n),
        "score": rng.normal(size=n).round(3),
    })


def _with_rows(t, rows, start, end):
    """``t`` with its start and end replaced at the positions ``rows``."""
    s = t.column("pos_start").to_numpy().copy()
    e = t.column("pos_end").to_numpy().copy()
    s[rows], e[rows] = start, end
    t = t.set_column(1, "pos_start", pa.array(s))
    return t.set_column(2, "pos_end", pa.array(e))


def _extreme(rng, n, contigs):
    """Intervals hugging INT32_MIN and INT32_MAX (ends up to INT32_MAX)."""
    t = _table(rng, n, contigs)
    half = n // 2
    s = np.concatenate([I32_MIN + rng.integers(0, 3000, half),
                        I32_MAX - rng.integers(1, 3000, n - half)])
    e = np.minimum(s + rng.integers(0, 500, n), I32_MAX)
    e[-1] = I32_MAX
    return _with_rows(t, np.arange(n), s, e)


def case_tables(name, rng):
    """(probe a, build b) arrow tables of one test case."""
    a = _table(rng, 300, ["chr1", "chr2", "chr3", "chrA"])
    b = _table(rng, 400, ["chr1", "chr2", "chr3", "chrB"])
    if name == "inverted_build":
        rows = rng.choice(b.num_rows, 40, replace=False)
        s = b.column("pos_start").to_numpy()[rows]
        b = _with_rows(b, rows, s, s - rng.integers(1, 50, len(rows)))
    elif name == "degenerate_probe":
        rows = rng.choice(a.num_rows, 30, replace=False)
        s = a.column("pos_start").to_numpy()[rows]
        a = _with_rows(a, rows, s, s - rng.integers(1, 3, len(rows)))
    elif name == "int32_extremes":
        a = _extreme(rng, 300, ["chr1", "chr2", "chrA"])
        b = _extreme(rng, 400, ["chr1", "chr2", "chrB"])
    return a, b


CASES = ["random", "inverted_build", "degenerate_probe", "int32_extremes"]
ROUTES = {
    "host": {},
    "merge": {"SEQUILA_HOST_THRESHOLD": "0"},
    "cosort": {"SEQUILA_HOST_THRESHOLD": "0", "SEQUILA_COUNT_BACKEND": "cosort"},
}
MAP_OPS = ("count", "sum", "mean", "min", "max", "median", "collapse", "distinct")

# name: (call(df module, a, b, **kw), kind): kind 'pairs' compares sorted
# rows, 'rows' the rows in order, 'stats' a dict of numbers
PAIR_VERBS = {
    "overlap": (lambda df, a, b, **kw: df.overlap(a, b, **kw), "pairs"),
    "count_overlaps": (lambda df, a, b, **kw: df.count_overlaps(a, b, **kw), "rows"),
    "nearest": (lambda df, a, b, **kw: df.nearest(a, b, **kw), "rows"),
    "closest_k1": (lambda df, a, b, **kw: df.closest(a, b, k=1, **kw), "rows"),
    "closest_k3": (lambda df, a, b, **kw: df.closest(a, b, k=3, **kw), "rows"),
    "coverage": (lambda df, a, b, **kw: df.coverage(a, b, **kw), "rows"),
    "map_overlaps": (
        lambda df, a, b, **kw: df.map_overlaps(a, b, "score", ops=MAP_OPS, **kw), "rows"),
    "map_overlaps_strand": (
        lambda df, a, b, **kw: df.map_overlaps(a, b, "strand", ops=("count", "collapse",
                                                                    "distinct"), **kw),
        "rows"),
    "window": (lambda df, a, b, **kw: df.window(a, b, window=50, **kw), "pairs"),
    "window_asymmetric": (
        lambda df, a, b, **kw: df.window(a, b, left=0, right=120, **kw), "pairs"),
    "jaccard": (lambda df, a, b, **kw: df.jaccard(a, b, **kw), "stats"),
    # the host-only pair verbs take no device
    "reldist": (lambda df, a, b, **kw: df.reldist(a, b), "rows"),
    "reldist_detail": (lambda df, a, b, **kw: df.reldist(a, b, detail=True), "rows"),
    "subtract": (lambda df, a, b, **kw: df.subtract(a, b), "rows"),
}
STRAND_VERBS = {
    "overlap": "pairs", "count_overlaps": "rows", "nearest": "rows", "closest": "rows",
    "coverage": "rows", "subtract": "rows", "window": "pairs",
}


def _set_route(monkeypatch, route):
    for var in ("SEQUILA_HOST_THRESHOLD", "SEQUILA_COUNT_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ROUTES[route].items():
        monkeypatch.setenv(var, value)


def _reference(monkeypatch, call, a, b):
    """The JAX package's result at its default routing."""
    _set_route(monkeypatch, "host")
    return call(jdf, JaxTable(a), JaxTable(b))


def _port(monkeypatch, route, call, a, b):
    _set_route(monkeypatch, route)
    return call(tdf, TorchTable(a), TorchTable(b), device="cpu")


def _sorted_parts(v):
    """A collapse/distinct cell with its comma-separated parts sorted: the
    order of the matches within one probe row is not fixed across routes."""
    return v if v is None else ",".join(sorted(v.split(",")))


def assert_same(got, want, kind):
    if kind == "stats":
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], float):
                assert math.isclose(got[k], want[k], rel_tol=RTOL), k
            else:
                assert got[k] == want[k] and type(got[k]) is type(want[k]), k
        return
    g, w = got.arrow, want.arrow
    assert g.schema == w.schema
    assert g.num_rows == w.num_rows
    if kind == "pairs":
        assert sorted(map(repr, got.to_pylist())) == sorted(map(repr, want.to_pylist()))
        return
    for name, gc, wc in zip(g.column_names, g.columns, w.columns):
        if pa.types.is_floating(wc.type):
            assert gc.null_count == wc.null_count, name
            np.testing.assert_allclose(
                gc.to_numpy(zero_copy_only=False), wc.to_numpy(zero_copy_only=False),
                rtol=RTOL, equal_nan=True, err_msg=name)
        elif name.endswith(("_collapse", "_distinct")):
            assert [_sorted_parts(v) for v in gc.to_pylist()] == [
                _sorted_parts(v) for v in wc.to_pylist()], name
        else:
            assert gc.to_pylist() == wc.to_pylist(), name


@pytest.mark.usefixtures("jax_native_loaded")
class TestPairVerbs:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("case", CASES)
    @pytest.mark.parametrize("verb", sorted(PAIR_VERBS))
    def test_equals_jax(self, rng, monkeypatch, verb, case, route):
        call, kind = PAIR_VERBS[verb]
        a, b = case_tables(case, rng)
        want = _reference(monkeypatch, call, a, b)
        got = _port(monkeypatch, route, call, a, b)
        assert_same(got, want, kind)

    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("strand", ["same", "opposite"])
    @pytest.mark.parametrize("verb", sorted(STRAND_VERBS))
    def test_strand_equals_jax(self, rng, monkeypatch, verb, strand, route):
        kw = {"k": 3} if verb == "closest" else {"window": 30} if verb == "window" else {}

        def call(df, a, b, **dev):
            if verb == "subtract":  # host-only: no device
                dev = {}
            return getattr(df, verb)(a, b, strand=strand, **kw, **dev)

        a, b = case_tables("random", rng)
        want = _reference(monkeypatch, call, a, b)
        got = _port(monkeypatch, route, call, a, b)
        assert_same(got, want, STRAND_VERBS[verb])
        if verb == "count_overlaps":
            assert 0 < got.column_np("count").sum() < tdf.count_overlaps(
                TorchTable(a), TorchTable(b), device="cpu").column_np("count").sum()

    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("case", CASES)
    @pytest.mark.parametrize("verb", ["closest_k1", "closest_k3"])
    def test_closest_numpy_equals_jax(self, rng, monkeypatch, numpy_on_both, verb, case, route):
        """test_equals_jax's closest cases with both packages on their
        NumPy host paths (genomic.closest_k)."""
        self.test_equals_jax(rng, monkeypatch, verb, case, route)

    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("strand", ["same", "opposite"])
    def test_closest_strand_numpy_equals_jax(self, rng, monkeypatch, numpy_on_both, strand,
                                             route):
        """test_strand_equals_jax's closest cases with both packages on
        their NumPy host paths."""
        self.test_strand_equals_jax(rng, monkeypatch, "closest", strand, route)

    @pytest.mark.parametrize("verb", ["count_overlaps", "coverage"])
    def test_same_device_route_in_both_packages(self, rng, monkeypatch, verb):
        """Both packages on their merge route (the JAX package's Pallas
        kernels in interpret mode), then the JAX package's co-sort route."""
        call, kind = PAIR_VERBS[verb]
        a, b = case_tables("random", rng)
        for route in ("merge", "cosort"):
            _set_route(monkeypatch, route)
            want = call(jdf, JaxTable(a), JaxTable(b))
            got = call(tdf, TorchTable(a), TorchTable(b), device="cpu")
            assert_same(got, want, kind)

    @pytest.mark.parametrize("case", ["random", "degenerate_probe", "inverted_build"])
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_route_taken(self, rng, monkeypatch, route, case):
        """The merge route runs merge_verb_rank4 and merge_probe_count_passes
        when the plan qualifies (no degenerate probe, no inverted build);
        otherwise, and on the cosort backend, genomic.coverage and the rank
        ops answer; the host route runs neither."""
        calls = []
        for mod, name in ((tmc, "merge_verb_rank4"), (tmc, "merge_probe_count_passes"),
                          (tgen, "coverage")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *x, fn=fn, name=name: calls.append(name) or fn(*x))
        a, b = case_tables(case, rng)
        _set_route(monkeypatch, route)
        ta, tb = TorchTable(a), TorchTable(b)
        tdf.coverage(ta, tb, device="cpu")
        tdf.count_overlaps(ta, tb, device="cpu")
        if route == "host":
            want = []
        elif route == "merge" and case == "random":
            want = ["merge_verb_rank4", "merge_probe_count_passes"]
        else:
            want = ["coverage"]
        assert calls == want


def test_closest_after_a_lost_build_race(monkeypatch, request):
    """A worker that lost the JAX library's cold-cache build race (its
    loader tried and holds no library) still holds the port's native
    closest(k=3) to the JAX package's native one: jax_native_loaded loads
    a private build.  At this input the NumPy and native paths break
    distance ties apart."""
    from sequila_tpu.native import loader as jloader
    from sequila_tpu_torch.native import loader as tloader

    monkeypatch.setattr(jloader, "_LIB", None)
    monkeypatch.setattr(jloader, "_TRIED", True)
    assert not jloader.available()
    request.getfixturevalue("jax_native_loaded")
    assert jloader.available() and tloader.available()
    call, kind = PAIR_VERBS["closest_k3"]
    a, b = case_tables("int32_extremes", np.random.default_rng(0))
    want = _reference(monkeypatch, call, a, b)
    for route in ("host", "merge"):
        assert_same(_port(monkeypatch, route, call, a, b), want, kind)


class TestSingleTableVerbs:
    SIZES = {"chr1": 7000, "chr2": (100, 4000), "chrEmpty": 5000}

    VERBS = {
        "merge": lambda df, a: df.merge(a),
        "merge_min_dist": lambda df, a: df.merge(a, min_dist=25),
        "merge_strand": lambda df, a: df.merge(a, strand=True),
        "merge_strand_min_dist": lambda df, a: df.merge(a, min_dist=25, strand=True),
        "cluster": lambda df, a: df.cluster(a),
        "cluster_min_dist": lambda df, a: df.cluster(a, min_dist=25),
        "cluster_strand": lambda df, a: df.cluster(a, strand=True),
        "depth": lambda df, a: df.depth(a),
        "complement": lambda df, a: df.complement(a, TestSingleTableVerbs.SIZES),
        "flank": lambda df, a: df.flank(a, 50, 20),
        "flank_sizes": lambda df, a: df.flank(a, 50, 20, chrom_sizes=TestSingleTableVerbs.SIZES),
        "slop": lambda df, a: df.slop(a, 30, 70),
        "slop_sizes": lambda df, a: df.slop(a, 30, 70, chrom_sizes=TestSingleTableVerbs.SIZES),
    }

    @pytest.mark.parametrize("case", ["random", "int32_extremes", "degenerate_probe"])
    @pytest.mark.parametrize("verb", sorted(VERBS))
    def test_equals_jax(self, rng, verb, case):
        a, _ = case_tables(case, rng)
        call = self.VERBS[verb]
        assert_same(call(tdf, TorchTable(a)), call(jdf, JaxTable(a)), "rows")

    @pytest.mark.parametrize("step", [None, 700])
    def test_tile_equals_jax(self, step):
        got = tdf.tile(self.SIZES, 1000, step)
        assert_same(got, jdf.tile(self.SIZES, 1000, step), "rows")
        assert "chrEmpty" in got.column_np("contig")

    def test_complement_keeps_a_contig_without_intervals(self, rng):
        a, _ = case_tables("random", rng)
        got = tdf.complement(TorchTable(a), self.SIZES)
        empty = [r for r in got.to_pylist() if r["contig"] == "chrEmpty"]
        assert empty == [{"contig": "chrEmpty", "pos_start": 0, "pos_end": 5000}]


KERNEL_VERBS = {
    "overlap": lambda a, b, **kw: tdf.overlap(a, b, **kw),
    "count_overlaps": lambda a, b, **kw: tdf.count_overlaps(a, b, **kw),
    "nearest": lambda a, b, **kw: tdf.nearest(a, b, **kw),
    "closest": lambda a, b, **kw: tdf.closest(a, b, k=2, **kw),
    "coverage": lambda a, b, **kw: tdf.coverage(a, b, **kw),
    "map_overlaps": lambda a, b, **kw: tdf.map_overlaps(a, b, "score", **kw),
    "window": lambda a, b, **kw: tdf.window(a, b, window=10, **kw),
    "jaccard": lambda a, b, **kw: tdf.jaccard(a, b, **kw),
}
PARTITIONED = ["overlap", "count_overlaps", "coverage", "map_overlaps", "window"]


@pytest.mark.parametrize("verb", PARTITIONED)
def test_partitioned_verb_equals_jax(rng, verb):
    """Partitioned mode (partitions=2): the port's verb over its CPU mesh
    equals the JAX package's over the virtual mesh."""
    call, kind = PAIR_VERBS[verb]
    a, b = case_tables("random", rng)
    want = call(jdf, JaxTable(a), JaxTable(b), partitions=2)
    got = call(tdf, TorchTable(a), TorchTable(b), device="cpu", partitions=2)
    assert_same(got, want, kind)
    assert got.num_rows > 0


@pytest.mark.parametrize("verb", sorted(KERNEL_VERBS))
def test_no_device_without_cuda_raises(rng, verb):
    """The verbs default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    a, b = case_tables("random", rng)
    with pytest.raises(RuntimeError, match="cuda"):
        KERNEL_VERBS[verb](TorchTable(a), TorchTable(b))


def test_pair_cache_keys_on_the_device(rng, monkeypatch):
    """One pair, two devices named: two cache entries, each with its own
    device (the CPU here stands for both; the key is the device's name)."""
    a, b = case_tables("random", rng)
    ta, tb = TorchTable(a), TorchTable(b)
    e1 = tdf._pair_cache_entry(ta, tb, tdf.DEFAULT_COLS, tdf.DEFAULT_COLS, device=torch.device("cpu"))
    e2 = tdf._pair_cache_entry(ta, tb, tdf.DEFAULT_COLS, tdf.DEFAULT_COLS, device=torch.device("cpu", 0))
    assert e1 is not e2 and e2["device"] == torch.device("cpu", 0)
    assert e1 is tdf._pair_cache_entry(ta, tb, tdf.DEFAULT_COLS, tdf.DEFAULT_COLS,
                                       device=torch.device("cpu"))


@pytest.mark.parametrize("case", CASES)
def test_coverage_view_equals_jax(rng, case):
    """The index's coverage view (sorted columns, prefix sums on the device
    and their numpy twins) holds the JAX index's arrays."""
    from sequila_tpu.ops.interval_index import build_interval_index as jax_index
    from sequila_tpu_torch.ops.interval_index import build_interval_index as torch_index

    _, b = case_tables(case, rng)
    keys = np.searchsorted(np.unique(b.column("contig").to_numpy()),
                           b.column("contig").to_numpy()).astype(np.int32)
    s = b.column("pos_start").to_numpy().astype(np.int32)
    e = b.column("pos_end").to_numpy().astype(np.int32)
    (jks, jss), (jke, jee), jps, jpe = jax_index(keys, s, e).coverage_view
    cv = torch_index(keys, s, e, device="cpu").coverage_view
    for got, want in ((cv.ks, jks), (cv.ss, jss), (cv.ke, jke), (cv.ee, jee),
                      (cv.psum, jps), (cv.esum, jpe)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cv.psum_host, jps)
    np.testing.assert_array_equal(cv.esum_host, jpe)
    assert cv.psum.dtype == torch.int64 and cv.psum_host.dtype == np.int64
