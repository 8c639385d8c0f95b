"""Port parity: IntervalMap of sequila_tpu_torch.

The JAX package's tests/test_intervalmap.py run against the port's copy
(reference superintervals README usage + intervalmap.pyx surface), then
the port's map against the JAX package's on the same random intervals, on
the native index and on the NumPy host index, and its lazy export from
``sequila_tpu_torch``."""

import numpy as np
import pytest

from sequila_tpu_torch.intervalmap import IntervalMap
from torch_native import jax_native_cache, jax_native_loaded, numpy_on_both  # noqa: F401


def test_readme_usage():
    imap = IntervalMap()
    imap.add(10, 20, "A")
    imap.build()
    assert imap.search_values(8, 20) == ["A"]


def test_full_surface(rng):
    imap = IntervalMap()
    ivs = [(5, 10, "a"), (8, 20, "b"), (30, 40, "c"), (1, 100, "d")]
    for s, e, v in ivs:
        imap.add(s, e, v)
    imap.build()
    assert len(imap) == 4 and imap.size() == 4
    assert imap.at(2) == (30, 40, "c")
    assert imap[0] == (5, 10, "a")
    assert imap.starts_at(1) == 8 and imap.ends_at(1) == 20
    assert imap.data_at(3) == "d"

    assert imap.count(9, 9) == 3  # a, b, d
    assert imap.has_overlaps(25, 28)  # d spans it
    assert not imap.has_overlaps(101, 200)
    assert sorted(imap.search_values(9, 9)) == ["a", "b", "d"]
    assert sorted(imap.search_idxs(35, 35)) == [2, 3]
    assert sorted(imap.search_keys(35, 35)) == [(1, 100), (30, 40)]
    assert sorted(imap.search_items(35, 35)) == [(1, 100, "d"), (30, 40, "c")]

    c, bases = imap.coverage(0, 50)
    assert c == 4
    assert bases == (10 - 5) + (20 - 8) + (40 - 30) + (50 - 1)

    batch = imap.count_batch([9, 35, 200], [9, 35, 300])
    assert batch.tolist() == [3, 2, 0]


def test_from_arrays_and_rebuild():
    imap = IntervalMap.from_arrays([1, 5], [3, 9], ["x", "y"])
    assert imap.count(2, 2) == 1
    imap.add(2, 8, "z")  # invalidates; auto-rebuilds on next query
    assert sorted(imap.search_values(2, 2)) == ["x", "z"]
    imap.clear()
    assert len(imap) == 0
    assert imap.count(0, 100) == 0


def test_random_against_numpy(rng):
    s = rng.integers(0, 1000, 200).astype(int)
    e = s + rng.integers(0, 50, 200)
    imap = IntervalMap.from_arrays(s, e, list(range(200)))
    for _ in range(30):
        qs = int(rng.integers(0, 1000))
        qe = qs + int(rng.integers(0, 60))
        want = int(((s <= qe) & (e >= qs)).sum())
        assert imap.count(qs, qe) == want
        assert sorted(imap.search_idxs(qs, qe)) == sorted(
            np.nonzero((s <= qe) & (e >= qs))[0].tolist()
        )


class TestSerialization:
    """Parity with superintervals' serde derive (reference
    superintervals.rs:9,33): the index round-trips through pickle and
    save/load; queries agree after reload."""

    def _map(self):
        from sequila_tpu_torch.intervalmap import IntervalMap

        m = IntervalMap()
        m.add(10, 20, "A")
        m.add(15, 30, "B")
        m.add(100, 200, "C")
        m.build()
        return m

    def test_pickle_round_trip(self):
        import pickle

        m = self._map()
        m2 = pickle.loads(pickle.dumps(m))
        assert m2.search_values(8, 16) == ["A", "B"]
        assert m2.count(150, 160) == 1

    def test_save_load(self, tmp_path):
        from sequila_tpu_torch.intervalmap import IntervalMap

        m = self._map()
        p = str(tmp_path / "idx")
        m.save(p)
        m2 = IntervalMap.load(p)
        assert m2.search_items(14, 16) == m.search_items(14, 16)
        assert len(m2) == 3


def test_batch_search_variants():
    """Parity with the reference's search_idxs_batch / search_values_batch
    (intervalmap.pyx:387,433)."""
    from sequila_tpu_torch.intervalmap import IntervalMap

    m = IntervalMap.from_arrays([1, 10], [5, 20], ["a", "b"])
    m.build()
    assert m.search_idxs_batch([0, 12], [2, 15]) == [[0], [1]]
    assert m.search_values_batch([0, 12], [2, 15]) == [["a"], ["b"]]


class TestBatchAndIterators:
    """Round-2: batch searches are one vectorized index pass; iterator
    variants complete the superintervals surface (superintervals.rs:
    1009-1062)."""

    def _map(self):
        from sequila_tpu_torch.intervalmap import IntervalMap

        m = IntervalMap()
        for s, e, v in [(1, 5, "a"), (3, 9, "b"), (10, 20, "c"), (15, 15, "d")]:
            m.add(s, e, v)
        m.build()
        return m

    def test_batch_matches_scalar(self):
        m = self._map()
        starts = [0, 4, 12, 100]
        ends = [2, 11, 16, 200]
        got = m.search_idxs_batch(starts, ends)
        want = [m.search_idxs(s, e) for s, e in zip(starts, ends)]
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        gv = m.search_values_batch(starts, ends)
        wv = [m.search_values(s, e) for s, e in zip(starts, ends)]
        assert [sorted(g) for g in gv] == [sorted(w) for w in wv]

    def test_batch_random_parity(self):
        import numpy as np

        from sequila_tpu_torch.intervalmap import IntervalMap

        rng = np.random.default_rng(0)
        m = IntervalMap()
        n = 300
        bs = rng.integers(0, 5000, n)
        be = bs + rng.integers(0, 300, n)
        for i in range(n):
            m.add(int(bs[i]), int(be[i]), i)
        m.build()
        qs = rng.integers(0, 5000, 100)
        qe = qs + rng.integers(0, 300, 100)
        got = m.search_idxs_batch(qs, qe)
        for i in range(100):
            want = sorted(
                j for j in range(n) if bs[j] <= qe[i] and be[j] >= qs[i]
            )
            assert sorted(got[i]) == want
        cb = m.count_batch(qs, qe)
        assert [len(g) for g in got] == cb.tolist()
        cc, bb = m.coverage_batch(qs, qe)
        for i in range(100):
            assert cc[i] == len(got[i])
            assert bb[i] == sum(
                min(int(be[j]), int(qe[i])) - max(int(bs[j]), int(qs[i]))
                for j in got[i]
            )

    def test_iterators_lazy_and_equal(self):
        import types

        m = self._map()
        it = m.search_values_iter(3, 12)
        assert isinstance(it, types.GeneratorType)
        assert sorted(it) == sorted(m.search_values(3, 12))
        assert sorted(m.search_idxs_iter(3, 12)) == sorted(m.search_idxs(3, 12))
        assert sorted(m.search_keys_iter(3, 12)) == sorted(m.search_keys(3, 12))
        assert sorted(m.search_items_iter(3, 12)) == sorted(m.search_items(3, 12))
        assert list(m.search_idxs_iter(1000, 2000)) == []


def test_lazy_export():
    import sequila_tpu_torch
    from sequila_tpu_torch.intervalmap import IntervalMap as Direct

    assert sequila_tpu_torch.IntervalMap is Direct
    assert "IntervalMap" in sequila_tpu_torch.__all__


@pytest.mark.parametrize("native", [True, False])
def test_equals_jax_intervalmap(rng, request, native):
    """Every query surface of the port's map equals the JAX package's on the
    same intervals, with the native C++ index and with the NumPy host index
    (whose coverage is the per-match Python sum)."""
    from sequila_tpu.intervalmap import IntervalMap as JaxMap

    request.getfixturevalue("jax_native_loaded" if native else "numpy_on_both")
    n = 400
    s = rng.integers(-(2**31), 2**31 - 5000, n)
    s[: n // 2] = rng.integers(0, 20_000, n // 2)
    e = s + rng.integers(0, 600, n)
    maps = [M.from_arrays(s, e, [f"v{i}" for i in range(n)]) for M in (IntervalMap, JaxMap)]
    for m in maps:
        m.build()
    qs = rng.integers(-100, 20_500, 60)
    qe = qs + rng.integers(-3, 900, 60)  # a few degenerate (qe < qs) queries
    got, want = maps
    assert type(got._index).__name__ == type(want._index).__name__
    for q0, q1 in zip(qs.tolist(), qe.tolist()):
        assert got.count(q0, q1) == want.count(q0, q1)
        assert sorted(got.search_idxs(q0, q1)) == sorted(want.search_idxs(q0, q1))
        assert got.coverage(q0, q1) == want.coverage(q0, q1)
    np.testing.assert_array_equal(got.count_batch(qs, qe), want.count_batch(qs, qe))
    for g, w in zip(got.coverage_batch(qs, qe), want.coverage_batch(qs, qe)):
        np.testing.assert_array_equal(g, w)
    assert [sorted(x) for x in got.search_values_batch(qs, qe)] == [
        sorted(x) for x in want.search_values_batch(qs, qe)
    ]
