"""IntervalMap — the standalone single-key interval index API.

API-parity surface for the reference's `superintervals` Python package
(reference superintervals/src/superintervals/intervalmap.pyx; usage
`imap = IntervalMap(); imap.add(10, 20, 'A'); imap.build();
imap.search_values(8, 20)`).  Same method names and end-inclusive
semantics; backed by this engine's native C++ index (or the NumPy host
index) instead of the reference's branch-array search.

Not the engine's hot path — joins go through the columnar kernels — but
the drop-in library surface a superintervals user expects.  A copy of
sequila_tpu/intervalmap.py (host code only: no device, no kernel).
"""

from __future__ import annotations

import numpy as np

from sequila_tpu_torch.ops.host_join import make_host_index


class IntervalMap:
    def __init__(self):
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._data: list = []
        self._index = None

    # -- construction -------------------------------------------------------
    def add(self, start: int, end: int, value=None) -> None:
        self._starts.append(int(start))
        self._ends.append(int(end))
        self._data.append(value)
        self._index = None

    @classmethod
    def from_arrays(cls, starts, ends, values=None) -> "IntervalMap":
        m = cls()
        m._starts = [int(x) for x in starts]
        m._ends = [int(x) for x in ends]
        m._data = list(values) if values is not None else [None] * len(m._starts)
        return m

    def build(self) -> None:
        keys = np.zeros(len(self._starts), np.int32)
        self._index = make_host_index(
            keys,
            np.asarray(self._starts, np.int32),
            np.asarray(self._ends, np.int32),
        )

    def clear(self) -> None:
        self._starts, self._ends, self._data = [], [], []
        self._index = None

    def reserve(self, n: int) -> None:  # API compatibility; lists auto-grow
        pass

    # -- serialization ------------------------------------------------------
    # (the reference's superintervals derives serde Serialize/Deserialize on
    # its IntervalMap — reference superintervals.rs:9,33; here the portable
    # form is the raw arrays, and the index rebuilds on load)
    def save(self, path: str) -> None:
        np.savez(
            path,
            starts=np.asarray(self._starts, np.int64),
            ends=np.asarray(self._ends, np.int64),
            data=np.asarray(self._data, dtype=object),
        )

    @classmethod
    def load(cls, path: str) -> "IntervalMap":
        with np.load(
            path if path.endswith(".npz") else path + ".npz", allow_pickle=True
        ) as z:
            m = cls.from_arrays(z["starts"], z["ends"], list(z["data"]))
        m.build()
        return m

    def __getstate__(self):
        return {"starts": self._starts, "ends": self._ends, "data": self._data}

    def __setstate__(self, state):
        self._starts = state["starts"]
        self._ends = state["ends"]
        self._data = state["data"]
        self._index = None
        if self._starts:
            self.build()

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._starts)

    def size(self) -> int:
        return len(self._starts)

    def __getitem__(self, index: int):
        return self.at(index)

    def at(self, index: int):
        return (self._starts[index], self._ends[index], self._data[index])

    def starts_at(self, index: int) -> int:
        return self._starts[index]

    def ends_at(self, index: int) -> int:
        return self._ends[index]

    def data_at(self, index: int):
        return self._data[index]

    # -- queries (end-inclusive, like the reference) ------------------------
    def _require_built(self):
        if self._index is None:
            self.build()
        return self._index

    def _idxs(self, start: int, end: int) -> np.ndarray:
        idx = self._require_built()
        b_rows, _ = idx.pairs(
            np.zeros(1, np.int32),
            np.asarray([start], np.int32),
            np.asarray([end], np.int32),
        )
        return np.asarray(b_rows)

    def has_overlaps(self, start: int, end: int) -> bool:
        return bool(self.count(start, end) > 0)

    def count(self, start: int, end: int) -> int:
        idx = self._require_built()
        return int(
            idx.counts(
                np.zeros(1, np.int32),
                np.asarray([start], np.int32),
                np.asarray([end], np.int32),
            )[0]
        )

    def search_idxs(self, start: int, end: int) -> list[int]:
        return [int(i) for i in self._idxs(start, end)]

    def search_values(self, start: int, end: int) -> list:
        return [self._data[i] for i in self._idxs(start, end)]

    def search_keys(self, start: int, end: int) -> list[tuple[int, int]]:
        return [(self._starts[i], self._ends[i]) for i in self._idxs(start, end)]

    def search_items(self, start: int, end: int) -> list[tuple[int, int, object]]:
        return [self.at(i) for i in self._idxs(start, end)]

    def coverage(self, start: int, end: int) -> tuple[int, int]:
        """(count, total overlapped bases) — superintervals.rs:802-822."""
        idx = self._require_built()
        if hasattr(idx, "coverage"):
            c, b = idx.coverage(
                np.zeros(1, np.int32),
                np.asarray([start], np.int32),
                np.asarray([end], np.int32),
            )
            return int(c[0]), int(b[0])
        rows = self._idxs(start, end)
        total = 0
        for i in rows:
            total += min(self._ends[i], end) - max(self._starts[i], start)
        return len(rows), total

    def _idxs_batch_arrays(self, starts, ends):
        """ONE vectorized host-index query for the whole batch: returns
        (build_rows, split_bounds) with build_rows probe-major, so query i
        owns build_rows[bounds[i]:bounds[i+1]]."""
        idx = self._require_built()
        s = np.asarray(starts, np.int32)
        e = np.asarray(ends, np.int32)
        b, p = idx.pairs(np.zeros(len(s), np.int32), s, e)
        bounds = np.searchsorted(p, np.arange(len(s) + 1))
        return b, bounds

    def search_idxs_batch(self, starts, ends) -> list:
        """Per-query lists of overlapping interval indexes (the
        reference's batch variant, intervalmap.pyx:387).  One vectorized
        index pass for the whole batch — not a per-query Python loop."""
        b, bounds = self._idxs_batch_arrays(starts, ends)
        return [
            b[bounds[i]:bounds[i + 1]].tolist() for i in range(len(bounds) - 1)
        ]

    def search_values_batch(self, starts, ends) -> list:
        """Per-query lists of overlapping values (intervalmap.pyx:433);
        one vectorized index pass."""
        b, bounds = self._idxs_batch_arrays(starts, ends)
        return [
            [self._data[j] for j in b[bounds[i]:bounds[i + 1]]]
            for i in range(len(bounds) - 1)
        ]

    def count_batch(self, starts, ends) -> np.ndarray:
        idx = self._require_built()
        s = np.asarray(starts, np.int32)
        e = np.asarray(ends, np.int32)
        return idx.counts(np.zeros(len(s), np.int32), s, e)

    def coverage_batch(self, starts, ends):
        """Per-query (count, covered_bases) arrays; one vectorized pass."""
        idx = self._require_built()
        s = np.asarray(starts, np.int32)
        e = np.asarray(ends, np.int32)
        if hasattr(idx, "coverage"):
            return idx.coverage(np.zeros(len(s), np.int32), s, e)
        b, bounds = self._idxs_batch_arrays(starts, ends)
        st = np.asarray(self._starts, np.int64)
        en = np.asarray(self._ends, np.int64)
        counts = np.diff(bounds).astype(np.int64)
        reps = np.repeat(np.arange(len(s)), counts)  # query id per match
        widths = (np.minimum(en[b], e.astype(np.int64)[reps])
                  - np.maximum(st[b], s.astype(np.int64)[reps]))
        bases = np.zeros(len(s), np.int64)
        np.add.at(bases, reps, widths)
        return counts, bases

    # -- lazy iterator variants (superintervals.rs:1009-1062) ---------------
    # The reference join consumes search_values_iter; these are generators
    # over one vectorized index query (laziness buys allocation-free
    # consumption, the vectorized query buys C-speed search).
    def search_idxs_iter(self, start: int, end: int):
        for i in self._idxs(start, end):
            yield int(i)

    def search_values_iter(self, start: int, end: int):
        for i in self._idxs(start, end):
            yield self._data[i]

    def search_keys_iter(self, start: int, end: int):
        for i in self._idxs(start, end):
            yield (self._starts[i], self._ends[i])

    def search_items_iter(self, start: int, end: int):
        for i in self._idxs(start, end):
            yield self.at(i)
