"""Build + load the native C++ host index (ctypes binding).

The port keeps its own copy of the C++ source,
``sequila_tpu_torch/native/src/sequila_native.cc`` (byte for byte the
JAX package's ``sequila_tpu/native/src/sequila_native.cc``;
``tests/test_torch_native_source.py`` holds the two equal).  It is
compiled on first use with the system toolchain into the port's own
cache, ``sequila_tpu_torch/_build/native``, keyed by a source hash — the
moral equivalent of the reference shipping its superintervals index as a
compiled extension (reference superintervals/setup.py builds the Cython/
C++ wheel).  `SEQUILA_NATIVE=0` disables the native path (pure NumPy
fallback in ops/host_join.py)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "src", "sequila_native.cc"
)
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    d = os.environ.get(
        "SEQUILA_NATIVE_CACHE",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "_build", "native",
        ),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    # SEQUILA_NATIVE_SANITIZE=address|thread builds an instrumented
    # library (the reference C++ harness's `make asan=1` analog,
    # superintervals/test/Makefile:11-15); tools/run_sanitizers.py is the
    # entry point — the matching runtime must be LD_PRELOADed before
    # python starts for ctypes loading to work.
    sanitize = os.environ.get("SEQUILA_NATIVE_SANITIZE", "")
    tag = hashlib.sha256(src + sanitize.encode()).hexdigest()[:16]
    suffix = f"_{sanitize}" if sanitize else ""
    so_path = os.path.join(_cache_dir(), f"sequila_native_{tag}{suffix}.so")
    if os.path.exists(so_path):
        return so_path
    if sanitize == "address":
        extra = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                 "-g", "-O1"]
    elif sanitize == "thread":
        extra = ["-fsanitize=thread", "-g", "-O1"]
    elif sanitize:
        raise ValueError(f"unknown SEQUILA_NATIVE_SANITIZE={sanitize!r}")
    else:
        extra = ["-O3", "-march=native"]
    cmd = [
        "g++", *extra, "-std=c++17", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", f"{so_path}.{os.getpid()}.tmp",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(f"{so_path}.{os.getpid()}.tmp", so_path)
        return so_path
    except Exception:
        return None


def load():
    """The loaded CDLL, or None if native is disabled/unbuildable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("SEQUILA_NATIVE", "1") == "0":
            return None
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.si_build.restype = ctypes.c_void_p
        lib.si_build.argtypes = [i32p, i32p, i32p, ctypes.c_int64]
        lib.si_free.argtypes = [ctypes.c_void_p]
        lib.si_count.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64, i64p,
        ]
        lib.si_pairs.restype = ctypes.c_int64
        lib.si_pairs.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.si_emit_at.restype = ctypes.c_int64
        lib.si_emit_at.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64, i64p,
            i32p, i32p,
        ]
        vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.si_emit_gather.restype = ctypes.c_int64
        lib.si_emit_gather.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64, i64p,
            ctypes.c_int64, vpp, i32p, vpp,
            ctypes.c_int64, vpp, i32p, vpp,
        ]
        lib.si_gather32.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
        lib.si_gather64.argtypes = [i64p, i32p, ctypes.c_int64, i64p]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.si_take_str_offsets.restype = ctypes.c_int64
        lib.si_take_str_offsets.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
        lib.si_take_str_fill.argtypes = [
            i32p, u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, u8p,
        ]
        lib.si_nearest.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64, i64p,
        ]
        lib.si_coverage.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64, i64p, i64p,
        ]
        lib.si_closest_k.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int64, i32p, i64p,
        ]
        lib.si_layout.restype = ctypes.c_int64
        lib.si_layout.argtypes = [ctypes.c_void_p]
        lib.si_expand_runs.argtypes = [i32p, i32p, ctypes.c_int64, i32p, i32p]
        lib.si_repeat_counts.argtypes = [i32p, ctypes.c_int64, i32p]
        lib.si_argsort64.argtypes = [i64p, ctypes.c_int64, i32p]
        lib.si_searchsorted64.argtypes = [
            i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int32, i64p,
        ]
        lib.si_subtract_count.argtypes = [
            i64p, i64p, i32p, i32p, ctypes.c_int64,
            i32p, i32p, i32p, ctypes.c_int64, i32p, i64p,
        ]
        lib.si_subtract_emit.argtypes = [
            i64p, i32p, i32p, ctypes.c_int64,
            i32p, i32p, i32p, ctypes.c_int64, i32p, i64p,
            i32p, i32p, i32p,
        ]
        _LIB = lib
        return _LIB


def expand_runs(g0, cnt, pos, total: int):
    """C expansion of (run start, length) pairs into pos-gathered rows;
    None when the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    out = np.empty(total, np.int32)
    lib.si_expand_runs(
        np.ascontiguousarray(g0, np.int32),
        np.ascontiguousarray(cnt, np.int32),
        len(g0),
        np.ascontiguousarray(pos, np.int32),
        out,
    )
    return out


def argsort64(v: np.ndarray):
    """Stable parallel argsort of an int64 array (4x16-bit LSD radix);
    None when the native lib is unavailable or n exceeds int32 indices."""
    lib = load()
    if lib is None or len(v) >= 2**31:
        return None
    v = np.ascontiguousarray(v, np.int64)
    out = np.empty(len(v), np.int32)
    lib.si_argsort64(v, len(v), out)
    return out


def searchsorted64(sorted_v: np.ndarray, q: np.ndarray, side: str = "left"):
    """Threaded binary searches over a sorted int64 array; None when the
    native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    sorted_v = np.ascontiguousarray(sorted_v, np.int64)
    q = np.ascontiguousarray(q, np.int64)
    out = np.empty(len(q), np.int64)
    lib.si_searchsorted64(
        sorted_v, len(sorted_v), q, len(q), 0 if side == "left" else 1, out
    )
    return out


def subtract_runs(comp_ms, comp_me, run_s, run_e, ak, as_, ae):
    """Threaded bedtools-subtract gap emission against merged subtrahend
    runs (si_subtract_count/emit): two passes over caller arrays, output
    a-row-major with gaps ascending — bit-identical, same order, as the
    NumPy pair-expansion path in ops/genomic.subtract_intervals.  Returns
    (out_key, out_start, out_end) int32 arrays, or None when the native
    lib is unavailable or sizes exceed int32 indexing."""
    lib = load()
    if lib is None or len(comp_ms) >= 2**31:
        return None
    comp_ms = np.ascontiguousarray(comp_ms, np.int64)
    comp_me = np.ascontiguousarray(comp_me, np.int64)
    run_s = np.ascontiguousarray(run_s, np.int32)
    run_e = np.ascontiguousarray(run_e, np.int32)
    ak = np.ascontiguousarray(ak, np.int32)
    as_ = np.ascontiguousarray(as_, np.int32)
    ae = np.ascontiguousarray(ae, np.int32)
    m = len(ak)
    lo = np.empty(m, np.int32)
    cnt = np.empty(m, np.int64)
    lib.si_subtract_count(
        comp_ms, comp_me, run_s, run_e, len(comp_ms), ak, as_, ae, m, lo, cnt
    )
    offs = np.empty(m + 1, np.int64)
    offs[0] = 0
    np.cumsum(cnt, out=offs[1:])
    total = int(offs[-1])
    out_k = np.empty(total, np.int32)
    out_s = np.empty(total, np.int32)
    out_e = np.empty(total, np.int32)
    if total:
        lib.si_subtract_emit(
            comp_ms, run_s, run_e, len(comp_ms), ak, as_, ae, m, lo, offs,
            out_k, out_s, out_e,
        )
    return out_k, out_s, out_e


def repeat_counts(counts, total: int):
    """C RLE expansion of per-probe counts into probe row ids; None when
    the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    out = np.empty(total, np.int32)
    lib.si_repeat_counts(
        np.ascontiguousarray(counts, np.int32), len(counts), out
    )
    return out


class NativeIntervalIndex:
    """Thin RAII wrapper over the C index."""

    def __init__(self, keys: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._k = np.ascontiguousarray(keys, np.int32)
        self._s = np.ascontiguousarray(starts, np.int32)
        self._e = np.ascontiguousarray(ends, np.int32)
        self._h = ctypes.c_void_p(
            lib.si_build(self._k, self._s, self._e, len(self._k))
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.si_free(h)
            self._h = None

    @property
    def layout(self) -> str:
        """Search layout this index was built with: 'eytzinger' (default —
        per-segment BFS layout of the three search arrays, the reference's
        experimental SuperIntervalsEytz variant made production-default,
        superintervals/src/variants/superintervals_var.hpp:770-816) or
        'segment' (SEQUILA_NATIVE_LAYOUT=segment at build time)."""
        return "eytzinger" if self._lib.si_layout(self._h) else "segment"

    @staticmethod
    def _q(qk, qs, qe):
        return (
            np.ascontiguousarray(qk, np.int32),
            np.ascontiguousarray(qs, np.int32),
            np.ascontiguousarray(qe, np.int32),
        )

    def counts(self, qk, qs, qe) -> np.ndarray:
        qk, qs, qe = self._q(qk, qs, qe)
        out = np.empty(len(qk), np.int64)
        self._lib.si_count(self._h, qk, qs, qe, len(qk), out)
        return out

    def pairs(self, qk, qs, qe):
        """All (build_row, probe_row) pairs, probe-major, as int32 arrays.

        Parallel two-pass: threaded BITS counts -> exclusive scan ->
        threaded emission at the exact offsets (no double scan, no grow-
        and-retry — the emit pass writes disjoint regions per thread)."""
        qk, qs, qe = self._q(qk, qs, qe)
        counts = np.empty(len(qk), np.int64)
        self._lib.si_count(self._h, qk, qs, qe, len(qk), counts)
        offs = np.empty(len(qk) + 1, np.int64)
        offs[0] = 0
        np.cumsum(counts, out=offs[1:])
        total = int(offs[-1])
        out_b = np.empty(total, np.int32)
        out_p = np.empty(total, np.int32)
        if total:
            n = self._lib.si_emit_at(
                self._h, qk, qs, qe, len(qk), offs, out_b, out_p
            )
            assert n == total, f"emit wrote {n} of {total} pairs"
        return out_b, out_p

    def pairs_at(self, qk, qs, qe, offs):
        """``pairs`` with precomputed exclusive-scan offsets (int64[m+1],
        offs[0] == 0): skips the counts pass entirely — the streaming
        emission path already computed counts once for batch sizing, so
        re-deriving them per chunk would double the native work."""
        qk, qs, qe = self._q(qk, qs, qe)
        offs = np.ascontiguousarray(offs, np.int64)
        total = int(offs[-1])
        out_b = np.empty(total, np.int32)
        out_p = np.empty(total, np.int32)
        if total:
            n = self._lib.si_emit_at(
                self._h, qk, qs, qe, len(qk), offs, out_b, out_p
            )
            assert n == total, f"emit wrote {n} of {total} pairs"
        return out_b, out_p

    def emit_gather(self, qk, qs, qe, offs, b_cols, q_cols):
        """Fused emission + per-column output gather (si_emit_gather).

        ``b_cols``/``q_cols`` are lists of (src_np, out_np) pairs of equal
        dtype itemsize 4 or 8 (contiguous, pre-sized to offs[-1]); build
        columns gather through the match rows, probe columns broadcast
        each query's value over its run.  Never materializes the pair
        index arrays.  Returns rows written (== offs[-1])."""
        qk, qs, qe = self._q(qk, qs, qe)
        offs = np.ascontiguousarray(offs, np.int64)

        def pack(cols):
            n = len(cols)
            srcs = (ctypes.c_void_p * max(n, 1))()
            outs = (ctypes.c_void_p * max(n, 1))()
            widths = np.empty(max(n, 1), np.int32)
            for i, (src, out) in enumerate(cols):
                assert src.flags["C_CONTIGUOUS"] and out.flags["C_CONTIGUOUS"]
                assert src.dtype.itemsize == out.dtype.itemsize
                srcs[i] = src.ctypes.data
                outs[i] = out.ctypes.data
                widths[i] = src.dtype.itemsize
            return n, srcs, widths, outs

        nb, b_srcs, b_w, b_outs = pack(b_cols)
        nq, q_srcs, q_w, q_outs = pack(q_cols)
        return self._lib.si_emit_gather(
            self._h, qk, qs, qe, len(qk), offs,
            nb, b_srcs, b_w, b_outs, nq, q_srcs, q_w, q_outs,
        )

    def counts_offsets(self, qk, qs, qe):
        """(counts int64[m], exclusive-scan offsets int64[m+1])."""
        qk, qs, qe = self._q(qk, qs, qe)
        counts = np.empty(len(qk), np.int64)
        self._lib.si_count(self._h, qk, qs, qe, len(qk), counts)
        offs = np.empty(len(qk) + 1, np.int64)
        offs[0] = 0
        np.cumsum(counts, out=offs[1:])
        return counts, offs

    def nearest(self, qk, qs, qe) -> np.ndarray:
        qk, qs, qe = self._q(qk, qs, qe)
        out = np.empty(len(qk), np.int64)
        self._lib.si_nearest(self._h, qk, qs, qe, len(qk), out)
        return out

    def coverage(self, qk, qs, qe):
        qk, qs, qe = self._q(qk, qs, qe)
        c = np.empty(len(qk), np.int64)
        b = np.empty(len(qk), np.int64)
        self._lib.si_coverage(self._h, qk, qs, qe, len(qk), c, b)
        return c, b

    def closest_k(self, qk, qs, qe, k: int):
        """(rows int32[m,k], dists int64[m,k]), -1 padded; requires clean
        inputs (qs <= qe, no inverted builds) — callers route degenerate
        data to the exact scan."""
        qk, qs, qe = self._q(qk, qs, qe)
        m = len(qk)
        rows = np.empty((m, k), np.int32)
        dists = np.empty((m, k), np.int64)
        self._lib.si_closest_k(self._h, qk, qs, qe, m, k, rows, dists)
        return rows, dists


def available() -> bool:
    return load() is not None
