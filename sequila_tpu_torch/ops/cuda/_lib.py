"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``sequila_tpu_torch/csrc`` expose a plain C interface,
so they compile with ``nvcc`` alone in seconds (no PyTorch headers).  The
library is built on first use into ``sequila_tpu_torch/_build/cuda``, keyed
by a hash of the sources, headers and flags, for Hopper only
(``-gencode arch=compute_90a,code=sm_90a``): one ``nvcc -c`` a source, all
started together, then one link.  A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "cuda")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_BUILD_TIMEOUT = 600

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    return res.stdout + res.stderr


def build() -> tuple[str, str]:
    """(path of the shared library, nvcc's build log), building if needed.

    The log holds ``-Xptxas -v``'s per-kernel registers, shared memory and
    spills; it is kept beside the library so a cached build still shows it."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libsequila_cuda_{tag}.so")
    log_path = so_path + ".log"
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        # one nvcc a source, all at once: the build is as long as the
        # slowest source, not their sum
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs))
        ]
        logs, failed = [], []
        for cmd, p in procs:
            out, _ = p.communicate(timeout=_BUILD_TIMEOUT)
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        logs.append(_run([nvcc, *_ARCH, "-shared", "-Xcompiler", "-fPIC", "-o", f"{tmp}.so", *objs]))
        for o in objs:
            os.remove(o)
        with open(log_path, "w") as f:
            f.write("".join(logs))
        os.replace(f"{tmp}.so", so_path)
    with open(log_path) as f:
        return so_path, f.read()


def lib() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so_path, _ = build()
            cdll = ctypes.CDLL(so_path)
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            cdll.seq_pack_view.restype = ctypes.c_int
            cdll.seq_pack_view.argtypes = [vp, vp, vp, i32, ctypes.c_uint32, vp, i64, vp]
            cdll.seq_merge_path.restype = ctypes.c_int
            cdll.seq_merge_path.argtypes = [vp, vp, i32, i64, vp, vp]
            cdll.seq_unpermute_planes.restype = ctypes.c_int
            cdll.seq_unpermute_planes.argtypes = [vp, vp, vp, vp, i64, vp]
            cdll.seq_unpermute_counts.restype = ctypes.c_int
            cdll.seq_unpermute_counts.argtypes = [vp, vp, vp, vp, i64, vp]
            cdll.seq_pair_merge.restype = ctypes.c_int
            cdll.seq_pair_merge.argtypes = [vp, vp, i32, i64, vp, vp]
            cdll.seq_string_keys.restype = ctypes.c_int
            cdll.seq_string_keys.argtypes = [vp, i32, vp, i64, i64, vp, vp]
            cdll.seq_verify_groups.restype = ctypes.c_int
            cdll.seq_verify_groups.argtypes = [vp, i32, vp, i64, vp, vp, i64, vp, vp]
            _LIB = cdll
        return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
