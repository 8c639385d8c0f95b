"""The port tunes glibc's allocator at import, as the JAX package does.

A child process imports ``sequila_tpu_torch`` alone (no JAX, nothing of
``sequila_tpu``) with ``ctypes.CDLL`` wrapped to record ``mallopt``: the
two retention settings are made once, and ``SEQUILA_MALLOC_TUNE=0`` turns
them off.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import ctypes, json, sys

calls = []
_CDLL = ctypes.CDLL


def CDLL(name, *args, **kwargs):
    lib = _CDLL(name, *args, **kwargs)
    if name != "libc.so.6":
        return lib

    class Libc:
        def mallopt(self, param, value):
            calls.append([param, value])
            return lib.mallopt(param, value)

    return Libc()


ctypes.CDLL = CDLL
import sequila_tpu_torch
from sequila_tpu_torch._malloc import tune_malloc

tune_malloc()  # a second call changes nothing
leaked = sorted(m for m in sys.modules if m == "jax" or m.split(".")[0] == "sequila_tpu")
print(json.dumps({"calls": calls, "leaked": leaked}))
"""


def _child(tune):
    env = {k: v for k, v in os.environ.items() if k != "SEQUILA_MALLOC_TUNE"}
    if tune is not None:
        env["SEQUILA_MALLOC_TUNE"] = tune
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="glibc's mallopt")
@pytest.mark.parametrize("tune", [None, "1", "0"])
def test_import_tunes_malloc_once(tune):
    out = _child(tune)
    assert out["leaked"] == []
    if tune == "0":
        assert out["calls"] == []
    else:  # M_TRIM_THRESHOLD, then M_MMAP_THRESHOLD, each once
        assert out["calls"] == [[-1, 2**31 - 1], [-3, 2**31 - 1]]
