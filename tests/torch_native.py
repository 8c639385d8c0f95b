"""Fixtures shared by the port's parity tests: both packages' native
libraries loaded, or both packages on their NumPy paths.

The JAX package's loader (sequila_tpu/native/loader.py) compiles into one
shared ``<name>.so.tmp`` path, so two test workers compiling on a cold
cache at once can leave one of them with no library.  That worker's
reference then runs its NumPy paths while the port's loader (a tmp file a
process) loads the native one, and the two disagree where the paths do:
``closest(k=3)`` breaks distance ties in another order in the native
3-ring merge than in ``genomic.closest_k`` (sequila_tpu/dataframe.py,
the ``available()`` branch of ``closest``).  A test module imports the
fixtures it uses:

    from torch_native import jax_native_cache, jax_native_loaded  # noqa: F401
"""

import os

import pytest


@pytest.fixture(scope="session")
def jax_native_cache(tmp_path_factory):
    """This worker's own directory for a private build of the JAX
    package's library: one path a worker, whichever module asks, so the
    library compiles there at most once."""
    path = tmp_path_factory.getbasetemp() / "jax_native"
    path.mkdir(exist_ok=True)
    return path


@pytest.fixture
def jax_native_loaded(monkeypatch, jax_native_cache):
    """The JAX package's native library loaded wherever the port's is.

    When native is enabled and the JAX loader's first load failed, load
    it again from ``jax_native_cache``, which no other process writes
    (compiling it there on the first such test of the worker).  The
    loader's state is restored after the test."""
    from sequila_tpu.native import loader as jloader
    from sequila_tpu_torch.native import loader as tloader

    if os.environ.get("SEQUILA_NATIVE", "1") == "0":
        return
    if jloader.load() is None:
        monkeypatch.setattr(jloader, "_TRIED", False)
        monkeypatch.setattr(jloader, "_LIB", None)
        with pytest.MonkeyPatch.context() as env:
            env.setenv("SEQUILA_NATIVE_CACHE", str(jax_native_cache))
            jloader.load()
    assert jloader.available() == tloader.available()


@pytest.fixture
def numpy_on_both(monkeypatch):
    """Both packages on their NumPy host paths: ``available`` is False in
    both loaders."""
    from sequila_tpu.native import loader as jloader
    from sequila_tpu_torch.native import loader as tloader

    monkeypatch.setattr(jloader, "available", lambda: False)
    monkeypatch.setattr(tloader, "available", lambda: False)
