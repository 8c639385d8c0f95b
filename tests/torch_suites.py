"""Run the JAX package's SQL-level test suites against the port.

``load(name)`` reads ``tests/<name>.py``, renames every import of
``sequila_tpu`` to ``sequila_tpu_torch`` and executes the result as a
module of its own (``torch_suite_<name>``, its ``__file__`` the JAX
suite's, so paths it finds relative to itself stay the same).  A thin
test module puts the loaded suite's tests and fixtures into its own
namespace, with the fixture that names the device:

    from torch_suites import load, port_on_cpu  # noqa: F401

    globals().update(load("test_sql_ddl").exported)

The JAX suites are not edited, so the port is held to them as they
stand.  A case that reaches an internal function whose signature differs
in the port (a required ``device=``, torch tensors, the port's
``make_mesh``) is rewritten in its thin module under the same name.

The suites build ``SessionContext()`` and call the verbs with no device.
The port's entry points default to ``cuda`` and raise where
``torch.cuda.is_available()`` is False; ``port_on_cpu`` sets those
defaults to ``"cpu"`` for the tests of one module, and runs them from
the repository root, as the tier-1 command does; it restores both after
the module's last test.  The port's own defaults stay ``cuda``.
"""

from __future__ import annotations

import inspect
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
_RENAME = re.compile(r"\bsequila_tpu\b(?!_torch)")


class Suite(types.ModuleType):
    @property
    def exported(self) -> dict:
        """The suite's globals but for the module's own dunder names."""
        return {k: v for k, v in vars(self).items() if not k.startswith("__")}


def load(name: str) -> Suite:
    """The JAX suite ``tests/<name>.py`` executed against the port."""
    modname = f"torch_suite_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = TESTS / f"{name}.py"
    source = _RENAME.sub("sequila_tpu_torch", path.read_text())
    mod = Suite(modname)
    mod.__file__ = str(path)
    sys.modules[modname] = mod  # dataclasses and pickling look a module up here
    try:
        exec(compile(source, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def _with_cpu_default(fn):
    """(attribute, value) that makes ``fn``'s ``device`` parameter default
    to "cpu", or None where it has no ``device="cuda"`` default."""
    param = inspect.signature(fn).parameters.get("device")
    if param is None or param.default != "cuda":
        return None
    if param.kind is inspect.Parameter.KEYWORD_ONLY:
        return "__kwdefaults__", {**fn.__kwdefaults__, "device": "cpu"}
    positional = [p for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    with_default = [p.name for p in positional if p.default is not p.empty]
    defaults = list(fn.__defaults__)
    defaults[with_default.index("device")] = "cpu"
    return "__defaults__", tuple(defaults)


def cuda_entry_points() -> list:
    """The port's public functions whose device defaults to cuda: the
    session, ``connect`` and the genomic verbs."""
    from sequila_tpu_torch import dataframe, session

    funcs = [session.SessionContext.__init__, session.connect]
    funcs += [f for n, f in vars(dataframe).items()
              if inspect.isfunction(f) and f.__module__ == dataframe.__name__
              and not n.startswith("_")]
    return [f for f in funcs if _with_cpu_default(f) is not None]


@pytest.fixture(scope="module", autouse=True)
def port_on_cpu():
    """The port's entry points default to the CPU for this module's
    tests, which run from the repository root: the suites name their
    fixture files relative to it (``testing/data/...``)."""
    with pytest.MonkeyPatch.context() as mp:
        for fn in cuda_entry_points():
            mp.setattr(fn, *_with_cpu_default(fn))
        mp.chdir(REPO)
        yield
