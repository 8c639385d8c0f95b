"""The harness that runs the JAX package's SQL-level suites against the
port (tests/torch_suites.py): each loaded suite reaches the port and no
module of the JAX package, and the CPU defaults it sets last only as long
as a suite module runs."""

import inspect
import types

import pytest

import torch_suites

SUITES = [
    "test_sql_ddl", "test_sql_operators", "test_sql_scalar_funcs", "test_sql_subqueries",
    "test_sql_temporal", "test_sql_window", "test_integration_sql", "test_io",
    "test_cookbook", "test_predicate_parser", "test_statistics", "test_review_regressions",
    "test_streaming", "test_genomic_ops", "test_intervalmap", "test_fuzz_sqlite",
]


def _package(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return obj.__name__.split(".")[0]
    return (getattr(obj, "__module__", None) or "").split(".")[0]


@pytest.mark.parametrize("name", SUITES)
def test_suite_reaches_only_the_port(name):
    suite = torch_suites.load(name)
    names = {k: _package(v) for k, v in suite.exported.items()}
    assert "sequila_tpu" not in names.values()
    assert "sequila_tpu_torch" in names.values()
    assert any(k.startswith(("test_", "Test")) for k in names)


def test_entry_points_default_to_cuda_outside_the_suites():
    from sequila_tpu_torch import dataframe
    from sequila_tpu_torch.session import SessionContext, connect

    funcs = torch_suites.cuda_entry_points()
    assert SessionContext.__init__ in funcs and connect in funcs
    assert {dataframe.coverage, dataframe.count_overlaps, dataframe.closest} <= set(funcs)
    for fn in funcs:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
