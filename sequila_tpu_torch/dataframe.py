"""Genomic verbs and the DataFrame API: not ported yet (ROADMAP.md A7).

The binder reaches this module for SQL table functions such as
``FROM merge('reads')``; every attribute raises until the verbs are ported.
"""


def __getattr__(name):
    raise NotImplementedError(
        f"sequila_tpu_torch.dataframe.{name}: the genomic verbs are not ported "
        "yet (ROADMAP.md A7)"
    )
