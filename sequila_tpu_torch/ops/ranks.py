"""Vectorized lexicographic rank computation (the engine's `searchsorted`).

Port of sequila_tpu/ops/ranks.py.  Every overlap query reduces to ranks of
query tuples inside a build-side array: for each query tuple q, the number
of build tuples t with t < q ('left') or t <= q ('right') in lexicographic
order.

The JAX package co-sorts build and query tuples because that is what the
TPU does well.  On a GPU the rank of int32 ``(key, value)`` tuples is exact
as one ``torch.searchsorted`` over int64 composites
``key << 32 | (value + 2^31)``: the low half stays in [0, 2^32), so the
composite orders like the tuple for signed keys and for the PAD sentinel
2^31 - 1 alike, and ``side`` picks strict or non-strict.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 2**31


def composite(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """int64 ``key << 32 | (value + 2^31)``: orders like the (key, value)
    tuple of two int32 tensors."""
    return (keys.to(torch.int64) << 32) | (vals.to(torch.int64) + _BIAS)


def _tuple_composite(cols: tuple[torch.Tensor, ...]) -> torch.Tensor:
    if len(cols) == 1:
        return cols[0].to(torch.int64)
    if len(cols) == 2:
        return composite(*cols)
    raise ValueError(
        f"a {len(cols)}-tuple does not fit one 64-bit composite; rank level "
        "slices one at a time (ops/interval_join.level_ranks)"
    )


def rank_lex_sort(
    build_keys: tuple[torch.Tensor, ...],
    query_keys: tuple[torch.Tensor, ...],
    side: str = "left",
) -> torch.Tensor:
    """Rank each query tuple among the build tuples.

    ``build_keys`` and ``query_keys`` are matching 1- or 2-tuples of 1-D
    int32 tensors (most significant first).  The build side need not be
    sorted.  side='left' -> #build < query; side='right' -> #build <= query.
    Returns int32 ranks in query order."""
    b = torch.sort(_tuple_composite(build_keys)).values
    q = _tuple_composite(query_keys)
    return torch.searchsorted(b, q, right=side == "right").to(torch.int32)


def pack_composite(keys: tuple[torch.Tensor, ...], bits: tuple[int, ...]) -> torch.Tensor:
    """Pack int32 key columns into a single int64 lexicographic composite.

    ``bits[i]`` is the bit width reserved for column i (values must be
    non-negative and < 2**bits[i]).  Most-significant column first.
    """
    assert len(keys) == len(bits)
    total = sum(bits)
    if total > 63:
        raise ValueError(f"composite needs {total} bits > 63")
    out = torch.zeros(keys[0].shape, dtype=torch.int64, device=keys[0].device)
    for k, b in zip(keys, bits):
        out = (out << b) | k.to(torch.int64)
    return out


def rank_composite_bsearch(
    build_comp: torch.Tensor, query_comp: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """Vectorized binary search of query composites in a sorted build array."""
    return torch.searchsorted(build_comp, query_comp, right=side == "right").to(torch.int32)


def np_rank_lex(build_keys, query_keys, side="left"):
    """NumPy oracle for tests: rank via int64 composites + np.searchsorted."""
    def comp(cols):
        out = np.zeros(len(cols[0]), dtype=np.int64)
        for c in cols:
            out = (out << 21) | (np.asarray(c, dtype=np.int64) + (1 << 20))
        return out

    b = comp(build_keys)
    q = comp(query_keys)
    return np.searchsorted(np.sort(b), q, side=side)
