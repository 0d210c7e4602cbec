"""Reductions: sum / min / max / product / sum_of_squares over nullable
columns.

≅ libgdf/src/reductions.cu:24-127 (two-round cub::BlockReduce with invalid
lanes replaced by the op identity, functors :129-200) and the ABI entry
points gdf_sum/gdf_min/gdf_max/gdf_product/gdf_sum_squared (functions.h).

Design: a reduction is ONE fused pass — `where(valid, x, identity)` then
`jnp.sum/min/max/prod` — left to XLA's tree reduction. The
reference's 128-partial scratch staging (gdf_reduce_optimal_output_size,
functions.h:632) is a CUDA grid artifact with no counterpart here; the compat
layer still exposes the constant for ABI parity.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.column import Column
from ..core.errors import GDFStatus, require

GDF_REDUCE_OPTIMAL_OUTPUT_SIZE = 128  # functions.h:632, ABI parity only


def _identity(op: str, dtype):
    if op in ("sum", "sum_squared"):
        return jnp.zeros((), dtype)
    if op == "product":
        return jnp.ones((), dtype)
    if op == "min":
        return jnp.asarray(jnp.inf if jnp.issubdtype(dtype, jnp.floating)
                           else np.iinfo(np.dtype(dtype)).max, dtype)
    if op == "max":
        return jnp.asarray(-jnp.inf if jnp.issubdtype(dtype, jnp.floating)
                           else np.iinfo(np.dtype(dtype)).min, dtype)
    raise ValueError(op)


def reduce(col: Column, op: str):
    """Reduce a column to a scalar jax.Array, skipping NULL rows
    (invalid lanes replaced by the op identity, ≅ reductions.cu:37-45)."""
    require(op in ("sum", "min", "max", "product", "sum_squared"),
            GDFStatus.GDF_INVALID_AGGREGATOR, op)
    x = col.data
    if op == "sum_squared":
        x = x * x  # squared on load, ≅ DeviceSumSquared loader :151-166
        op = "sum"
    if col.valid is not None:
        x = jnp.where(col.valid, x, _identity(op, x.dtype))
    if op == "sum":
        return jnp.sum(x)
    if op == "product":
        return jnp.prod(x)
    if op == "min":
        return jnp.min(x)
    return jnp.max(x)


def sum(col: Column):
    return reduce(col, "sum")


def min(col: Column):
    return reduce(col, "min")


def max(col: Column):
    return reduce(col, "max")


def product(col: Column):
    return reduce(col, "product")


def sum_of_squares(col: Column):
    return reduce(col, "sum_squared")
