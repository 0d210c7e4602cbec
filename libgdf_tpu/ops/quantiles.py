"""Quantiles: exact and approximate.

≅ reference:
  - gdf_quantile_exact (libgdf/src/quantiles.cu:83-244 dispatch,
    include/quantiles.hpp:32-158): sort a copy of the column, pick or
    interpolate at position q*(n-1) with methods linear / lower / higher /
    midpoint / nearest;
  - gdf_quantile_aprrox (sic — the typo is part of the reference ABI,
    functions.h:782): value at the floor position, no interpolation.

Design: one lax.sort of the column, then O(1) gathers — interpolation
arithmetic is scalar. NULLs are excluded (sorted to the end via the
encode+flag trick, then the effective n shrinks), a capability the
reference lacks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.column import Column
from ..core.errors import GDFStatus, require

METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _sorted_valid(col: Column):
    """Sort values with NULL/dead rows last; return (sorted, n_valid)."""
    flag = jnp.zeros((col.size,), jnp.uint8) if col.valid is None else \
        jnp.logical_not(col.valid).astype(jnp.uint8)
    out = jax.lax.sort((flag, col.data), num_keys=2, is_stable=True)
    n_valid = jnp.sum(flag == 0, dtype=jnp.int32)
    return out[1], n_valid


def quantile_exact(col: Column, q: float, method: str = "linear"):
    """Exact quantile of a (possibly nullable) column → f64 scalar.

    ≅ gdf_quantile_exact (quantiles.cu:83-244). q in [0,1]."""
    require(method in METHODS, GDFStatus.GDF_INVALID_API_CALL, method)
    require(0.0 <= q <= 1.0, GDFStatus.GDF_INVALID_API_CALL, "q outside [0,1]")
    svals, n = _sorted_valid(col)
    pos = q * (jnp.maximum(n, 1) - 1).astype(jnp.float64)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    vlo = jnp.take(svals, lo).astype(jnp.float64)
    vhi = jnp.take(svals, hi).astype(jnp.float64)
    frac = pos - lo
    if method == "linear":
        out = vlo + (vhi - vlo) * frac
    elif method == "lower":
        out = vlo
    elif method == "higher":
        out = vhi
    elif method == "midpoint":
        out = (vlo + vhi) * 0.5
    else:  # nearest — round-half-to-even to match numpy's 'nearest'
        idx = jnp.round(pos).astype(jnp.int32)
        out = jnp.take(svals, idx).astype(jnp.float64)
    return out


def quantile_approx(col: Column, q: float):
    """≅ gdf_quantile_aprrox (functions.h:782): value at the lower
    position, returned in the column's own dtype."""
    svals, n = _sorted_valid(col)
    pos = (q * (jnp.maximum(n, 1) - 1).astype(jnp.float64)).astype(jnp.int32)
    return jnp.take(svals, pos)
