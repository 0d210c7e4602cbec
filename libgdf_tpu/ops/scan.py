"""Prefix sums (scan).

≅ libgdf/src/scan.cu:11-76: gdf_prefixsum_{generic,i8,i32,i64} via
cub::DeviceScan::{In,Ex}clusiveSum. Like the reference, no validity support
(scan.cu has none); unlike the reference, all dtypes are supported — the
reference's i8/i32/i64-only surface was a template-instantiation economy,
not a semantic choice.

Lowers through engine.cumsum (XLA's scan; exact for 64-bit integers).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.column import Column
from ..core.errors import GDFError, GDFStatus
from . import engine


def prefixsum(col: Column, inclusive: bool = True) -> Column:
    """Inclusive (default) or exclusive prefix sum."""
    if col.valid is not None:
        # Reference behavior: scan has no validity handling (scan.cu);
        # reject rather than silently produce nonsense.
        raise GDFError(GDFStatus.GDF_VALIDITY_UNSUPPORTED,
                       "prefixsum does not support validity masks")
    x = col.data
    s = engine.cumsum(x, x.dtype)
    if not inclusive:
        s = jnp.concatenate([jnp.zeros((1,), x.dtype), s[:-1]])
    return col.with_data(s)
