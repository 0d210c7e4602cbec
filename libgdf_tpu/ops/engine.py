"""Execution-engine primitives shared by every relational operator.

Two data-movement primitives carry every operator:

- `multi_sort`: one `lax.sort` that permutes any number of payload
  operands with its keys. Partition, order-by, groupby, window and join
  lower to it, carrying whole tables as payload instead of sorting
  indices and gathering afterwards.
- scans (`cumsum`, `cummax`, `cummin`, the segmented scans and
  `last_valid_scan`): plain `jnp.cumsum`, `lax.cummax`/`cummin` and
  `lax.associative_scan`, left to XLA. 64-bit integer and float64 scans
  are native and exact.

Whether payload sorts still beat index gathers, and segmented scans
beat scatter-add segment reductions, is an open question per operator
(ROADMAP.md design item 2); the reference permutes via index buffers
(thrust::gather, libgdf/src/gdf_table.cuh:874-963).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def multi_sort(operands: Sequence[jax.Array], num_keys: int,
               stable: bool = True):
    """Stable lexicographic sort of the first `num_keys` operands; ALL
    operands are permuted consistently (see the module docstring for
    its users).

    ≅ every thrust::sort/sort_by_key/stable_sort_by_key call in the
    reference (sqls_rtti_comp.hpp:299-320, joining.cu, hashing.cu) — but
    carrying whole tables as payload instead of gathering afterwards."""
    operands = tuple(operands)
    return jax.lax.sort(operands, num_keys=num_keys, is_stable=stable)


# ---------------------------------------------------------------------------
# 1-D scans — the engine's second data-movement primitive.
# ---------------------------------------------------------------------------


def _assoc_scan(comb, xs, reverse: bool = False):
    """1-D associative scan over a tuple of equally-shaped arrays.
    Inclusive; `reverse=True` scans suffixes."""
    return jax.lax.associative_scan(comb, tuple(xs), reverse=reverse)


def cumsum(x: jax.Array, dtype=None) -> jax.Array:
    """Inclusive prefix sum, accumulated in `dtype` (default: x's)."""
    if dtype is not None:
        x = x.astype(dtype)
    return jnp.cumsum(x)


def cummax(x: jax.Array) -> jax.Array:
    return jax.lax.cummax(x)


def cummin(x: jax.Array, reverse: bool = False) -> jax.Array:
    return jax.lax.cummin(x, reverse=reverse)


def _seg_scan(kind: str, vals, starts):
    """Inclusive segmented scan: `starts` marks segment heads. min and
    max propagate float NaNs, as jnp.minimum / jnp.maximum do."""
    op = {"sum": lambda a, b: a + b, "max": jnp.maximum,
          "min": jnp.minimum}[kind]

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, op(va, vb))
    _, out = _assoc_scan(comb, (starts, vals))
    return out


def seg_scan_sum(vals: jax.Array, starts: jax.Array) -> jax.Array:
    """Inclusive segmented sum scan. `starts` marks segment heads (bool).
    Value at each segment's last row = the segment total.

    ≅ thrust::reduce_by_key's sum path (sqls_rtti_comp.hpp:496-505)."""
    return _seg_scan("sum", vals, starts)


def seg_scan_min(vals, starts):
    return _seg_scan("min", vals, starts)


def seg_scan_max(vals, starts):
    return _seg_scan("max", vals, starts)


def last_valid_scan(valid: jax.Array, vals: jax.Array):
    """For each position i, the value at the latest j <= i with valid[j]
    (carry-forward fill). Positions before the first valid keep vals[i].
    Returns (filled, seen): `seen[i]` says whether any valid j <= i
    exists."""

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va)
    f, out = _assoc_scan(comb, (valid, vals))
    return jnp.where(f, out, vals), f
