"""Stream compaction: filter rows by a stencil, keeping survivors dense.

≅ libgdf/src/streamcompactionops.cu:
  - gpu_apply_stencil (:163-260): thrust::copy_if keeping rows where
    stencil != 0 AND the stencil's own validity bit is set;
  - gpu_concat (:389-503): concatenation incl. bit-level mask stitching.

Design: the thrust::copy_if shape — a prefix sum of the keep mask gives
each survivor its slot, and one scatter per column moves it there
(compact_arrays). On the H100 this runs about 10x faster than a fused
payload sort on a 1-byte drop key (PERF.md).
The survivor count is a fused popcount. Output keeps the static
capacity; `num_rows` carries the live count (capacity+count pattern —
see core/table.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table


def compact_table(table: Table, keep: jax.Array):
    """Move rows where `keep` to the front (stable). Returns (Table with
    original capacity, count)."""
    arrays, layout = [], []
    for c in table.columns:
        arrays.append(c.data)
        if c.valid is not None:
            arrays.append(c.valid)
            layout.append(2)
        else:
            layout.append(1)
    res, count = compact_arrays(arrays, keep)
    cols, i = [], 0
    for c, w in zip(table.columns, layout):
        data = res[i]
        valid = res[i + 1] if w == 2 else None
        i += w
        cols.append(Column(data=data, valid=valid, info=c.info, name=c.name))
    return Table(columns=tuple(cols), names=table.names), count


def compact_arrays(arrays, keep: jax.Array):
    """Stable stream compaction of raw arrays: returns (compacted arrays,
    count). Rows past the count are zero.

    A prefix sum of `keep` gives each kept row its output slot; one
    scatter per array writes it there. Dropped rows get distinct slots
    past the end, which the scatter drops, so every index is unique."""
    n = keep.shape[0]
    pos = jnp.cumsum(keep, dtype=jnp.int32) - 1
    iota = jnp.arange(n, dtype=jnp.int32)
    dst = jnp.where(keep, pos, n + (iota - pos - 1))
    out = [jnp.zeros_like(a).at[dst].set(a, mode="drop", unique_indices=True)
           for a in arrays]
    return out, jnp.sum(keep, dtype=jnp.int32)


def compaction_indices(keep: jax.Array):
    """Return (src_indices: int32[n], count): the j-th output row
    (j < count) comes from src_indices[j]; kept rows keep their order."""
    iota = jnp.arange(keep.shape[0], dtype=jnp.int32)
    (perm,), count = compact_arrays([iota], keep)
    return perm, count


def stencil_keep_mask(stencil: Column) -> jax.Array:
    """Rows pass iff stencil value != 0 AND stencil bit valid
    (streamcompactionops.cu:163-260 zip(stencil, valid-bit) predicate)."""
    keep = stencil.data != 0
    if stencil.valid is not None:
        keep = jnp.logical_and(keep, stencil.valid)
    return keep


def apply_stencil(col: Column, stencil: Column):
    """Compact one column by a stencil. Returns (Column, count) with the
    column padded to its original capacity.

    ≅ gdf_apply_stencil (streamcompactionops.cu:163-260)."""
    require(col.size == stencil.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    keep = stencil_keep_mask(stencil)
    if col.valid is not None:
        arrays, count = compact_arrays([col.data, col.valid], keep)
        return col.with_data(arrays[0]).with_valid(arrays[1]), count
    arrays, count = compact_arrays([col.data], keep)
    return col.with_data(arrays[0]).with_valid(None), count


def filter_table(table: Table, stencil: Column) -> Table:
    """Compact every column of a table by one stencil; one sort total.
    Returns a Table with num_rows = survivor count."""
    from ..utils.metrics import op_metrics, table_bytes
    require(table.capacity == stencil.size,
            GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    with op_metrics("LIBGDF_FILTER", rows_in=table.capacity,
                    bytes_est=2 * table_bytes(table)) as m:
        keep = stencil_keep_mask(stencil)
        if table.num_rows is not None:
            keep = jnp.logical_and(keep, table.live_mask())
        out, count = compact_table(table, keep)
        m["rows_out"] = count
    return out.with_num_rows(count)
