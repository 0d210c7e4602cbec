"""Dense columns + validity → CSR.

≅ reference gdf_to_csr (libgdf/io/convert/gdf-to-csr.cu:78-327, struct
csr_gdf convert_types.h:31-39): row-major walk over the table's cells,
emitting every VALID field into A (values), JA (column index) with IA the
per-row exclusive offsets (size rows+1).

Design: the reference uses a valid-count scan + fill kernels with
atomics; here it is one transpose + mask + cumsum + gather — all fused
XLA, no atomics.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
from ..ops import engine
import jax.numpy as jnp

from ..core.dtypes import GDFDtype
from ..core.errors import GDFStatus, require
from ..ops.compaction import compaction_indices


@dataclass
class CSR:
    """≅ csr_gdf (convert_types.h:31-39)."""
    A: jax.Array            # values, length >= nnz (padded; live = nnz)
    IA: jax.Array           # row offsets, size rows+1
    JA: jax.Array           # column index per value (int64, like reference)
    dtype: GDFDtype
    nnz: jax.Array
    rows: int
    cols: int


def gdf_to_csr(columns, num_cols: int | None = None) -> CSR:
    """≅ gdf_to_csr (io_functions.h; impl gdf-to-csr.cu:78-327)."""
    cols = list(columns)
    if num_cols is not None:
        cols = cols[:num_cols]
    require(len(cols) > 0, GDFStatus.GDF_DATASET_EMPTY)
    dt = cols[0].data.dtype
    gdt = cols[0].info.gdf_dtype
    for c in cols:
        require(c.data.dtype == dt, GDFStatus.GDF_DTYPE_MISMATCH,
                "CSR requires uniform dtype")
    n, k = cols[0].size, len(cols)

    # cell matrix [rows, cols], row-major like the reference's walk
    data = jnp.stack([c.data for c in cols], axis=1)
    valid = jnp.stack([c.valid_or_true() for c in cols], axis=1)

    flat_valid = valid.reshape(-1)
    perm, nnz = compaction_indices(flat_valid)
    A = jnp.take(data.reshape(-1), perm)
    JA = (perm % k).astype(jnp.int64)
    per_row = jnp.sum(valid, axis=1, dtype=jnp.int32)
    IA = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                          engine.cumsum(per_row, jnp.int32)])
    return CSR(A=A, IA=IA, JA=JA, dtype=gdt, nnz=nnz, rows=n, cols=k)
