"""Column: the engine's fundamental value type.

≅ reference `gdf_column` (libgdf/include/gdf/cffi/types.h:84-92): data
pointer + validity bitmask + size + dtype + null_count + name. The
re-design is an **immutable JAX pytree**:

  - `data`  — a device array, shape (nrows,)
  - `valid` — optional bool device array, shape (nrows,); None = no nulls
  - `info`  — static DtypeInfo (logical dtype + time unit)
  - `name`  — static column name

Differences from the reference, and why:
  - validity is an unpacked bool vector, not a packed bitmask: masks fuse
    into elementwise ops for free; packing is interchange-only
    (core/bitmask.py).
  - null_count is not cached: it is one fused reduction when needed, and a
    cached traced scalar would make every op carry a host-sync hazard.
  - columns are immutable (functional updates return new Columns), matching
    XLA's value semantics; the reference mutates buffers in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bitmask import count_valid, pack_bool_mask, unpack_bitmask
from .dtypes import DtypeInfo, GDFDtype, TimeUnit, dtype_from_numpy, physical_dtype
from .errors import GDFError, GDFStatus


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Column:
    data: jax.Array
    valid: Optional[jax.Array] = None
    info: DtypeInfo = field(
        default=DtypeInfo(GDFDtype.invalid), metadata=dict(static=True))
    name: str = field(default="", metadata=dict(static=True))

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_array(data, valid=None, gdf_dtype: GDFDtype | None = None,
                   time_unit: TimeUnit = TimeUnit.NONE,
                   name: str = "") -> "Column":
        """Build a Column from a host/device array.

        ≅ gdf_column_view[_augmented] (src/column.cpp:175-214). `valid` may
        be a bool array, a packed uint8 Arrow bitmask, or None."""
        data = jnp.asarray(data)
        if data.ndim != 1:
            raise GDFError(GDFStatus.GDF_INVALID_API_CALL,
                           "columns are 1-D")
        if gdf_dtype is None:
            gdf_dtype = dtype_from_numpy(np.dtype(data.dtype))
        info = DtypeInfo(gdf_dtype, time_unit)
        phys = physical_dtype(gdf_dtype)
        if data.dtype != phys:
            data = data.astype(phys)
        if valid is not None:
            valid = jnp.asarray(valid)
            if valid.dtype == jnp.uint8 and valid.shape[0] != data.shape[0]:
                valid = unpack_bitmask(valid, data.shape[0])
            else:
                valid = valid.astype(jnp.bool_)
            if valid.shape[0] != data.shape[0]:
                raise GDFError(GDFStatus.GDF_COLUMN_SIZE_MISMATCH,
                               "validity mask length != column length")
        return Column(data=data, valid=valid, info=info, name=name)

    @staticmethod
    def from_masked(values, null_mask=None, name: str = "",
                    gdf_dtype: GDFDtype | None = None) -> "Column":
        """Convenience: `null_mask[i]=True` means row i is NULL."""
        valid = None if null_mask is None else ~jnp.asarray(null_mask)
        return Column.from_array(values, valid=valid, name=name,
                                 gdf_dtype=gdf_dtype)

    # -- introspection -------------------------------------------------------

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def gdf_dtype(self) -> GDFDtype:
        return self.info.gdf_dtype

    @property
    def has_nulls(self) -> bool:
        """Structural: whether a validity mask is attached (not whether any
        bit is actually 0 — that would force a sync)."""
        return self.valid is not None

    def null_count(self) -> jax.Array:
        """Traced scalar count of NULL rows (≅ gdf_column.null_count,
        maintained eagerly in the reference, computed on demand here)."""
        return jnp.asarray(self.size, jnp.int32) - count_valid(
            self.valid, self.size)

    def valid_or_true(self) -> jax.Array:
        """Validity as a materialized bool vector."""
        if self.valid is None:
            return jnp.ones((self.size,), dtype=jnp.bool_)
        return self.valid

    # -- functional updates --------------------------------------------------

    def with_data(self, data, info: DtypeInfo | None = None) -> "Column":
        return replace(self, data=data, info=info or self.info)

    def with_valid(self, valid) -> "Column":
        return replace(self, valid=valid)

    def with_name(self, name: str) -> "Column":
        return replace(self, name=name)

    # -- interchange ---------------------------------------------------------

    def packed_bitmask(self) -> Optional[jax.Array]:
        """Arrow-layout packed validity (interchange; core/bitmask.py)."""
        if self.valid is None:
            return None
        return pack_bool_mask(self.valid)

    def to_numpy_masked(self):
        """Return (values: np.ndarray, null_mask: np.ndarray bool)."""
        vals = np.asarray(self.data)
        nulls = (np.zeros(self.size, bool) if self.valid is None
                 else ~np.asarray(self.valid))
        return vals, nulls


def column_concat(columns) -> Column:
    """Concatenate columns of identical dtype, merging validity.

    ≅ gdf_column_concat (src/column.cpp:53-153): output has a mask iff any
    input does; the reference does bit-level mask stitching
    (gdf_mask_concat), here masks are unpacked so it is one concatenate."""
    columns = list(columns)
    if not columns:
        raise GDFError(GDFStatus.GDF_DATASET_EMPTY, "concat of zero columns")
    info = columns[0].info
    for c in columns[1:]:
        if c.info.gdf_dtype != info.gdf_dtype:
            raise GDFError(GDFStatus.GDF_DTYPE_MISMATCH,
                           "concat dtype mismatch")
    data = jnp.concatenate([c.data for c in columns])
    if any(c.valid is not None for c in columns):
        valid = jnp.concatenate([c.valid_or_true() for c in columns])
    else:
        valid = None
    return Column(data=data, valid=valid, info=info, name=columns[0].name)
