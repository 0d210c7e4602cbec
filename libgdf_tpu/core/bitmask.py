"""Arrow validity-bitmask utilities.

The reference stores validity as a packed bitmask, 1 bit per row, LSB-first
within each byte (libgdf/include/gdf/utils.h:10-23 `gdf_is_valid`,
GDF_VALID_BITSIZE=8 include/gdf/gdf.h:10, src/util/bit_util.cuh).

The engine keeps validity as an unpacked bool vector (`valid[i]`): masks fuse directly into elementwise ops and
reductions with zero unpack cost. The packed form is an *interchange* format
only (Arrow IPC in/out, compat ABI), so pack/unpack live here at the
boundary. Both are pure XLA (bit-twiddling on uint8 lanes, no gathers).

Popcount-based null counting ≅ gdf_count_nonzero_mask
(src/validops.cu:84-196); mask AND ≅ apply_bitmask_to_bitmask
(src/bitmaskops.cu:78-102); bitmask concat ≅ gdf_mask_concat
(src/validops.cu:203-258).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

GDF_VALID_BITSIZE = 8  # include/gdf/gdf.h:10

_BIT_POS = jnp.asarray(np.arange(8, dtype=np.uint8))  # LSB-first


def num_bitmask_bytes(nrows: int) -> int:
    """≅ gdf_get_num_chars_bitmask (include/gdf/utils.h:18-23)."""
    return (nrows + GDF_VALID_BITSIZE - 1) // GDF_VALID_BITSIZE


def pack_bool_mask(valid: jnp.ndarray) -> jnp.ndarray:
    """bool[n] → uint8[ceil(n/8)] LSB-first packed bitmask.

    Padding bits in the final byte are 0 (the reference leaves them
    undefined; zero is the safer canonical form)."""
    n = valid.shape[0]
    nbytes = num_bitmask_bytes(n)
    padded = jnp.zeros((nbytes * 8,), dtype=jnp.uint8).at[:n].set(
        valid.astype(jnp.uint8))
    bits = padded.reshape(nbytes, 8)
    return (bits << _BIT_POS).sum(axis=1, dtype=jnp.uint8)


def unpack_bitmask(mask: jnp.ndarray, nrows: int) -> jnp.ndarray:
    """uint8[ceil(n/8)] LSB-first → bool[n].

    ≅ gdf_is_valid (include/gdf/utils.h:10-16): valid[i] =
    (mask[i/8] >> (i%8)) & 1."""
    bits = (mask[:, None] >> _BIT_POS) & jnp.uint8(1)
    return bits.reshape(-1)[:nrows].astype(jnp.bool_)


def count_valid(valid: jnp.ndarray | None, nrows: int) -> jnp.ndarray:
    """Number of valid (non-null) rows.

    ≅ gdf_count_nonzero_mask (src/validops.cu:84-196) — the reference does
    u32 __popc + block reduce; here the mask is already unpacked so it is a
    single fused sum."""
    if valid is None:
        return jnp.asarray(nrows, dtype=jnp.int32)
    return jnp.sum(valid, dtype=jnp.int32)


def mask_and(a: jnp.ndarray | None, b: jnp.ndarray | None):
    """AND two optional bool masks (None = all-valid).

    ≅ gdf_validity_and (src/binaryops.cu via validops) /
    apply_bitmask_to_bitmask (src/bitmaskops.cu:78-102)."""
    if a is None:
        return b
    if b is None:
        return a
    return jnp.logical_and(a, b)


def mask_concat(masks, lengths) -> jnp.ndarray:
    """Concatenate unpacked masks (≅ gdf_mask_concat src/validops.cu:203-258,
    which must do bit-addressed stitching across byte boundaries — unpacked
    bool form makes this a plain concatenate)."""
    parts = []
    for m, n in zip(masks, lengths):
        parts.append(jnp.ones((n,), jnp.bool_) if m is None else m[:n])
    return jnp.concatenate(parts)


def all_bitmask_on(nrows: int) -> jnp.ndarray:
    """≅ all_bitmask_on (src/bitmaskops.cu:56-77)."""
    return jnp.ones((nrows,), dtype=jnp.bool_)
