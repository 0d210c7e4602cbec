"""Row hashing and hash partitioning.

≅ reference:
  - MurmurHash3_32 (libgdf/src/hashmap/hash_functions.cuh:30-121) with
    boost-style hash_combine (:71-78) and IdentityHash (:129-161);
  - gdf_table::hash_row — per-column hash, first column's hash taken as-is,
    subsequent columns folded with hash_combine (gdf_table.cuh:704-854);
  - gdf_hash (src/hashing.cu:54-67,83-150) — row-hash column;
  - gdf_hash_partition (src/hashing.cu:559-654) — rearrange a table into
    num_partitions contiguous key partitions + offsets, via
    hash_partition_gdf_table (:401-536): histogram kernel + scans + scatter.

BIT-EXACT parity: placement of a row (its 32-bit hash and its partition
number under the modulo partitioner, hashing.cu:192-206) matches the
reference exactly, so distributed shuffles land rows on the same shard a
libgdf-based system would. Verified against MurmurHash3 reference vectors
in tests/test_hashing.py.

Design: the hash is whole-column uint32 vector arithmetic (multiply/
rotate/xor — murmur3's block loop unrolls completely because
column widths are static). Partitioning replaces the reference's
shared-memory histogram + atomic-offset scatter (hashing.cu:259-377) with
ONE stable sort by partition id + a vectorized offsets searchsorted: the
canonical no-atomics formulation. Within-partition order is therefore
stable (original row order) — a determinism upgrade over the reference's
atomic ordering, which its own tests don't rely on
(tests/hashing/hash-partition-test.cu:166-252 only check membership).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.bits import to_unsigned_bits, u64_words
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table

_C1 = jnp.uint32(0xcc9e2d51)
_C2 = jnp.uint32(0x1b873593)
_M5 = jnp.uint32(5)
_N = jnp.uint32(0xe6546b64)
_GOLDEN = jnp.uint32(0x9e3779b9)


def _rotl32(x, r: int):
    return (x << r) | (x >> (32 - r))


def _fmix32(h):
    """hash_functions.cuh:48-56."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85ebca6b)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xc2b2ae35)
    h = h ^ (h >> 16)
    return h


def _body_block(h1, k1):
    """One 4-byte body block (hash_functions.cuh:92-101)."""
    k1 = k1 * _C1
    k1 = _rotl32(k1, 15)
    k1 = k1 * _C2
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return h1 * _M5 + _N


def _tail_block(h1, k1):
    """Tail mix for widths 1-3 (hash_functions.cuh:104-112)."""
    k1 = k1 * _C1
    k1 = _rotl32(k1, 15)
    k1 = k1 * _C2
    return h1 ^ k1


def murmur3_32(data: jax.Array, seed: int = 0) -> jax.Array:
    """Vectorized MurmurHash3_32 over a column of fixed-width values,
    little-endian byte order, bit-exact with hash_functions.cuh:80-118."""
    width = data.dtype.itemsize
    h1 = jnp.full(data.shape, seed, jnp.uint32)
    u = to_unsigned_bits(data)  # no 64-bit bitcast, core/bits.py
    if width == 8:
        lo, hi = u64_words(u)
        h1 = _body_block(_body_block(h1, lo), hi)
    elif width == 4:
        h1 = _body_block(h1, u)
    elif width in (1, 2):
        h1 = _tail_block(h1, u.astype(jnp.uint32))
    else:
        require(False, GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"hash width {width}")
    h1 = h1 ^ jnp.uint32(width)
    return _fmix32(h1)


_FNV_OFFSET = jnp.uint64(14695981039346656037)
_FNV_PRIME = jnp.uint64(1099511628211)


def fnv1a_64_columns(columns) -> jax.Array:
    """Row-wise FNV-1a (64-bit) over the little-endian bytes of every
    column value, bit-exact with the reference's hash_fnv_array_op
    (libgdf/src/hashops.cu:25-120) — including its quirk of xoring each
    byte as a SIGN-EXTENDED char (`hash ^ data[j]` with char data), which
    standard FNV-1a does not do. Supports widths 1/2/4/8. Returns uint64."""
    require(len(columns) > 0, GDFStatus.GDF_DATASET_EMPTY)
    h = None
    for c in columns:
        data = c.data if isinstance(c, Column) else jnp.asarray(c)
        width = data.dtype.itemsize
        require(width in (1, 2, 4, 8), GDFStatus.GDF_UNSUPPORTED_DTYPE,
                f"fnv width {width}")
        u = to_unsigned_bits(data)
        if h is None:
            h = jnp.full(data.shape, _FNV_OFFSET, jnp.uint64)
        for j in range(width):
            byte = ((u >> (8 * j)) & jnp.asarray(0xFF, u.dtype)).astype(
                jnp.uint8)
            # sign-extend like the reference's `char` xor
            sx = byte.astype(jnp.int8).astype(jnp.int64).astype(jnp.uint64)
            h = (h ^ sx) * _FNV_PRIME
    return h


def identity_hash_32(data: jax.Array) -> jax.Array:
    """≅ IdentityHash (hash_functions.cuh:129-161): static_cast to u32."""
    return data.astype(jnp.uint32)


def hash_combine(lhs: jax.Array, rhs: jax.Array) -> jax.Array:
    """Boost hash_combine (hash_functions.cuh:71-78)."""
    return lhs ^ (rhs + _GOLDEN + (lhs << 6) + (lhs >> 2))


def hash_columns(columns, hash_fn: str = "murmur3") -> jax.Array:
    """Row hash over a list of Columns (or raw arrays).

    ≅ gdf_table::hash_row (gdf_table.cuh:704-854): hash(first column),
    then hash_combine with each subsequent column's hash."""
    require(len(columns) > 0, GDFStatus.GDF_DATASET_EMPTY)
    require(hash_fn in ("murmur3", "identity"),
            GDFStatus.GDF_INVALID_HASH_FUNCTION, hash_fn)
    fn = murmur3_32 if hash_fn == "murmur3" else identity_hash_32
    out = None
    for c in columns:
        data = c.data if isinstance(c, Column) else jnp.asarray(c)
        h = fn(data)
        out = h if out is None else hash_combine(out, h)
    return out


def hash_table_rows(table: Table, num_columns_to_hash: int = 0,
                    hash_fn: str = "murmur3") -> Column:
    """≅ gdf_hash (src/hashing.cu:83-150): per-row hash column (INT32-
    backed u32 bits, like the reference's GDF_INT32 output)."""
    k = num_columns_to_hash or table.num_columns
    h = hash_columns(table.columns[:k], hash_fn)
    return Column(data=jax.lax.bitcast_convert_type(h, jnp.int32),
                  valid=None, info=DtypeInfo(GDFDtype.INT32), name="hash")


def partition_ids(table: Table, key_names, num_partitions: int,
                  hash_fn: str = "murmur3") -> jax.Array:
    """Per-row partition number, modulo partitioner
    (hashing.cu:192-206: partition = hash % num_partitions)."""
    keys = [table.column(n) for n in key_names]
    h = hash_columns(keys, hash_fn)
    return (h % jnp.uint32(num_partitions)).astype(jnp.int32)


def hash_partition(table: Table, key_names, num_partitions: int,
                   hash_fn: str = "murmur3"):
    """Rearrange `table` so partition p's rows are contiguous; return
    (partitioned Table, offsets int32[num_partitions]).

    ≅ gdf_hash_partition (hashing.cu:559-654): offsets[p] = start of
    partition p in the output (exclusive scan of the partition histogram,
    :488-495). This is the per-chip half of a distributed shuffle (§3.3)."""
    part = partition_ids(table, key_names, num_partitions, hash_fn)
    if table.num_rows is not None:
        # Dead rows sort after every real partition.
        part = jnp.where(table.live_mask(), part,
                         jnp.int32(num_partitions))
    sorted_part, out = partition_apply(table, part)
    offsets = jnp.searchsorted(
        sorted_part, jnp.arange(num_partitions, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    return out, offsets


def partition_apply(table: Table, part: jax.Array):
    """Stable-sort the table by a partition-id column, every column riding
    through ONE fused payload sort (ops/engine.py cost model — no
    permutation gathers). Returns (sorted part ids, partitioned Table)."""
    from .engine import multi_sort

    ops_list, layout = [part], []
    for c in table.columns:
        ops_list.append(c.data)
        if c.valid is not None:
            ops_list.append(c.valid)
            layout.append(2)
        else:
            layout.append(1)
    res = multi_sort(ops_list, num_keys=1)
    cols, i = [], 1
    for c, w in zip(table.columns, layout):
        data = res[i]
        valid = res[i + 1] if w == 2 else None
        i += w
        cols.append(Column(data=data, valid=valid, info=c.info, name=c.name))
    out = Table(columns=tuple(cols), names=table.names)
    return res[0], out.with_num_rows(table.num_rows)


def partition_sizes(part_ids: jax.Array, num_partitions: int,
                    live_mask=None) -> jax.Array:
    """Histogram of partition ids (≅ the global histogram in
    compute_row_partition_numbers, hashing.cu:259-320). One-hot matmul
    formulation — no atomics."""
    oh = (part_ids[:, None] ==
          jnp.arange(num_partitions, dtype=part_ids.dtype)[None, :])
    if live_mask is not None:
        oh = jnp.logical_and(oh, live_mask[:, None])
    return jnp.sum(oh, axis=0, dtype=jnp.int32)
