"""Sorting: order-by permutations, key-value radix sorts, segmented sorts.

≅ reference:
  - multi_col_order_by (libgdf/src/sqls_rtti_comp.hpp:299-320): sequence +
    thrust::sort with the LesserRTTI runtime-dispatch comparator (:100-118);
  - gdf_order_by C API (src/sqls_ops.cu:1373-1392);
  - plan-based CUB radix sorts gdf_radixsort_* (src/sorting.cu:9-216) and
    segmented variants (src/segmented_sorting.cu:10-261);
  - gdf_table::sort (src/gdf_table.cuh:1020-1050).

Design: the reference's per-element runtime dtype dispatch
(LesserRTTI's switch per comparison) is replaced by **key normalization**:
each key column is transformed once into a radix-comparable unsigned
bit-string (sign-flip for ints, IEEE-754 order-fix for floats, bit-inverse
for descending), then jax.lax.sort runs over multiple key operands in one
fused sort. NULL ordering is an explicit extra key (0/1 flag), giving
nulls-first/last control the reference's sort path lacks entirely (it
rejects masks, sqls_ops.cu:1103-1106). No plan objects: CUB's plan/scratch
dance (sorting.cu:148-216) is a CUDA memory-management artifact — XLA owns
scratch.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.bits import from_unsigned_bits, to_unsigned_bits
from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table
from .engine import multi_sort


def radix_encode(data: jax.Array, ascending: bool = True) -> jax.Array:
    """Monotone map of a numeric column onto unsigned ints: a < b (as the
    source dtype) iff enc(a) < enc(b) (unsigned). Replaces LesserRTTI
    (sqls_rtti_comp.hpp:100-118) with branch-free bit arithmetic."""
    dt = data.dtype
    if jnp.issubdtype(dt, jnp.floating):
        nbits = dt.itemsize * 8
        u = to_unsigned_bits(data)  # no 64-bit bitcast, core/bits.py
        sign = jnp.asarray(1, u.dtype) << (nbits - 1)
        # IEEE-754 total order: negative floats reverse, positives offset.
        enc = jnp.where((u & sign) != 0, ~u, u | sign)
    elif jnp.issubdtype(dt, jnp.signedinteger):
        nbits = dt.itemsize * 8
        u = to_unsigned_bits(data)
        enc = u ^ (jnp.asarray(1, u.dtype) << (nbits - 1))
    elif jnp.issubdtype(dt, jnp.unsignedinteger):
        enc = data
    elif dt == jnp.bool_:
        enc = data.astype(jnp.uint8)
    else:
        require(False, GDFStatus.GDF_UNSUPPORTED_DTYPE, str(dt))
    if not ascending:
        enc = ~enc
    return enc


def radix_decode(enc: jax.Array, dtype, ascending: bool = True) -> jax.Array:
    """Inverse of radix_encode: recover original values from the
    order-normalized encoding. Lets sorted key columns be reconstructed
    from the sort operands instead of gathered (see ops/engine.py)."""
    dtype = jnp.dtype(dtype)
    if not ascending:
        enc = ~enc
    if dtype == jnp.bool_:
        return enc != 0
    if dtype.kind == "u":
        return enc.astype(dtype)
    nbits = dtype.itemsize * 8
    sign = jnp.asarray(1, enc.dtype) << (nbits - 1)
    if dtype.kind == "f":
        u = jnp.where((enc & sign) != 0, enc ^ sign, ~enc)
    else:
        u = enc ^ sign
    return from_unsigned_bits(u, dtype)


def pack_bit_fields(fields, iota_bits: int = 0, n: int | None = None):
    """Pack ordered bit fields into the minimum number of u64 sort words.

    `fields` is a list of (array, nbits) with each array's low `nbits`
    carrying an unsigned, order-normalized value (radix_encode output or a
    null/dead flag). The global bit string (field 0 most significant)
    is sliced into 64-bit words; comparing the word tuple
    lexicographically == comparing the concatenated bit string == the
    multi-key order. Fields may straddle word boundaries.

    If `iota_bits` > 0, a row-index field is appended, pre-padded so it
    lands in the LOW bits of the final word: the sort then needs no
    separate payload operand for the permutation (extract with
    `last_word & ((1 << iota_bits) - 1)`), and makes rows unique so the
    sort can be unstable.

    This replaces the reference's one-comparator-per-column runtime
    dispatch (LesserRTTI, sqls_rtti_comp.hpp:100-118) with the minimal
    number of fused radix words — fewer operands make a cheaper
    lax.sort."""
    total = 0
    placed = []  # (value u64, nbits, global offset)
    for v, nbits in fields:
        if nbits == 0:
            continue
        placed.append((v.astype(jnp.uint64), nbits, total))
        total += nbits
    if iota_bits:
        pad = (64 - ((total + iota_bits) % 64)) % 64
        total += pad
        iota = jnp.arange(n, dtype=jnp.uint64)
        placed.append((iota, iota_bits, total))
        total += iota_bits
    nwords = max(1, -(-total // 64))
    words = [None] * nwords
    for v, nbits, off in placed:
        w, start = off // 64, off % 64
        avail = 64 - start
        if nbits <= avail:
            contrib = v << (avail - nbits)
            words[w] = contrib if words[w] is None else words[w] | contrib
        else:
            spill = nbits - avail
            hi = v >> spill
            words[w] = hi if words[w] is None else words[w] | hi
            lo = (v & ((jnp.uint64(1) << spill) - jnp.uint64(1))) << (64 - spill)
            words[w + 1] = lo if words[w + 1] is None else words[w + 1] | lo
    zero = jnp.zeros_like(placed[0][0]) if placed else None
    words = [w if w is not None else zero for w in words]
    return words


def bit_field_offsets(nbits_list):
    """Global bit offsets of each field in the pack_bit_fields layout."""
    offs, total = [], 0
    for nb in nbits_list:
        offs.append(total)
        total += nb
    return offs, total


def unpack_bit_field(words, off: int, nbits: int):
    """Extract the u64 value of the field at global bit offset `off` from
    packed sort words (inverse of pack_bit_fields — lets sorted key
    values be reconstructed from the sort operands instead of gathered)."""
    w, start = off // 64, off % 64
    avail = 64 - start
    mask = (jnp.uint64((1 << min(nbits, 63)) - 1) if nbits < 64
            else ~jnp.uint64(0))
    if nbits <= avail:
        return (words[w] >> (avail - nbits)) & mask
    spill = nbits - avail
    hi = words[w] & ((jnp.uint64(1) << avail) - jnp.uint64(1))
    lo = words[w + 1] >> (64 - spill)
    return ((hi << spill) | lo) & mask


def _null_flag(col: Column, nulls_last: bool, live=None):
    """0/1/2 sort flag placing NULLs first/last, dead rows always last;
    None when no flag is needed."""
    if col.valid is None and live is None:
        return None
    if col.valid is None:
        flag = jnp.zeros((col.size,), jnp.uint8)
    else:
        null = jnp.logical_not(col.valid)
        flag = jnp.where(null, jnp.uint8(1 if nulls_last else 0),
                         jnp.uint8(0 if nulls_last else 1))
    if live is not None:
        flag = jnp.where(live, flag, jnp.uint8(2))
    return flag


def key_fields(table: Table, key_names: Sequence[str], ascending,
               nulls_last: bool = True) -> list:
    """Ordered (value, nbits) bit fields for a lexicographic table sort —
    input to pack_bit_fields. Per key: a 1/2-bit null/dead flag (2 bits
    only on the first key of a capacity+count table) then the radix
    encoding."""
    if isinstance(ascending, bool):
        ascending = [ascending] * len(key_names)
    require(len(ascending) == len(key_names),
            GDFStatus.GDF_INVALID_API_CALL,
            "ascending list length mismatch")
    live = None if table.num_rows is None else table.live_mask()
    fields = []
    for name, asc in zip(key_names, ascending):
        col = table.column(name)
        flag = _null_flag(col, nulls_last, live)
        nbits_flag = 2 if live is not None else 1
        live = None  # dead-row flag needed on the first key only
        enc = radix_encode(col.data, asc)
        if flag is not None:
            fields.append((flag, nbits_flag))
        fields.append((enc, enc.dtype.itemsize * 8))
    return fields


def key_operands(table: Table, key_names: Sequence[str], ascending,
                 nulls_last: bool = True) -> list:
    """Minimal u64 sort-key operands (packed bit fields) for a
    lexicographic table sort — fewer operands make a cheaper lax.sort,
    so all flags/encodings share words."""
    return pack_bit_fields(
        key_fields(table, key_names, ascending, nulls_last))


def order_by(table: Table, key_names: Sequence[str],
             ascending=True, nulls_last: bool = True) -> jax.Array:
    """Return the permutation (int32[capacity]) that sorts the table
    lexicographically by the key columns; stable.

    ≅ gdf_order_by → multi_col_order_by (sqls_ops.cu:1373-1392,
    sqls_rtti_comp.hpp:299-320), extended with per-key direction and null
    placement. Dead rows (capacity+count tables) sort to the end.

    The row index rides in the LOW bits of the last key word (stability +
    permutation output in one), so the whole sort is `ceil(keybits/64)`
    unstable u64 operands — for one 64-bit key + one 32-bit key that is 2
    operands vs the reference-shaped 4."""
    from ..utils.metrics import op_metrics, table_bytes
    n = table.capacity
    with op_metrics("LIBGDF_ORDERBY", rows_in=n,
                    bytes_est=2 * table_bytes(table)) as _m:
        _m["rows_out"] = n
        fields = key_fields(table, key_names, ascending, nulls_last)
        iota_bits = max(1, (max(n - 1, 1)).bit_length())
        words = pack_bit_fields(fields, iota_bits=iota_bits, n=n)
        out = multi_sort(tuple(words), num_keys=len(words), stable=False)
        mask = jnp.uint64((1 << iota_bits) - 1)
        return (out[-1] & mask).astype(jnp.int32)


def sort_table(table: Table, key_names: Sequence[str] | None = None,
               ascending=True, nulls_last: bool = True) -> Table:
    """Reorder the table into sorted order (≅ gdf_table::sort,
    gdf_table.cuh:1020-1050). Every column rides through ONE fused
    payload sort — no permutation gathers (ops/engine.py cost model)."""
    keys = list(key_names) if key_names else list(table.names)
    operands = key_operands(table, keys, ascending, nulls_last)
    nk = len(operands)
    layout = []
    for c in table.columns:
        operands.append(c.data)
        if c.valid is not None:
            operands.append(c.valid)
            layout.append(2)
        else:
            layout.append(1)
    res = multi_sort(tuple(operands), num_keys=nk)
    cols, i = [], nk
    for c, w in zip(table.columns, layout):
        data = res[i]
        valid = res[i + 1] if w == 2 else None
        i += w
        cols.append(Column(data=data, valid=valid, info=c.info, name=c.name))
    out = Table(columns=tuple(cols), names=table.names)
    return out.with_num_rows(table.num_rows)


# ---------------------------------------------------------------------------
# CUB-style key/value radix sorts (sorting.cu, segmented_sorting.cu)
# ---------------------------------------------------------------------------

def radixsort(keys: Column, values: Column | None = None,
              descending: bool = False, begin_bit: int = 0,
              end_bit: int | None = None):
    """Sort (key, value) pairs; returns (sorted_keys, sorted_values).

    ≅ gdf_radixsort_* via cub::DeviceRadixSort::SortPairs[Descending]
    (sorting.cu:48-135). `begin_bit`/`end_bit` restrict comparison to a bit
    range of the radix representation, exactly like CUB; the sort is stable
    within equal restricted keys (CUB radix sort is stable)."""
    enc = radix_encode(keys.data, ascending=True)
    nbits = enc.dtype.itemsize * 8
    end_bit = nbits if end_bit is None else end_bit
    if begin_bit > 0 or end_bit < nbits:
        width = end_bit - begin_bit
        mask = (jnp.asarray(1, enc.dtype) << width) - jnp.asarray(1, enc.dtype)
        enc = (enc >> begin_bit) & mask
    if descending:
        enc = ~enc
    operands = [enc, keys.data]
    if values is not None:
        require(values.size == keys.size,
                GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
        operands.append(values.data)
    out = multi_sort(tuple(operands), num_keys=1)
    sorted_keys = keys.with_data(out[1])
    sorted_vals = None if values is None else values.with_data(out[2])
    return sorted_keys, sorted_vals


def segment_ids_from_offsets(offsets: jax.Array, n: int) -> jax.Array:
    """Row → segment id from begin-offset array (searchsorted — no scan
    kernels needed)."""
    iota = jnp.arange(n, dtype=offsets.dtype)
    return (jnp.searchsorted(offsets, iota, side="right") - 1).astype(
        jnp.int32)


def segmented_radixsort(keys: Column, values: Column | None,
                        segment_offsets: jax.Array,
                        descending: bool = False, begin_bit: int = 0,
                        end_bit: int | None = None):
    """Per-segment key/value sort; segments given by begin offsets
    (first offset must be 0).

    ≅ gdf_segmented_radixsort_* via cub::DeviceSegmentedRadixSort
    (segmented_sorting.cu:51-160). Implemented as ONE flat sort with the
    segment id as the leading key — the canonical formulation (a
    per-segment loop would defeat XLA's single fused sort)."""
    n = keys.size
    seg = segment_ids_from_offsets(jnp.asarray(segment_offsets, jnp.int32), n)
    enc = radix_encode(keys.data, ascending=True)
    nbits = enc.dtype.itemsize * 8
    end_bit = nbits if end_bit is None else end_bit
    if begin_bit > 0 or end_bit < nbits:
        width = end_bit - begin_bit
        mask = (jnp.asarray(1, enc.dtype) << width) - jnp.asarray(1, enc.dtype)
        enc = (enc >> begin_bit) & mask
    if descending:
        enc = ~enc
    operands = [seg, enc, keys.data]
    if values is not None:
        operands.append(values.data)
    out = multi_sort(tuple(operands), num_keys=2)
    sorted_keys = keys.with_data(out[2])
    sorted_vals = None if values is None else values.with_data(out[3])
    return sorted_keys, sorted_vals
