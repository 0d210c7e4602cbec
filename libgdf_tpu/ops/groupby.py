"""Groupby / aggregate: sum, min, max, avg, count, count-distinct.

≅ reference:
  - hash path: gdf_group_by_hash → GroupbyHash (libgdf/src/groupby/
    groupby.cuh:208-250, hash/groupby_compute_api.h:143-225): a
    concurrent_unordered_map keyed by row index, CAS-aggregating in place
    (hash/groupby_kernels.cuh:42-108), extraction via a global atomic write
    index (:125-160); AVG = COUNT pass + SUM pass + divide
    (groupby.cuh:308-419 multi_pass_avg);
  - sort path: multi_col_group_by_*_sort = sort + thrust::reduce_by_key
    (src/sqls_rtti_comp.hpp:400-660), C API gdf_group_by_{sum,min,max,avg,
    count} (src/sqls_ops.cu:1426-1487);
  - COUNT DISTINCT collapses to a scalar (sqls_rtti_comp.hpp:400-441).

Design: the reference's CAS-aggregation hash map is not used (no
atomics), and the sort path is the naturally vector-friendly formulation —
so there is ONE implementation, sort-based, built on the ops/engine.py
cost model (sorts carry payloads; gathers and scatter-adds are banned):

    sort 1: encode keys → one stable multi-key sort CARRYING the agg
            columns as payload operands;
    group boundaries = adjacent-difference of sorted encodings;
    per-agg segmented scans (seg_scan_sum/min/max — associative scans,
            ~40x faster than jax.ops.segment_sum's scatter-add); the value
            at each segment's LAST row is the aggregate;
    sort 2: one compaction sort keeps the segment-last rows — key values
            are DECODED from the sorted encodings (radix_decode), never
            gathered.

  The hash path's contention regimes (AllKeysSame / WarpKeysSame gtest
  stress patterns, tests/groupby/groupby-test.cu:369-441) are non-issues
  here: a segmented scan's cost is independent of key skew.

  Output is sorted by key for free (the reference offers this as the
  optional flag_sort_result post-pass, groupby_compute_api.h:211-222).

Null semantics (the reference has NONE — its sort path rejects masks,
sqls_ops.cu:1103-1106, and its hash path ignores them): pandas-compatible
and strictly more capable — `dropna=True` drops null-key rows; aggregates
skip null values; COUNT counts non-null values of the agg column.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table
from .compaction import compact_arrays
from .engine import multi_sort, seg_scan_max, seg_scan_min, seg_scan_sum
from .join import mask_or
from .sort import (bit_field_offsets, pack_bit_fields, radix_decode,
                   radix_encode, unpack_bit_field)

AGG_OPS = ("sum", "min", "max", "avg", "count", "count_distinct")


def _agg_identity(op: str, dtype):
    if op == "sum":
        return jnp.zeros((), dtype)
    if op == "min":
        return jnp.asarray(jnp.inf if jnp.issubdtype(dtype, jnp.floating)
                           else np.iinfo(np.dtype(dtype)).max, dtype)
    if op == "max":
        return jnp.asarray(-jnp.inf if jnp.issubdtype(dtype, jnp.floating)
                           else np.iinfo(np.dtype(dtype)).min, dtype)
    raise ValueError(op)


def groupby(table: Table, key_names: Sequence[str],
            aggs: Sequence[tuple], dropna: bool = True) -> Table:
    """Group by key columns, apply aggregations.

    aggs: sequence of (column_name, op[, output_name]) with op in AGG_OPS.
    Returns a Table of key columns + one column per agg, padded to the
    input capacity with num_rows = number of groups, sorted by key.

    ≅ gdf_group_by_{sum,min,max,avg,count} (sqls_ops.cu:1426-1487) — both
    the GDF_HASH and GDF_SORT methods map to this one implementation."""
    require(len(key_names) > 0, GDFStatus.GDF_DATASET_EMPTY, "no keys")
    for a in aggs:
        require(a[1] in AGG_OPS, GDFStatus.GDF_INVALID_AGGREGATOR, a[1])
    from ..utils.metrics import op_metrics, table_bytes
    with op_metrics("LIBGDF_GROUPBY", rows_in=table.capacity,
                    bytes_est=2 * table_bytes(table)) as _m:
        out = _groupby_impl(table, key_names, aggs, dropna)
        _m["rows_out"] = out.num_rows
    return out


def _groupby_impl(table: Table, key_names: Sequence[str],
                  aggs: Sequence[tuple], dropna: bool = True) -> Table:

    n = table.capacity
    key_cols = [table.column(k) for k in key_names]

    # --- row disposition: dropped rows sort last; kept-null rows (when
    # dropna=False) each become their own group, NULL != NULL — the
    # semantics gdf_table::rows_equal implies (gdf_table.cuh:588-591). ---
    null_key = None
    for c in key_cols:
        if c.valid is not None:
            null_key = mask_or(null_key, jnp.logical_not(c.valid))
    drop = None if not dropna else null_key
    if table.num_rows is not None:
        drop = mask_or(drop, jnp.logical_not(table.live_mask()))

    # --- sort 1: keys + every payload in ONE fused sort. Key flags and
    # encodings are bit-packed into minimal u64 words (pack_bit_fields) —
    # operand count dominates lax.sort cost. ---
    enc_keys = []
    for c in key_cols:
        data = c.data
        if jnp.issubdtype(data.dtype, jnp.floating):
            data = jnp.where(data == 0, jnp.zeros_like(data), data)
        enc_keys.append(radix_encode(data, ascending=True))

    enc_bits = [e.dtype.itemsize * 8 for e in enc_keys]
    # Per-key null flags sort INSIDE the key words, immediately above each
    # key's encoding (dropna=False only — with dropna=True null-key rows
    # are dropped via the leading drop bit). A flag riding as sort PAYLOAD
    # (the round-4 scheme) is unsound: a null row whose data equals a live
    # key lands inside that key's run and splits the group — and with
    # stable=False, nondeterministically. In-key flags make null rows sort
    # strictly after the valid run of the same prefix, so the unstable
    # sort is genuinely safe and each null row's own-group semantics
    # (NULL != NULL, gdf_table.cuh:588-591) fall out of the run logic.
    key_nullable = [(not dropna and c.valid is not None) for c in key_cols]
    fields = []
    key_field_idx = []          # index into `fields` of key j's encoding
    if drop is not None:
        fields.append((drop.astype(jnp.uint8), 1))
    for j, c in enumerate(key_cols):
        if key_nullable[j]:
            fields.append((jnp.logical_not(c.valid).astype(jnp.uint8), 1))
        key_field_idx.append(len(fields))
        fields.append((enc_keys[j], enc_bits[j]))
    words = pack_bit_fields(fields)
    operands = list(words)
    nk = len(operands)

    def add_payload(arr):
        operands.append(arr)
        return len(operands) - 1

    agg_slots = {}
    for spec in aggs:
        col_name = spec[0]
        if col_name in agg_slots:
            continue
        acol = table.column(col_name)
        dslot = add_payload(acol.data)
        vslot = (add_payload(acol.valid)
                 if acol.valid is not None else None)
        agg_slots[col_name] = (dslot, vslot)

    # UNSTABLE sort: grouping only needs equal keys adjacent, and every
    # supported aggregate (sum/min/max/count/avg) is order-insensitive
    # modulo fp-sum rounding order — which the reference never fixed
    # either (atomicAdd aggregation, groupby_kernels.cuh:42-108, is
    # schedule-ordered). An unstable sort lets the row order ride in no
    # extra operand.
    res = _fused_groupby_sort(operands, nk, fields)

    s_words = list(res[:nk])
    offs, _ = bit_field_offsets([f[1] for f in fields])
    if drop is not None:
        s_dropped = unpack_bit_field(s_words, offs[0], 1) != 0
    else:
        s_dropped = jnp.zeros((n,), jnp.bool_)
    s_enc = [unpack_bit_field(s_words, offs[key_field_idx[j]],
                              enc_bits[j]).astype(enc_keys[j].dtype)
             for j in range(len(enc_keys))]
    # sorted-order per-key null flags, recovered from the key words
    s_key_null = {j: unpack_bit_field(s_words, offs[key_field_idx[j] - 1],
                                      1) != 0
                  for j in range(len(key_cols)) if key_nullable[j]}

    # --- group boundaries (≅ reduce_by_key's equality predicate) ---
    first = jnp.zeros((n,), jnp.bool_).at[0].set(True)
    new_group = first
    for k in s_enc:
        new_group = jnp.logical_or(
            new_group,
            jnp.concatenate([first[:1], k[1:] != k[:-1]]))
    if s_key_null:
        s_null = jnp.zeros((n,), jnp.bool_)
        for flag in s_key_null.values():
            s_null = jnp.logical_or(s_null, flag)
        # a null-key row always starts (and ends) its own group
        new_group = jnp.logical_or(new_group, s_null)
        new_group = jnp.logical_or(
            new_group,
            jnp.concatenate([first[:1], s_null[:-1]]))

    scan_starts = jnp.logical_or(new_group, s_dropped)
    is_last = jnp.concatenate(
        [scan_starts[1:], jnp.ones((1,), jnp.bool_)])
    keep = jnp.logical_and(is_last, jnp.logical_not(s_dropped))
    num_groups = jnp.sum(keep, dtype=jnp.int32)
    group_live = jnp.arange(n, dtype=jnp.int32) < num_groups

    # --- outputs at segment-last rows: key decode + agg scans ---
    out_arrays, builders = [], []

    def add_out(arr, build):
        out_arrays.append(arr)
        builders.append(build)

    for j, (name, c, enc) in enumerate(zip(key_names, key_cols, s_enc)):
        has_null_flag = j in s_key_null

        def build_key(xs, c=c, kv=has_null_flag, name=name):
            data = xs[0]
            if kv:
                valid = jnp.logical_and(xs[1], group_live)
            else:
                valid = None if c.valid is None else group_live
            return Column(data=data, valid=valid, info=c.info, name=name)

        arrs = [radix_decode(enc, c.data.dtype)]
        if has_null_flag:
            arrs.append(jnp.logical_not(s_key_null[j]))
        add_out(arrs, build_key)

    # AVG-from-siblings CSE (≅ multi_pass_avg reusing its prior sum and
    # count results, groupby.cuh:308-419): when sum and count of the same
    # column are also requested, avg needs no scans of its own and — more
    # importantly — no extra words through the compaction sort (a f64 avg
    # costs 2 routed words; the divide runs post-compaction instead).
    sums = {s[0]: (s[2] if len(s) > 2 else f"sum_{s[0]}")
            for s in aggs if s[1] == "sum"}
    counts = {s[0]: (s[2] if len(s) > 2 else f"count_{s[0]}")
              for s in aggs if s[1] == "count"}
    deferred_avg = {}  # output position -> (out_name, sum_name, cnt_name)

    for spec in aggs:
        col_name, op = spec[0], spec[1]
        out_name = spec[2] if len(spec) > 2 else f"{op}_{col_name}"
        if op == "avg" and col_name in sums and col_name in counts:
            deferred_avg[len(builders)] = (out_name, sums[col_name],
                                           counts[col_name])
            add_out([], None)
            continue
        dslot, vslot = agg_slots[col_name]
        vals = res[dslot]
        avalid = None if vslot is None else res[vslot]
        arrs, build = _scan_agg(vals, avalid, scan_starts, op,
                                group_live, out_name)
        add_out(arrs, build)

    # --- sort 2: ONE compaction sort over every output array ---
    flat, shapes = [], []
    for arrs in out_arrays:
        shapes.append(len(arrs))
        flat.extend(arrs)
    compacted, _ = compact_arrays(flat, keep)
    cols, i = [], 0
    for pos, (cnt, build) in enumerate(zip(shapes, builders)):
        cols.append(None if build is None else build(compacted[i:i + cnt]))
        i += cnt
    by_name = {c.name: c for c in cols if c is not None}
    for pos, (out_name, s_name, c_name) in deferred_avg.items():
        scol, ccol = by_name[s_name], by_name[c_name]
        data = (scol.data.astype(jnp.float64)
                / jnp.maximum(ccol.data, 1).astype(jnp.float64))
        valid = jnp.logical_and(group_live, ccol.data > 0)
        if scol.valid is not None:
            valid = jnp.logical_and(valid, scol.valid)
        cols[pos] = Column(data=data, valid=valid,
                           info=DtypeInfo(GDFDtype.FLOAT64),
                           name=out_name)
    return Table.from_columns(cols, num_rows=num_groups)


def _p0_to_u64(p0):
    """4-byte payload -> its bit pattern as the low half of a u64."""
    return jax.lax.bitcast_convert_type(p0, jnp.uint32).astype(jnp.uint64)


def _p0_from_u64(w, dtype):
    return jax.lax.bitcast_convert_type(
        (w & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32), dtype)


def _fused_groupby_sort(operands, nk, fields):
    """The groupby sort, folding the first payload into the key word.

    Fewer sort operands make a cheaper lax.sort.
    Two folds turn the dominant 2-operand sort into a 1-operand sort
    (unstable u64 1-op measures ~1.4x the 2-op at 11M):

    - STATIC: every key field fits the TOP 32 bits of the single sort
      word (<=32-bit keys, flags included) — the first 4-byte payload's
      bit pattern simply rides the free low half; field unpacking only
      reads the top bits.
    - DYNAMIC: one flag-free 64-bit key whose RUNTIME value range fits
      32 bits — the overwhelmingly common groupby shape (category
      codes, bounded ids, date ordinals stored as int64). Key-min is
      subtracted, the compressed key takes the high half, the payload
      the low. The branch is a runtime lax.cond, the same discipline as
      the join's unique-build fast path (ops/join.py): both programs
      compile, the data picks.

    Ties broken by payload bits are harmless: the sort is unstable and
    every aggregate is order-insensitive. Returns sorted operands in
    the SAME layout as multi_sort(operands, nk, stable=False)."""
    total_bits = sum(nbits for _, nbits in fields)
    foldable_payload = (len(operands) > nk
                        and operands[nk].dtype.itemsize == 4)
    if nk == 1 and foldable_payload and total_bits <= 32:
        # static fold: fields live in the word's top half (pack_bit_
        # fields left-aligns), the payload rides the free low half
        p0 = operands[1]
        w = operands[0] | _p0_to_u64(p0)
        out = multi_sort((w,) + tuple(operands[2:]), num_keys=1,
                         stable=False)
        return (out[0], _p0_from_u64(out[0], p0.dtype)) + out[1:]
    if nk == 1 and foldable_payload and len(fields) == 1 \
            and total_bits == 64:
        enc = operands[0]               # u64 key word (= the encoding)
        p0 = operands[1]
        rest = tuple(operands[2:])
        p0u = _p0_to_u64(p0)
        lo = jnp.min(enc)
        fits = (jnp.max(enc) - lo) < jnp.uint64(1 << 32)

        def packed(_):
            w = ((enc - lo) << jnp.uint64(32)) | p0u
            out = multi_sort((w,) + rest, num_keys=1, stable=False)
            s_enc = (out[0] >> jnp.uint64(32)) + lo
            return (s_enc, _p0_from_u64(out[0], p0.dtype)) + out[1:]

        def general(_):
            return multi_sort(tuple(operands), num_keys=1, stable=False)

        return jax.lax.cond(fits, packed, general, 0)
    return multi_sort(tuple(operands), num_keys=nk, stable=False)


def _scan_agg(vals, avalid, starts, op, group_live, out_name):
    """Per-row segmented scans whose segment-last values are the
    aggregates (≅ thrust::reduce_by_key, sqls_rtti_comp.hpp:468-509, and
    the CAS loop of build_aggregation_table, groupby_kernels.cuh:42-108 —
    minus the atomics). Returns (arrays to compact, builder)."""
    from ..core.dtypes import dtype_from_numpy

    if op in ("count", "count_distinct"):
        ones = (jnp.ones(vals.shape, jnp.int32) if avalid is None
                else avalid.astype(jnp.int32))
        cnt = seg_scan_sum(ones, starts)

        # valid = group_live evaluated at OUTPUT positions (a positional
        # mask must NOT ride through the compaction sort as payload — it
        # would be permuted to segment-last SOURCE positions).
        def build(xs):
            return Column(data=xs[0].astype(jnp.int64), valid=group_live,
                          info=DtypeInfo(GDFDtype.INT64), name=out_name)
        return [cnt], build

    if op == "avg":
        # ≅ multi_pass_avg (groupby.cuh:308-419): sum + count, divide.
        # f64 accumulation for every input dtype: f32 running sums
        # lose digits on large groups.
        fvals = vals.astype(jnp.float64)
        if avalid is not None:
            fvals = jnp.where(avalid, fvals, 0.0)
            ones = avalid.astype(jnp.int32)
        else:
            ones = jnp.ones(vals.shape, jnp.int32)
        tot = seg_scan_sum(fvals, starts)
        cnt = seg_scan_sum(ones, starts)
        avg = tot.astype(jnp.float64) / jnp.maximum(cnt, 1)
        if avalid is None:
            # every group has >= 1 value: valid = liveness alone, and the
            # okay flag need not ride the compaction (fewer routed words)
            def build0(xs):
                return Column(data=xs[0], valid=group_live,
                              info=DtypeInfo(GDFDtype.FLOAT64),
                              name=out_name)
            return [avg], build0
        okay = cnt > 0

        def build(xs):
            valid = jnp.logical_and(group_live, xs[1])
            return Column(data=xs[0], valid=valid,
                          info=DtypeInfo(GDFDtype.FLOAT64), name=out_name)
        return [avg, okay], build

    ident = _agg_identity(op, vals.dtype)
    if avalid is not None:
        vals = jnp.where(avalid, vals, ident)
    if op == "sum":
        out = seg_scan_sum(vals, starts)
    elif op == "min":
        out = seg_scan_min(vals, starts)
    else:
        out = seg_scan_max(vals, starts)

    info = DtypeInfo(dtype_from_numpy(np.dtype(out.dtype)))
    if avalid is None:
        # no nulls: every group aggregates >= 1 value; skip the okay word
        def build0(xs):
            return Column(data=xs[0], valid=group_live, info=info,
                          name=out_name)
        return [out], build0
    nvalid = seg_scan_sum(avalid.astype(jnp.int32), starts)
    okay = nvalid > 0

    def build(xs):
        valid = jnp.logical_and(group_live, xs[1])
        return Column(data=xs[0], valid=valid, info=info, name=out_name)
    return [out, okay], build


def count_distinct_keys(table: Table, key_names: Sequence[str],
                        dropna: bool = True):
    """Scalar number of distinct key tuples.

    ≅ GDF_COUNT_DISTINCT collapsing to a single value
    (sqls_rtti_comp.hpp:400-441 DISTINCT branch)."""
    g = groupby(table, key_names,
                aggs=[(key_names[0], "count", "_c")], dropna=dropna)
    return g.num_rows


# Convenience wrappers matching the reference C API names
def group_by_sum(table, keys, agg_col):
    """≅ gdf_group_by_sum (sqls_ops.cu:1426-1436)."""
    return groupby(table, keys, [(agg_col, "sum", "out")])


def group_by_min(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "min", "out")])


def group_by_max(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "max", "out")])


def group_by_avg(table, keys, agg_col):
    return groupby(table, keys, [(agg_col, "avg", "out")])


def group_by_count(table, keys):
    return groupby(table, keys, [(keys[0], "count", "out")])
