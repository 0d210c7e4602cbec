"""Window functions: partitioned, ordered rolling reductions.

≅ reference gpu_window_function — declared in the ABI (enums
window_function_type / window_reduction_type, types.h:197-210) but left
INCOMPLETE and compiled out of the reference build (CMakeLists.txt:154,
src/windowedops.cu:46-148 is a sketch: hash partition columns, stable
multi-col sort, "perform windowed functions here"). This module finishes
the design the sketch describes:

  1. partition columns → row hash (the sketch's gpu_hash_columns step);
  2. ONE unstable lax.sort over minimal bit-packed u64 key words
     (partition hash | order encodings | row index in the low bits —
     the index gives stability AND the permutation) with the value and
     validity columns riding as payload operands — no gathers (the
     sketch's backwards-stable-sort plan, on the ops/engine.py cost
     model);
  3. windowed reduction = cumulative-scan difference over the sorted
     frame, segment-reset at partition starts — O(n), no per-window
     loops;
  4. back to input order via a second payload sort on the row index.

Supported reductions mirror window_reduction_type: SUM MIN MAX COUNT AVG
STDDEV VAR; window_function_type GDF_WINDOW_ROW (rows-preceding frames).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table
from .hashing import hash_columns
from .sort import radix_encode
from . import engine
from .engine import multi_sort

WINDOW_REDUCTIONS = ("sum", "min", "max", "count", "avg", "stddev", "var")


def _segmented_running(vals, seg_start, op):
    """Running `op` over vals with reset at segment starts — the engine's
    segmented (carry, value) associative scans."""
    if op == "sum":
        return engine.seg_scan_sum(vals, seg_start)
    if op == "min":
        return engine.seg_scan_min(vals, seg_start)
    if op == "max":
        return engine.seg_scan_max(vals, seg_start)
    raise ValueError(op)


def _windowed(vals, valid, seg_start, preceding: int, op: str):
    """Rolling reduction over the frame [i-preceding+1, i] clipped to the
    current partition. O(n) via prefix sums (sum-family) or log-steps of
    shifted min/max (min/max family)."""
    n = vals.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    # first row index of each row's partition: segment-reset running max
    # of (idx at starts, 0 elsewhere) propagates each start index forward
    part_first = _segmented_running(jnp.where(seg_start, idx, 0),
                                    seg_start, "max")
    frame_lo = jnp.maximum(part_first, idx - (preceding - 1))
    w = valid.astype(jnp.float64)
    v = jnp.where(valid, vals.astype(jnp.float64), 0.0)

    if op in ("sum", "count", "avg", "var", "stddev"):
        return _sum_family_over(v, w, frame_lo, op)

    # min/max: EXACT in the input dtype — the ladders run natively
    # (f32/i32 words) instead of x64-emulated f64, which was most
    # of the steady cost at 2M on chip; only the final output casts.
    ident, cur = _minmax_ident(vals, valid, op)
    hv = valid.astype(jnp.int32)                 # any-valid ladder (OR)
    if preceding >= n:
        # unbounded-preceding (running) frame: one segment-reset scan
        run = _segmented_running(cur, seg_start, op)
        has = _segmented_running(hv, seg_start, "sum") > 0
        return run.astype(jnp.float64), has
    # bounded frame, O(n log preceding): doubling ladder of partition-
    # clipped shifted extrema (sparse-table rows), then the length-p
    # window [frame_lo, i] is the op of TWO overlapping 2^K blocks,
    # K = floor(log2(p)) — the second block is a UNIFORM shift of the
    # ladder top, so no gathers at all. Replaces the (n x preceding)
    # band gather of earlier versions (quadratic blowup at large
    # frames).
    vop = jnp.minimum if op == "min" else jnp.maximum
    K = max(preceding.bit_length() - 1, 0)       # 2^K <= preceding
    g = cur
    gh = hv
    for k in range(K):
        s = 1 << k
        g2 = _shift_down(g, s, ident)
        gh2 = _shift_down(gh, s, 0)
        in_part = idx - s >= part_first
        g = vop(g, jnp.where(in_part, g2, ident))
        gh = jnp.maximum(gh, jnp.where(in_part, gh2, 0))
    # block 2 ends at j = i - preceding + 2^K (covers [i-p+1, j]); valid
    # when j >= frame_lo (same partition guaranteed: frame_lo >= first)
    shift2 = preceding - (1 << K)
    j_ok = idx - shift2 >= frame_lo
    red = vop(g, jnp.where(j_ok, _shift_down(g, shift2, ident), ident))
    has = jnp.maximum(gh, jnp.where(j_ok, _shift_down(gh, shift2, 0),
                                    0)) > 0
    return red.astype(jnp.float64), has


def _minmax_ident(vals, valid, op):
    """(identity scalar, invalid-masked values) in the INPUT dtype —
    min/max are exact there; f64 upcasting is deferred to the output."""
    dt = vals.dtype
    if jnp.issubdtype(dt, jnp.floating):
        ident = jnp.asarray(jnp.inf if op == "min" else -jnp.inf, dt)
    else:
        info = jnp.iinfo(dt)
        ident = jnp.asarray(info.max if op == "min" else info.min, dt)
    return ident, jnp.where(valid, vals, ident)


def _shift_down(x, s: int, fill):
    """y[i] = x[i - s], front-filled with `fill` (static s)."""
    if s == 0:
        return x
    return jnp.concatenate([jnp.full((s,), fill, x.dtype), x[:-s]])


def _floor_log2(x):
    """Elementwise floor(log2(x)) for int32 x >= 1, branch-free."""
    r = jnp.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        big = x >= (1 << k)
        r = r + jnp.where(big, k, 0)
        x = jnp.where(big, x >> k, x)
    return r


def _sum_family_over(v, w, frame_lo, op: str):
    """sum/count/avg/var/stddev over per-row frames [frame_lo[i], i]:
    prefix sums + one gather at frame_lo-1. Shared by the ROW path
    (uniform frames clipped at partition starts) and the RANGE path
    (value-searched frames)."""
    csum = engine.cumsum(v)
    csq = engine.cumsum(v * v)
    ccnt = engine.cumsum(w)

    def rangesum(c):
        lo_excl = jnp.where(frame_lo > 0,
                            jnp.take(c, frame_lo - 1, mode="clip"), 0.0)
        return c - lo_excl

    s, sq, cnt = rangesum(csum), rangesum(csq), rangesum(ccnt)
    if op == "sum":
        return s, cnt > 0
    if op == "count":
        return cnt, jnp.ones_like(cnt, jnp.bool_)
    safe = jnp.maximum(cnt, 1.0)
    mean = s / safe
    if op == "avg":
        return mean, cnt > 0
    varv = jnp.maximum(sq / safe - mean * mean, 0.0)
    if op == "var":
        return varv, cnt > 0
    return jnp.sqrt(varv), cnt > 0


def _windowed_range(vals, valid, seg_start, frame_lo, op: str):
    """Reduction over the data-dependent frame [frame_lo[i], i] (RANGE
    frames: frame_lo from a value search, variable length per row).

    sum-family: prefix sums + one gather at frame_lo-1.
    min/max: full sparse table (all doubling levels, partition-clipped)
    + the classic two-block lookup at per-row level K = floor(log2(L))."""
    n = vals.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    part_first = _segmented_running(jnp.where(seg_start, idx, 0),
                                    seg_start, "max")
    w = valid.astype(jnp.float64)
    v = jnp.where(valid, vals.astype(jnp.float64), 0.0)

    if op in ("sum", "count", "avg", "var", "stddev"):
        return _sum_family_over(v, w, frame_lo, op)

    vop = jnp.minimum if op == "min" else jnp.maximum
    ident, cur = _minmax_ident(vals, valid, op)
    hv = valid.astype(jnp.int32)
    # levels 0..floor(log2(n)) inclusive: a frame can span the whole
    # partition, so K reaches log2(n) when n is a power of two — one
    # level fewer (the round-5 review catch) made the flat take read
    # past the table and return NaN extrema for full-span frames.
    nlev = max(n.bit_length(), 1)
    levels, hlevels = [cur], [hv]
    g, gh = cur, hv
    for k in range(nlev - 1):
        s = 1 << k
        in_part = idx - s >= part_first
        g = vop(g, jnp.where(in_part, _shift_down(g, s, ident), ident))
        gh = jnp.maximum(gh, jnp.where(in_part, _shift_down(gh, s, 0),
                                       0))
        levels.append(g)
        hlevels.append(gh)
    gs = jnp.stack(levels)          # (nlev, n)
    ghs = jnp.stack(hlevels)
    length = idx - frame_lo + 1
    K = _floor_log2(jnp.maximum(length, 1))
    flat_i = K * n + idx
    flat_j = K * n + (frame_lo + (1 << K) - 1)
    red = vop(jnp.take(gs.reshape(-1), flat_i),
              jnp.take(gs.reshape(-1), flat_j)).astype(jnp.float64)
    has = jnp.maximum(jnp.take(ghs.reshape(-1), flat_i),
                      jnp.take(ghs.reshape(-1), flat_j)) > 0
    return red, has


def window_function(table: Table, value_name: str, reduction: str,
                    preceding=None,
                    partition_by: Sequence[str] = (),
                    order_by: Sequence[str] = (),
                    frame: str = "rows") -> Column:
    """Rolling `reduction` over `value_name`, per partition, in sort
    order. Result is aligned to the INPUT row order (scatter-back, like
    SQL window semantics).

    frame="rows" (GDF_WINDOW_ROW): the frame is `preceding` ROWS up to
    the current row (None = all preceding, i.e. running/cumulative).
    frame="range" (GDF_WINDOW_RANGE): the frame is every row of the
    partition whose (single, numeric) order-by VALUE lies in
    [current - preceding, current] — `preceding` is a value delta.
    The frame bound comes from one vectorized lexicographic search over
    the (partition, order) sort (lex_searchsorted), variable-length
    reductions from a partition-clipped sparse table.

    ≅ gpu_window_function's intended contract (windowedops.cu:46-148);
    closes both members of window_function_type (types.h:197-210)."""
    require(reduction in WINDOW_REDUCTIONS,
            GDFStatus.GDF_INVALID_AGGREGATOR, reduction)
    require(frame in ("rows", "range"), GDFStatus.GDF_INVALID_API_CALL,
            f"frame must be 'rows' or 'range', got {frame!r}")
    if frame == "range":
        require(len(order_by) == 1, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE frames need exactly one order_by column")
        require(preceding is not None, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE frames need a numeric `preceding` delta")
        require(float(preceding) >= 0, GDFStatus.GDF_INVALID_API_CALL,
                "RANGE preceding must be >= 0")
    n = table.capacity
    require(n > 0, GDFStatus.GDF_DATASET_EMPTY)
    col = table.column(value_name)

    # 1. partition id (hash of partition columns — windowedops.cu:72-81)
    operands = []
    # ONE packed unstable sort, engine-cost-model style (ops/engine.py):
    # partition hash + order encodings + row index bit-pack into minimal
    # u64 words (index-in-low-bits = stability + the permutation), and
    # the value/validity columns ride as PAYLOAD operands — no gathers.
    # Keys are recovered from the sorted words (unpack/decode), and the
    # scatter-back becomes a second payload sort on the row index.
    # (Round-4 shape was a stable 3-operand sort + 2 gathers + 2
    # scatters — each gather/scatter costs ~8x its sort-payload ride.)
    from .sort import bit_field_offsets, pack_bit_fields, radix_decode, \
        unpack_bit_field
    fields = []
    if partition_by:
        ph = hash_columns([table.column(c) for c in partition_by])
        fields.append((ph, 32))
    enc_bits = []
    for name in order_by:
        c = table.column(name)
        enc = radix_encode(c.data, True)
        enc_bits.append(enc.dtype.itemsize * 8)
        fields.append((enc, enc_bits[-1]))
    iota_bits = max(1, (max(n - 1, 1)).bit_length())
    payloads = [col.data]
    has_valid = col.valid is not None or table.num_rows is not None
    if has_valid:
        v0 = (jnp.ones((n,), jnp.bool_) if col.valid is None
              else col.valid)
        if table.num_rows is not None:
            v0 = jnp.logical_and(v0, table.live_mask())
        payloads.append(v0)
    if fields:
        words = pack_bit_fields(fields, iota_bits=iota_bits, n=n)
        nk = len(words)
        res = multi_sort(tuple(words) + tuple(payloads), num_keys=nk,
                         stable=False)
        s_words = list(res[:nk])
        offs, _ = bit_field_offsets([f[1] for f in fields])
        perm = (res[nk - 1] & jnp.uint64((1 << iota_bits) - 1)).astype(
            jnp.int32)
        sorted_part = (unpack_bit_field(s_words, offs[0], 32)
                       if partition_by else None)
        vals = res[nk]
        valid = (res[nk + 1] if has_valid
                 else jnp.ones((n,), jnp.bool_))
    else:
        perm = jnp.arange(n, dtype=jnp.int32)
        sorted_part = None
        vals = payloads[0]
        valid = (payloads[1] if has_valid
                 else jnp.ones((n,), jnp.bool_))

    if sorted_part is not None:
        seg_start = jnp.concatenate([
            jnp.ones((1,), jnp.bool_),
            sorted_part[1:] != sorted_part[:-1]])
    else:
        seg_start = jnp.zeros((n,), jnp.bool_).at[0].set(True)

    if frame == "range":
        # frame_lo[i] = first row of i's partition with order value >=
        # o[i] - preceding: one lex search over the (partition, order)
        # sort the rows already sit in. The sorted order values DECODE
        # from the key words (no gather); the query is encoded in VALUE
        # space (radix_encode is monotone) with overflow-clipped
        # subtraction for integer keys.
        from .join import lex_searchsorted
        ocol = table.column(order_by[0])
        j0 = 1 if partition_by else 0
        enc_o = unpack_bit_field(s_words, offs[j0], enc_bits[0])
        if enc_bits[0] <= 32:
            enc_o = enc_o.astype(jnp.uint32)
        o_sorted = radix_decode(enc_o, ocol.data.dtype)
        if jnp.issubdtype(ocol.data.dtype, jnp.floating):
            q = o_sorted - jnp.asarray(preceding, o_sorted.dtype)
        else:
            # integer order key: o_j >= o_i - delta  <=>
            # o_j >= o_i - floor(delta)  (delta >= 0), overflow-clipped
            import math
            info = jnp.iinfo(ocol.data.dtype)
            q64 = (o_sorted.astype(jnp.int64)
                   - jnp.int64(math.floor(preceding)))
            q = jnp.clip(q64, info.min, info.max).astype(o_sorted.dtype)
        enc_q = radix_encode(q, True).astype(enc_o.dtype)
        skeys = ([sorted_part, enc_o] if sorted_part is not None
                 else [enc_o])
        qkeys = ([sorted_part, enc_q] if sorted_part is not None
                 else [enc_q])
        frame_lo = lex_searchsorted(skeys, qkeys, "left")
        out_sorted, has = _windowed_range(vals, valid, seg_start,
                                          frame_lo, reduction)
    else:
        prec = n if preceding is None else int(preceding)
        require(prec >= 1, GDFStatus.GDF_INVALID_API_CALL,
                "preceding must be >= 1")
        out_sorted, has = _windowed(vals, valid, seg_start, prec,
                                    reduction)

    # 4. back to input order: ONE payload sort on the row index (the
    # engine's gather/scatter replacement), not two scatters.
    back = multi_sort((perm, out_sorted, has), num_keys=1, stable=False)
    return Column(data=back[1], valid=back[2],
                  info=DtypeInfo(GDFDtype.FLOAT64),
                  name=f"{value_name}_{reduction}")
