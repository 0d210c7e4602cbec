"""Joins: inner / left / full (outer), single- or multi-column keys.

≅ reference:
  - C API gdf_inner_join / gdf_left_join / gdf_full_join
    (libgdf/src/join/joining.cu:571-653) returning left/right index columns;
  - hash join core: build-side multimap + probe kernel with warp-cooperative
    output caching and an estimate/retry sizing loop
    (src/join/hash/join_compute_api.h:341-551, join_kernels.cuh:259-455);
  - sort-merge join: mgpu sorted_search lower/upper bounds + scan + emit
    (src/join/sort/sort-join.cuh:48-246);
  - FULL = LEFT + append_full_join_indices (join_compute_api.h:54-186);
  - result materialization construct_join_output_df (joining.cu:375-479).

Design — sort + vectorized binary search (the reference's own SORT path
generalized, replacing its HASH path entirely). Instead of a multimap with
atomicCAS probing:
    1. the build side is sorted once by its (normalized) key columns;
    2. one **vectorized lexicographic binary search** finds, for every probe
       row simultaneously, the [lower, upper) range of matching build rows —
       ~log2(n) rounds of gathers, all lanes advancing in lockstep (the
       direct analogue of mgpu::sorted_search, sort-join.cuh:48-66);
    3. match counts = upper - lower; an exclusive scan assigns output
       offsets (≅ scan_join_bounds, sort-join.cuh:68+);
    4. the emit pass inverts the offsets with one searchsorted: output slot
       j belongs to probe row i = bucket of j in offsets, match rank
       j - offsets[i]. Deterministic, no atomics, no retry loop — the
       estimate/resample/double dance of join_compute_api.h:204-321/459-505
       is replaced by an exact count pass.

  Null semantics match the reference exactly: rows with a NULL in any key
  column never match (NULL != NULL, gdf_table.cuh:588-591); LEFT emits
  right_index = -1 for unmatched, FULL additionally emits (-1, r) for
  unmatched build rows. Unlike the reference there is no int32 output-size
  ceiling per se (joining.cu:32-35) — capacity is whatever fits in HBM.

  Float keys: -0.0 is canonicalized to +0.0 (C's == treats them equal) and
  NaN keys never match (C's NaN != NaN). Multi-column keys need no
  hash-verify step — the lexicographic search is exact.

Output sizing: `out_capacity` (static) + returned count. Eagerly (outside
jit), capacity=None runs the count pass first and allocates exactly — the
deterministic version of the reference's estimate+retry.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.bitmask import mask_and  # used by join()s gather helpers
from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table
from . import engine
from .engine import last_valid_scan, multi_sort
from .sort import radix_encode

# ---------------------------------------------------------------------------
# Key normalization
# ---------------------------------------------------------------------------


def _join_keys(table: Table, names: Sequence[str]):
    """Return (encoded key arrays [uint], no_match bool[n]).

    no_match marks rows that can never participate: NULL key (in any key
    column), NaN float key, or dead row (capacity+count padding)."""
    keys, no_match = [], None
    for name in names:
        col = table.column(name)
        data = col.data
        if jnp.issubdtype(data.dtype, jnp.floating):
            no_match = mask_or(no_match, jnp.isnan(data))
            data = jnp.where(data == 0, jnp.zeros_like(data), data)  # -0.0
        keys.append(radix_encode(data, ascending=True))
        if col.valid is not None:
            no_match = mask_or(no_match, jnp.logical_not(col.valid))
    if table.num_rows is not None:
        no_match = mask_or(no_match, jnp.logical_not(table.live_mask()))
    return keys, no_match


def mask_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return jnp.logical_or(a, b)


# ---------------------------------------------------------------------------
# Vectorized lexicographic binary search
# ---------------------------------------------------------------------------


def lex_searchsorted(sorted_keys, query_keys, side: str) -> jax.Array:
    """For each query row, the insertion point into the lexicographically
    sorted multi-key arrays. All queries advance in lockstep: log2(n)
    rounds, each one gather + compare per key column (the analogue of
    mgpu sorted_search, sort-join.cuh:48-66).

    Engine consumers: window RANGE frames (ops/window.py) locate each
    row's value-bounded frame start with one lex search over the
    (partition, order) sort. (The join itself uses the merged-sort emit
    plan below instead.)"""
    n = sorted_keys[0].shape[0]
    m = query_keys[0].shape[0]
    steps = max(1, (n + 1).bit_length())
    le = side == "right"  # advance on equality for upper bound

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        # lexicographic compare: sorted[mid] (<|<=) query
        lt = jnp.zeros((m,), jnp.bool_)
        eq = jnp.ones((m,), jnp.bool_)
        for s, q in zip(sorted_keys, query_keys):
            sv = jnp.take(s, mid, mode="clip")
            lt = jnp.logical_or(lt, jnp.logical_and(eq, sv < q))
            eq = jnp.logical_and(eq, sv == q)
        go_right = jnp.logical_or(lt, eq) if le else lt
        go_right = jnp.logical_and(go_right, lo < hi)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(jnp.logical_or(go_right, lo >= hi), hi, mid)
        return lo, hi

    # Derive the init carry from the inputs so it inherits their
    # device-varying type under shard_map (a fresh jnp.zeros is unvarying
    # and trips the scan carry-type check inside shard-local bodies).
    zero = ((query_keys[0] != query_keys[0]) |
            (sorted_keys[0][:1] != sorted_keys[0][:1]).any()).astype(
        jnp.int32) * 0
    lo = jnp.zeros((m,), jnp.int32) + zero
    hi = jnp.full((m,), n, jnp.int32) + zero
    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


# ---------------------------------------------------------------------------
# Join core
# ---------------------------------------------------------------------------


def join_indices(left: Table, right: Table, left_on: Sequence[str],
                 right_on: Sequence[str], how: str = "inner",
                 out_capacity: int | None = None,
                 assume_unique_build: bool = False):
    """Compute join index columns.

    `assume_unique_build=True` is a PLANNER HINT that the build (right)
    side has no duplicate keys (PK-FK join): only the gather-free fast
    path is compiled — half the program of the dynamic dual-path join
    (≅ the caller-picked method knob of gdf_context, types.h:161-167).
    The hint is VERIFIED at runtime: if the build side does hold
    duplicates, the returned count is poisoned to -1 (never a silent
    wrong answer).

    Returns (left_idx: int32[cap], right_idx: int32[cap], count) where
    -1 marks the unmatched side of an outer row — exactly the reference's
    output convention (joining.cu:375-479 gathers with range_check on -1).

    ≅ gdf_inner_join / gdf_left_join / gdf_full_join (joining.cu:571-653).
    The build side is always `right` (≅ join_hash builds on right,
    joining.h:47-76; the reference flips inner joins to build on the
    smaller side — here the sort cost is symmetric and flipping is the
    caller's planner decision, see parallel/distributed.py).

    Everything is computed in merge-sorted key space — match ranges, emit
    counts, the FULL join's unmatched-build detection (a reverse cummin
    instead of the reference's second probe pass) and output offsets —
    so the only position-indexed ops are ONE scatter (slot → sorted
    position, the analogue of the probe kernel's atomicAdd output index,
    join_kernels.cuh:259-455) and two row-gathers."""
    require(how in ("inner", "left", "full"),
            GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE, how)
    from ..utils.metrics import op_metrics, table_bytes
    with op_metrics("LIBGDF_JOIN", rows_in=left.capacity + right.capacity,
                    bytes_est=table_bytes(left) + table_bytes(right)) as _m:
        out = _join_indices_impl(left, right, left_on, right_on, how,
                                 out_capacity, assume_unique_build)
        _m["rows_out"] = out[2]
    return out


def _join_indices_impl(left, right, left_on, right_on, how, out_capacity,
                       assume_unique_build=False):
    require(len(left_on) == len(right_on) and len(left_on) > 0,
            GDFStatus.GDF_JOIN_DTYPE_MISMATCH, "key column count mismatch")
    for a, b in zip(left_on, right_on):
        require(left.column(a).info.gdf_dtype ==
                right.column(b).info.gdf_dtype,
                GDFStatus.GDF_JOIN_DTYPE_MISMATCH,
                f"join key dtype mismatch {a}/{b}")

    n, m = right.capacity, left.capacity
    L = n + m
    # No combined-rows ceiling: the emit payload is packed into int64
    # (positions to 2^61), strictly beyond the reference's int32 output cap
    # (joining.cu:32-35) which SURVEY §5 bans inheriting.

    bkeys, b_nomatch = _join_keys(right, right_on)
    pkeys, p_nomatch = _join_keys(left, left_on)

    b_live = (jnp.ones((n,), jnp.bool_) if right.num_rows is None
              else right.live_mask())
    p_live = (jnp.ones((m,), jnp.bool_) if left.num_rows is None
              else left.live_mask())

    total, emit, offsets, s_back, run_lower, flag_bits, aux = _emit_plan(
        how, bkeys, pkeys, b_nomatch, p_nomatch, b_live, p_live)

    if out_capacity is None:
        try:
            out_capacity = int(total)   # eager: exact allocation
        except jax.errors.ConcretizationTypeError:
            raise ValueError(
                "join under jit requires a static out_capacity") from None
    cap = int(out_capacity)
    # Capacity-overflow contract (no silent truncation): eagerly this
    # raises; under jit the caller must check `count <= out_capacity`
    # (the count returned is always EXACT — see parallel/distributed.py
    # dist_join for the recover-by-resize pattern).
    try:
        require(int(total) <= cap, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                f"join output {int(total)} rows > out_capacity {cap}")
    except jax.errors.ConcretizationTypeError:
        pass
    if cap == 0 or L == 0:
        neg = jnp.full((cap,), -1, jnp.int32)
        return neg, neg, total

    isq = aux["isq"]
    live = aux["live"]
    matchable = aux["matchable"]
    cnt = aux["cnt"]
    is_build = jnp.logical_not(isq)

    # A run's build multiplicity: 1-based build rank within its run. When
    # every (matchable) run holds <= 1 build row, each probe row matches at
    # most once and the join needs NO expansion — the dominant real-world
    # shape (PK-FK joins; the reference optimizes the same case by building
    # on the unique side, joining.h:57-70).
    b_rank = jnp.where(jnp.logical_and(is_build, matchable),
                       aux["nbuild_before"] - run_lower + 1, 0)
    unique_build = jnp.max(b_rank) <= 1

    def fast_path(_):
        # Gather-free: propagate the run's single build row id forward
        # (build rows sort before probes within a run), keep emitting rows
        # with ONE compaction sort. Emission order matches the general
        # path (both are merged-key order).
        b_fill, _seen = last_valid_scan(is_build, s_back)
        keep = jnp.logical_and(isq, cnt > 0)
        l_src = jnp.where(isq, s_back, -1)
        r_src = jnp.where(jnp.logical_and(isq, cnt > 0), b_fill, -1)
        if how in ("left", "full"):
            keep = jnp.logical_or(
                keep, jnp.logical_and(jnp.logical_and(isq, live), cnt == 0))
        if how == "full":
            bu = jnp.logical_and(jnp.logical_and(is_build, live),
                                 jnp.logical_not(aux["b_matched"]))
            keep = jnp.logical_or(keep, bu)
            r_src = jnp.where(is_build, s_back, r_src)
        (l_c, r_c), _cnt2 = _compact2(keep, l_src, r_src)
        return _fit_cap(l_c, cap), _fit_cap(r_c, cap)

    def general_path(_):
        # Many-to-many expansion: scatter each emitting position's data
        # at its output offset, carry-fill forward, rank = slot - base.
        # Two scatter words over the L sources:
        #   w1 = (s_back+1) << 2 | flags   (s_back < 2^28 = _PACK_MAX)
        #   w2 = run_lower + 1
        # Offsets at or past cap (or wrapped negative past 2^31 on a
        # >2^31-row overflow) are dropped slots; the count stays exact.
        # i32 words when row ids fit 28 bits; the int64 flavor keeps
        # giant shards correct (no 2^28/2^31 output ceiling — the
        # reference's int32 cap, joining.cu:32-35). Static.
        wdt = (jnp.int32 if max(n, m, 1) < _PACK_MAX else jnp.int64)
        j = jnp.arange(cap, dtype=jnp.int32)
        # cap = out of bounds, dropped; so are negative (wrapped) offsets,
        # which .at[] would otherwise count from the end.
        src = jnp.where(jnp.logical_and(emit > 0, offsets >= 0), offsets,
                        cap)
        w1s = ((s_back.astype(wdt) + 1) << 2) | flag_bits.astype(wdt)
        w1_0 = jnp.zeros((cap,), wdt).at[src].max(w1s, mode="drop")
        lo0 = jnp.zeros((cap,), jnp.int32).at[src].max(
            run_lower + 1, mode="drop")
        base = engine.cummax(jnp.where(w1_0 > 0, j, -1))
        rank = j - base
        w1 = last_valid_scan(w1_0 > 0, w1_0)[0]
        lo_j = last_valid_scan(lo0 > 0, lo0)[0] - 1
        from_query = (w1 & 2) != 0
        matched = (w1 & 1) != 0
        s_back_j = ((w1 >> 2) - 1).astype(jnp.int32)

        # Build permutation (sorted-build position → original build row)
        # from a small sort of the build side alone; stability makes it
        # positionally consistent with build ranks in the merged order.
        # Inside this branch so a runtime fast-path join never pays it.
        if n > 0:
            bflag = (jnp.zeros((n,), jnp.uint8) if b_nomatch is None
                     else b_nomatch.astype(jnp.uint8))
            bsort = multi_sort(
                tuple([bflag] + bkeys + [jnp.arange(n, dtype=jnp.int32)]),
                num_keys=1 + len(bkeys))
            build_perm = bsort[-1]
        else:
            build_perm = jnp.zeros((1,), jnp.int32)

        r_sorted_pos = jnp.clip(lo_j + rank, 0, max(n - 1, 0))
        r_from_match = jnp.take(build_perm, r_sorted_pos)

        q = from_query
        left_idx = jnp.where(q, s_back_j, -1)
        right_idx = jnp.where(jnp.logical_and(q, matched), r_from_match, -1)
        if how == "full":
            b = jnp.logical_not(from_query)
            right_idx = jnp.where(b, s_back_j, right_idx)
        return left_idx, right_idx

    if assume_unique_build:
        # hint: compile only the fast path; verify the hint and poison
        # the count on violation rather than emit a wrong join.
        left_idx, right_idx = fast_path(0)
        total = jnp.where(unique_build, total, jnp.int64(-1))
    else:
        left_idx, right_idx = jax.lax.cond(unique_build, fast_path,
                                           general_path, 0)
    j = jnp.arange(cap, dtype=jnp.int64)
    slot_live = j < total
    left_idx = jnp.where(slot_live, left_idx, -1)
    right_idx = jnp.where(slot_live, right_idx, -1)
    return left_idx, right_idx, total


def _compact2(keep, a, b):
    """Compact two int32 arrays by `keep` with one fused sort."""
    from .compaction import compact_arrays
    return compact_arrays([a, b], keep)


def _fit_cap(x, cap):
    n = x.shape[0]
    if cap <= n:
        return x[:cap]
    return jnp.concatenate([x, jnp.full((cap - n,), -1, x.dtype)])


def _ones(x, n):
    return jnp.ones((n,), jnp.bool_) if x is None else x


_PACK_MAX = 1 << 28  # per-side row ceiling of the packed emit plan


def _emit_plan(how, bkeys, pkeys, b_nomatch, p_nomatch, b_live, p_live):
    """Merge-sort both sides on their keys and compute, per sorted
    position: the emit count, exclusive output offsets, original row id
    (`back`) and equal-key-run lower bound (matchable-build rank of the
    run start).

    ≅ the reference's output-size estimation + probe passes
    (join_compute_api.h:204-321) collapsed into exact scans:
      upper bound  = exclusive cumsum of matchable builds (builds sort
                     before queries within a run via the is_query bit);
      lower bound  = run-start propagation (cummax with -1 gaps);
      FULL join    : a build row is matched iff its run holds ≥1
                     matchable query row — reverse cummin of run ids over
                     query positions (replaces the reference's second
                     probe pass, join_compute_api.h:54-186).

    The merge sort is PACKED for single-key joins: everything —
    encoding, is_query bit, matchable bit, live bit, row index — rides in
    one u64 word (32-bit encodings; unstable 1-operand sort) or two
    (64-bit encodings), the dominant cost of the whole join. Word layout
    (low word): [63:32] enc32 | [31] is_query | [30] matchable |
    [29] live | [28:0] row index. The matchable bit's position makes
    no-match builds sort BEFORE matchable builds inside a run, so the
    fast path's forward fill always lands on a matchable build.
    Multi-key joins keep the general multi-operand sort with a leading
    no-match flag word.

    Returns (total, emit, offsets, s_back, run_lower, flag_bits, aux) —
    all per sorted position; flag_bits packs (is_query << 1) | has_match
    for the emit-inversion payload."""
    n = b_live.shape[0]
    m = p_live.shape[0]
    L = n + m
    if L == 0:
        z = jnp.zeros((0,), jnp.int32)
        return jnp.int32(0), z, z, z, z, z, {}

    packed = (len(bkeys) == 1 and max(n, m) < _PACK_MAX)
    if packed:
        enc = jnp.concatenate([bkeys[0], pkeys[0]]).astype(jnp.uint64)
        isq_b = jnp.concatenate([jnp.zeros((n,), jnp.uint64),
                                 jnp.ones((m,), jnp.uint64)])
        matchable_b = jnp.concatenate([
            _ones(None if b_nomatch is None else ~b_nomatch, n),
            _ones(None if p_nomatch is None else ~p_nomatch, m)]).astype(
                jnp.uint64)
        live_b = jnp.concatenate([b_live, p_live]).astype(jnp.uint64)
        back_b = jnp.concatenate([
            jnp.arange(n, dtype=jnp.uint64),
            jnp.arange(m, dtype=jnp.uint64)])
        low = ((isq_b << 31) | (matchable_b << 30) | (live_b << 29)
               | back_b)
        if bkeys[0].dtype.itemsize <= 4:
            res = multi_sort(((enc << 32) | low,), num_keys=1,
                             stable=False)
            s_low = res[0]
            s_enc_keys = [res[0] >> 32]
        else:
            # 64-bit keys: when the RUNTIME key range fits 32 bits (the
            # common case for int64 ids), compress and share one sort
            # word — the same dynamic fold as groupby's payload sort
            # (ops/groupby.py::_fused_groupby_sort); a runtime cond
            # picks, both programs compile.
            klo = jnp.min(enc)
            fits = (jnp.max(enc) - klo) < jnp.uint64(1 << 32)

            def packed_sort(_):
                w = ((enc - klo) << jnp.uint64(32)) | low
                out = multi_sort((w,), num_keys=1, stable=False)
                return (out[0] >> jnp.uint64(32)) + klo, out[0]

            def general_sort(_):
                out = multi_sort((enc, low), num_keys=2, stable=False)
                return out[0], out[1]

            s_enc, s_low = jax.lax.cond(fits, packed_sort, general_sort,
                                        0)
            s_enc_keys = [s_enc]
        s_isq = ((s_low >> 31) & jnp.uint64(1)).astype(jnp.int32)
        s_matchable = ((s_low >> 30) & jnp.uint64(1)) != 0
        s_live = ((s_low >> 29) & jnp.uint64(1)) != 0
        s_back = (s_low & jnp.uint64(_PACK_MAX * 2 - 1)).astype(jnp.int32)
        countable = jnp.logical_and(s_isq == 0, s_matchable).astype(
            jnp.int32)
    else:
        # General multi-key path: a leading no-match flag word pushes
        # no-match build rows past every query run, so every build row in
        # a query's run is matchable (countable = is_build).
        bflag = (jnp.zeros((n,), jnp.uint8) if b_nomatch is None
                 else b_nomatch.astype(jnp.uint8))
        flag = jnp.concatenate([bflag, jnp.zeros((m,), jnp.uint8)])
        is_query = jnp.concatenate([
            jnp.zeros((n,), jnp.uint8), jnp.ones((m,), jnp.uint8)])
        back = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                                jnp.arange(m, dtype=jnp.int32)])

        def _ctl(nomatch, live):
            matchable = (jnp.ones_like(live) if nomatch is None
                         else jnp.logical_not(nomatch))
            return matchable.astype(jnp.uint8) | (live.astype(jnp.uint8)
                                                  << 1)

        ctl = jnp.concatenate([_ctl(b_nomatch, b_live),
                               _ctl(p_nomatch, p_live)])
        keys = [jnp.concatenate([b, q]) for b, q in zip(bkeys, pkeys)]
        res = multi_sort(tuple([flag] + keys + [is_query, back, ctl]),
                         num_keys=1 + len(keys) + 1)
        s_enc_keys = res[:1 + len(keys)]   # flag word participates in runs
        s_isq = res[-3].astype(jnp.int32)
        s_back = res[-2]
        s_ctl = res[-1]
        s_matchable = (s_ctl & 1) != 0
        s_live = (s_ctl & 2) != 0
        countable = 1 - s_isq

    nbuild_before = engine.cumsum(countable, jnp.int32) - countable

    key_change = jnp.zeros((L,), jnp.bool_).at[0].set(True)
    for k in s_enc_keys:
        key_change = jnp.logical_or(
            key_change,
            jnp.concatenate([jnp.ones((1,), jnp.bool_), k[1:] != k[:-1]]))
    run_lower = engine.cummax(jnp.where(key_change, nbuild_before, -1))

    isq = s_isq == 1
    matchable = s_matchable
    live = s_live
    cnt = jnp.where(jnp.logical_and(isq, matchable),
                    nbuild_before - run_lower, 0)
    has_match = cnt > 0
    emit = cnt
    aux = dict(isq=isq, live=live, matchable=matchable, cnt=cnt,
               nbuild_before=nbuild_before, countable=countable)
    if how in ("left", "full"):
        emit = jnp.where(isq & live & (cnt == 0), 1, emit)
    if how == "full":
        run_id = engine.cumsum(key_change, jnp.int32) - 1
        qrun = jnp.where(isq & matchable, run_id, jnp.int32(2**31 - 1))
        b_matched = jnp.logical_and(
            engine.cummin(qrun, reverse=True) == run_id,
            jnp.logical_and(~isq, matchable))
        emit = jnp.where(~isq & live & ~b_matched, 1, emit)
        aux["b_matched"] = b_matched

    offsets = engine.cumsum(emit, jnp.int32) - emit
    # Exact count in int64 — never wraps even when the int32 offsets would
    # (rows past the caller's capacity are dropped by the scatter, but the
    # returned count is always true, so overflow is detectable).
    total = jnp.sum(emit, dtype=jnp.int64)
    flag_bits = (s_isq << 1) | has_match.astype(jnp.int32)
    return total, emit, offsets, s_back, run_lower, flag_bits, aux


def join(left: Table, right: Table, left_on: Sequence[str],
         right_on: Sequence[str], how: str = "inner",
         out_capacity: int | None = None,
         suffixes=("_x", "_y")) -> Table:
    """Materialized join result.

    ≅ construct_join_output_df (joining.cu:375-479): key columns come from
    the left side (right side for FULL-join rows with no left match);
    non-key columns of both tables are gathered by the index columns, with
    -1 indices producing NULLs."""
    l_idx, r_idx, count = join_indices(left, right, left_on, right_on,
                                       how, out_capacity)
    cols = []
    # Join key columns: left values, patched from right where left is -1.
    for lname, rname in zip(left_on, right_on):
        lcol = left.column(lname)
        lc = _gather_col(lcol, l_idx)
        if how == "full":
            rc = _gather_col(right.column(rname), r_idx)
            data = jnp.where(l_idx >= 0, lc.data, rc.data)
            lv = _gather_valid(lcol, l_idx)
            rv = _gather_valid(right.column(rname), r_idx)
            valid = jnp.where(l_idx >= 0, lv, rv)
            lc = Column(data=data, valid=valid, info=lcol.info, name=lname)
        cols.append(lc.with_name(lname))
    taken = {n for n in left_on}
    for name in left.names:
        if name in taken:
            continue
        cols.append(_gather_col(left.column(name), l_idx).with_name(
            name if name not in right.names else name + suffixes[0]))
    for name in right.names:
        if name in right_on:
            continue
        cols.append(_gather_col(right.column(name), r_idx).with_name(
            name if name not in left.names else name + suffixes[1]))
    return Table.from_columns(cols, num_rows=count)


def _gather_valid(col: Column, idx):
    ok = idx >= 0
    if col.valid is None or col.size == 0:
        return ok
    return jnp.logical_and(ok, jnp.take(col.valid, idx, mode="clip"))


def _gather_col(col: Column, idx) -> Column:
    if col.size == 0:
        # empty side: every index is -1; emit an all-NULL column
        data = jnp.zeros(idx.shape, col.data.dtype)
        return Column(data=data, valid=jnp.zeros(idx.shape, jnp.bool_),
                      info=col.info, name=col.name)
    data = jnp.take(col.data, jnp.clip(idx, 0, None), mode="clip")
    return Column(data=data, valid=_gather_valid(col, idx),
                  info=col.info, name=col.name)


def inner_join(left, right, left_on, right_on, **kw):
    """≅ gdf_inner_join (joining.cu:599-625)."""
    return join_indices(left, right, left_on, right_on, "inner", **kw)


def left_join(left, right, left_on, right_on, **kw):
    """≅ gdf_left_join (joining.cu:571-597)."""
    return join_indices(left, right, left_on, right_on, "left", **kw)


def full_join(left, right, left_on, right_on, **kw):
    """≅ gdf_full_join (joining.cu:627-653)."""
    return join_indices(left, right, left_on, right_on, "full", **kw)
