"""Vectorized sorted-search (match ranges) via ONE merge-by-sort.

The direct analogue of mgpu::sorted_search (reference
src/join/sort/sort-join.cuh:48-66), without its log(n) rounds of
binary-search gathers and without one sort per bound side. This computes EVERYTHING the join needs from a single sort:

    sort [build keys ++ probe keys] with a tiebreak flag ordering build
    rows before equal probe rows. At sorted position p:
      - nbuild_before(p) = cumsum of is_build — for a probe row this IS
        its upper bound;
      - the equal-key run start carries the lower bound: segment-reset
        running-max propagation of nbuild_before at key-change positions
        (pure scans, no gathers);
      - for a build row, nbuild_before(p) is its rank in build-sorted
        order → scatter yields the build permutation (sorted build
        position → original build row), replacing a separate build-side
        sort.

Cost: one (n+m)-row multi-operand sort + a few cumsum/cummax scans +
two scatters — all bandwidth-shaped. Replaces three sorts and a 21-round
gather loop. Its speed against the gather formulation on the GPU is not
measured.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import engine


def merge_match_ranges(build_keys, query_keys):
    """(build_perm int32[n], lower int32[m], upper int32[m]).

    `build_keys` / `query_keys`: lists of uint key-word arrays (most
    significant first), as produced by radix_encode. For each query row:
    build rows with sorted-build positions in [lower, upper) have keys
    equal to it. `build_perm[s]` = original build row at sorted-build
    position s."""
    n = build_keys[0].shape[0]
    m = query_keys[0].shape[0]

    is_query = jnp.concatenate([
        jnp.zeros((n,), jnp.int8), jnp.ones((m,), jnp.int8)])
    back = jnp.concatenate([
        jnp.arange(n, dtype=jnp.int32), jnp.arange(m, dtype=jnp.int32)])

    operands = tuple(
        jnp.concatenate([b, q]) for b, q in zip(build_keys, query_keys)
    ) + (is_query, back)
    # tiebreak key = is_query: build (0) sorts before equal probe (1)
    res = jax.lax.sort(operands, num_keys=len(build_keys) + 1,
                       is_stable=True)
    s_keys = res[:len(build_keys)]
    s_isq = res[-2].astype(jnp.int32)
    s_back = res[-1]

    is_build = 1 - s_isq
    nbuild_before = engine.cumsum(is_build) - is_build  # exclusive

    # upper bound for query rows = build elements strictly before them
    # (ties sort build-first, so equal build rows are counted). Scatter
    # back to query order; build rows carry 0 into a zero-init max.
    upper = jnp.zeros((m,), jnp.int32).at[s_back].max(
        jnp.where(s_isq == 1, nbuild_before, 0))

    # lower bound = nbuild_before at each element's equal-key run start,
    # propagated by a segment-reset running max (run starts carry their
    # own nbuild_before; others carry -1 and inherit the running max).
    key_change = jnp.zeros((n + m,), jnp.bool_).at[0].set(True)
    for k in s_keys:
        key_change = jnp.logical_or(
            key_change,
            jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             k[1:] != k[:-1]]))
    run_lower = jnp.where(key_change, nbuild_before, -1)
    run_lower = engine.cummax(run_lower)
    lower = jnp.zeros((m,), jnp.int32).at[s_back].max(
        jnp.where(s_isq == 1, run_lower, 0))

    # build permutation: sorted-build position -> original build row
    build_perm = jnp.zeros((max(n, 1),), jnp.int32).at[
        jnp.where(s_isq == 0, nbuild_before, 0)].max(
        jnp.where(s_isq == 0, s_back, 0))[:n]
    return build_perm, lower, upper


def sorted_search_bounds(sorted_keys, query_keys):
    """(lower, upper) int32[m] insertion bounds of each query row into the
    ALREADY-SORTED multi-key arrays (np.searchsorted left/right)."""
    _, lower, upper = merge_match_ranges(sorted_keys, query_keys)
    return lower, upper
