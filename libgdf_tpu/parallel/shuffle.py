"""Distributed shuffle: hash-partition + all_to_all exchange.

The reference's `gdf_hash_partition` (libgdf/src/hashing.cu:559-654) was
explicitly designed as the building block for multi-GPU shuffles (its
partition_offsets output exists so an external driver can slice and ship
partitions). This module completes the design natively:

    per-shard hash partition (ops/hashing.py — bit-exact Murmur3, so rows
    land on the same shard a libgdf-based system would choose)
        → pad partitions into fixed-size slots
        → ONE jax.lax.all_to_all over the mesh axis (NVLink between
          the cards of a host, the network across hosts — same API)
        → receive-side compaction re-densifies rows.

Everything here runs INSIDE shard_map (shard-local view). Static shapes:
each shard sends `slot_capacity` rows to each peer; the real sizes travel
in a tiny side all_to_all and drive the receive-side compaction. Skew that
overflows `slot_capacity` is handled a level up (parallel/distributed.py:
skew detection via psum'd histograms + hot-key salting).
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.column import Column
from ..core.errors import GDFStatus, require
from ..core.table import Table
from ..ops.compaction import compaction_indices
from ..ops.hashing import partition_ids


def _axis_size(axis_name: str) -> int:
    return jax.lax.axis_size(axis_name)


def dest_sizes(table: Table, key_names: Sequence[str], axis_name: str,
               salt: jax.Array | None = None) -> jax.Array:
    """Shard-local row counts per destination shard (int32[P]) under the
    shuffle's routing (hash % P, plus optional salt). The building block
    for loss-proof slot sizing — ≅ the reference's partition histogram
    (compute_row_partition_numbers, hashing.cu:259-320)."""
    P = _axis_size(axis_name)
    part = partition_ids(table, key_names, P)
    if salt is not None:
        part = (part + salt) % P
    live = table.live_mask()
    oh = part[:, None] == jnp.arange(P, dtype=jnp.int32)[None, :]
    oh = jnp.logical_and(oh, live[:, None])
    return jnp.sum(oh, axis=0, dtype=jnp.int32)


def required_slot_capacity(table: Table, key_names: Sequence[str],
                           axis_name: str,
                           salt: jax.Array | None = None) -> jax.Array:
    """Global max rows any shard sends to any destination — the exact
    slot_capacity that makes shuffle_shard loss-proof (traced scalar;
    fetch it eagerly to size the real shuffle)."""
    return jax.lax.pmax(jnp.max(dest_sizes(table, key_names, axis_name,
                                           salt)), axis_name)


def shuffle_shard(table: Table, key_names: Sequence[str], axis_name: str,
                  slot_capacity: int, salt: jax.Array | None = None,
                  num_batches: int = 1, return_overflow: bool = False):
    """Shard-local body of a distributed shuffle (call inside shard_map).

    After this returns, every row of the global table whose key hashes to
    partition p lives on shard p (hash % num_shards, exactly the
    reference's modulo partitioner, hashing.cu:192-206). Result capacity =
    num_shards * slot_capacity, live rows in num_rows.

    `salt` (optional int32[n]) is folded into the partition id for
    skew-aware re-routing (hot-key salting, see distributed.py).

    `num_batches=B` splits the exchange into B slot-row batches, each its
    own all_to_all: XLA's async collectives then overlap batch i's wire
    time with batch i+1's gather/pack compute (SURVEY §5's pipelined
    exchange). Output is bit-identical to the monolithic exchange.

    Loss-proofness: rows beyond `slot_capacity` for a destination would be
    silently dropped — callers must size via required_slot_capacity()
    (parallel/distributed.py does this by default) or check
    dest_sizes().max() <= slot_capacity themselves. With
    return_overflow=True the return is (Table, overflow_scalar) where the
    int32 scalar counts this shard's over-capacity destinations — the
    traced loss signal ShardedTable carries to collect()."""
    P = _axis_size(axis_name)
    n = table.capacity
    require(slot_capacity * P >= 1, GDFStatus.GDF_INVALID_API_CALL)
    require(slot_capacity % num_batches == 0,
            GDFStatus.GDF_INVALID_API_CALL,
            "slot_capacity must divide into num_batches")

    part = partition_ids(table, key_names, P)
    if salt is not None:
        part = (part + salt) % P
    live = table.live_mask()
    part = jnp.where(live, part, P)  # dead rows beyond every partition

    # Stable partition sort (≅ gdf_hash_partition's scatter, but sort-based)
    iota = jnp.arange(n, dtype=jnp.int32)
    sorted_part, perm = jax.lax.sort((part, iota), num_keys=1,
                                     is_stable=True)
    offsets = jnp.searchsorted(sorted_part,
                               jnp.arange(P, dtype=jnp.int32),
                               side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sorted_part, jnp.arange(P, dtype=jnp.int32),
                            side="right").astype(jnp.int32)
    sizes = ends - offsets                       # rows per destination

    # Slot layout: send row j = p*S + r ← partitioned row offsets[p] + r.
    S = slot_capacity
    j = jnp.arange(P * S, dtype=jnp.int32)
    p = j // S
    r = j % S

    # Exchange sizes (tiny) and data (one all_to_all per column buffer per
    # batch; batch k carries slot rows [k*S/B, (k+1)*S/B) of every
    # destination).
    recv_sizes = jax.lax.all_to_all(sizes, axis_name, split_axis=0,
                                    concat_axis=0, tiled=True)

    B = num_batches
    bS = S // B
    jb = jnp.arange(P * bS, dtype=jnp.int32)
    pb, rb = jb // bS, jb % bS

    def batch_src_rows(k):
        rr = k * bS + rb
        src_pos = jnp.take(offsets, pb) + rr
        return jnp.take(perm, jnp.clip(src_pos, 0, n - 1))

    src_rows = [batch_src_rows(k) for k in range(B)]

    def exchange(arr):
        outs = []
        for k in range(B):
            buf = jnp.take(arr, src_rows[k])
            outs.append(jax.lax.all_to_all(buf, axis_name, split_axis=0,
                                           concat_axis=0, tiled=True))
        if B == 1:
            return outs[0]
        # received: outs[k][p*bS + r] = peer p's batch-k row r
        # → want [p*S + k*bS + r]: stack (B, P, bS) → (P, B, bS) → flat.
        stacked = jnp.stack([o.reshape(P, bS) for o in outs], axis=1)
        return stacked.reshape(P * S)

    cols = []
    for c in table.columns:
        data = exchange(c.data)
        valid = None if c.valid is None else exchange(c.valid)
        cols.append(Column(data=data, valid=valid, info=c.info, name=c.name))

    # Receive-side liveness: slot r from peer p is live iff r < its size.
    recv_live = r < jnp.take(recv_sizes, p)
    out = Table(columns=tuple(cols), names=table.names)
    perm2, count = compaction_indices(recv_live)
    out = out.gather(perm2, num_rows=count)
    if return_overflow:
        return out, jnp.sum(sizes > S, dtype=jnp.int32)
    return out


def all_gather_table(table: Table, axis_name: str) -> Table:
    """Replicate a (small) shard-local table on every shard.

    ≅ the reference's build-on-smaller-side policy (joining.h:57-70) lifted
    to the distributed setting: broadcast the small build side instead of
    shuffling the big probe side."""
    P = _axis_size(axis_name)
    n = table.capacity
    live = table.live_mask()
    cols = []
    for c in table.columns:
        data = jax.lax.all_gather(c.data, axis_name, tiled=True)
        valid = c.valid if c.valid is not None else live
        valid = jnp.logical_and(valid, live) if c.valid is not None else live
        valid = jax.lax.all_gather(valid, axis_name, tiled=True)
        cols.append(Column(data=data, valid=valid, info=c.info, name=c.name))
    # All rows "live"; dead originals carry valid=False and a count.
    counts = jax.lax.all_gather(
        jnp.asarray(table.row_count(), jnp.int32), axis_name)
    # Rebuild liveness: global slot j = shard*n + r live iff r < counts[shard]
    j = jnp.arange(P * n, dtype=jnp.int32)
    glive = (j % n) < jnp.take(counts, j // n)
    out = Table(columns=tuple(cols), names=table.names)
    perm, total = compaction_indices(glive)
    return out.gather(perm, num_rows=total)


def global_partition_histogram(table: Table, key_names: Sequence[str],
                               axis_name: str, num_bins: int) -> jax.Array:
    """psum'd histogram of key-hash bins across all shards — drives skew
    detection (≅ the global histogram of compute_row_partition_numbers,
    hashing.cu:259-320, made cluster-wide)."""
    pid = partition_ids(table, key_names, num_bins)
    live = table.live_mask()
    oh = (pid[:, None] == jnp.arange(num_bins, dtype=jnp.int32)[None, :])
    oh = jnp.logical_and(oh, live[:, None])
    local = jnp.sum(oh, axis=0, dtype=jnp.int32)
    return jax.lax.psum(local, axis_name)
