"""Distributed relational operators: shuffle join/groupby, broadcast join,
skew-aware repartitioning.

No counterpart exists in the reference (single-GPU; SURVEY.md §2.8) — this
is the layer `gdf_hash_partition` (libgdf/src/hashing.cu:559-654) was
designed to feed. Design:

  - **ShardedTable**: a global table as (row-sharded columns, per-shard
    live counts). The capacity+count pattern (core/table.py) extends
    naturally across the mesh: every shard owns a fixed-capacity slab plus
    a live count — shapes stay static under pjit while real sizes flow as
    data.
  - **map_shards**: run any shard-local Table→Table function under
    shard_map. The single-chip operators (ops/*) are pure functions of
    Table pytrees, so the SAME code runs single-chip and multi-chip.
  - **shuffle join / groupby**: hash-shuffle on keys (parallel/shuffle.py;
    bit-exact Murmur3 ⇒ same placement as a libgdf-based system), then the
    local operator. Groupby pre-aggregates before shuffling (combiner).
  - **broadcast join**: all_gather a small build side instead of shuffling
    the probe side (distributed analogue of build-on-smaller,
    joining.h:57-70).
  - **skew**: psum'd key histograms detect hot keys (BASELINE config 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype
from ..core.errors import GDFStatus, require
from ..core.table import Table, table_concat
from ..ops.groupby import groupby as _local_groupby
from ..ops.join import join as _local_join
from .mesh import DEFAULT_AXIS
from .shuffle import (all_gather_table, global_partition_histogram,
                      required_slot_capacity, shuffle_shard)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedTable:
    """A mesh-global table: `table` holds row-sharded columns with
    num_rows=None (the static slab); `counts` holds each shard's live row
    count (int32[num_shards], sharded one-per-device).

    `overflow` (optional int32[num_shards]) is the traced loss flag: >0 on
    any shard means an under-sized exchange or output slab dropped rows
    somewhere upstream INSIDE a jitted pipeline (where the eager capacity
    checks cannot run). It is checked — and raises — at the eager exits:
    collect() and total_rows()."""

    table: Table
    counts: jax.Array
    overflow: jax.Array | None = None

    @property
    def capacity(self) -> int:
        return self.table.capacity

    def total_rows(self):
        self._raise_if_overflowed()
        return jnp.sum(self.counts)

    def _raise_if_overflowed(self):
        """Eager contexts only (no-op under trace): raise if any shard
        recorded dropped rows."""
        if self.overflow is None:
            return
        try:
            ov = np.asarray(self.overflow)
        except Exception:  # traced — collect()/host exits own the check
            return
        if ov.sum() > 0:
            raise ValueError(
                "distributed pipeline dropped rows: an exchange slot or "
                "output capacity overflowed inside jit (shards "
                f"{np.nonzero(ov)[0].tolist()}). Re-size with "
                "exact_slot_capacity / exact_groupby_slot_capacity / a "
                "larger out_capacity_per_shard and re-run")


def distribute(table: Table, mesh: Mesh,
               axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Shard a fully-live host/global Table row-wise over the mesh (pads
    the row count up to a multiple of the mesh size)."""
    nshards = int(mesh.devices.size)
    n = table.capacity
    require(table.num_rows is None, GDFStatus.GDF_INVALID_API_CALL,
            "distribute() wants a compacted table")
    per = -(-n // nshards)
    pad = per * nshards - n
    if pad:
        cols = []
        for c in table.columns:
            data = jnp.pad(c.data, (0, pad))
            valid = None if c.valid is None else jnp.pad(c.valid, (0, pad))
            cols.append(Column(data=data, valid=valid, info=c.info,
                               name=c.name))
        table = Table(columns=tuple(cols), names=table.names)
    counts = jnp.asarray(
        [per] * (nshards - 1) + [per - pad], jnp.int32)
    from .mesh import row_sharding
    sharding = row_sharding(mesh, axis_name)
    table = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), table)
    counts = jax.device_put(counts, sharding)
    return ShardedTable(table=table, counts=counts)


def distribute_global(table: Table, mesh: Mesh,
                      axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Multi-PROCESS-safe distribute(): every process holds the same
    host-global Table; per-device shards materialize through
    jax.make_array_from_callback, so only addressable shards touch local
    memory. Works single-process too (≅ distribute()).

    This is the ingestion path for real multi-host runs
    (jax.distributed + a mesh spanning processes — SURVEY.md §4's
    multi-host prescription, which the reference never had)."""
    nshards = int(mesh.devices.size)
    n = table.capacity
    require(table.num_rows is None, GDFStatus.GDF_INVALID_API_CALL,
            "distribute_global() wants a compacted table")
    per = -(-n // nshards)
    pad = per * nshards - n
    from .mesh import row_sharding
    sharding = row_sharding(mesh, axis_name)

    def put(arr):
        arr = np.asarray(arr)
        if pad:
            arr = np.pad(arr, (0, pad))
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    cols = []
    for c in table.columns:
        cols.append(Column(
            data=put(c.data),
            valid=None if c.valid is None else put(c.valid),
            info=c.info, name=c.name))
    counts_host = np.asarray([per] * (nshards - 1) + [per - pad],
                             np.int32)
    counts = jax.make_array_from_callback(
        (nshards,), sharding, lambda idx: counts_host[idx])
    return ShardedTable(table=Table(columns=tuple(cols),
                                    names=table.names), counts=counts)


def collect(st: ShardedTable) -> Table:
    """Host-side: gather all shards into one compacted host Table.
    Raises if the pipeline's traced overflow flag recorded dropped rows."""
    st._raise_if_overflowed()
    counts = np.asarray(st.counts)
    nshards = counts.shape[0]
    per = st.capacity // nshards
    parts = []
    for i in range(nshards):
        sl = slice(i * per, i * per + int(counts[i]))
        cols = []
        for c in st.table.columns:
            data = jnp.asarray(np.asarray(c.data)[sl])
            valid = (None if c.valid is None
                     else jnp.asarray(np.asarray(c.valid)[sl]))
            cols.append(Column(data=data, valid=valid, info=c.info,
                               name=c.name))
        parts.append(Table(columns=tuple(cols), names=st.table.names))
    return table_concat(parts)


from collections import OrderedDict

_MAP_SHARDS_CACHE: OrderedDict = OrderedDict()
_MAP_SHARDS_CACHE_MAX = 64   # LRU bound: callers that pass fresh
#                              closures per call (dist_join's body etc.)
#                              must not pin compiled programs forever


def map_shards(mesh: Mesh, fn: Callable[..., Table], *sts: ShardedTable,
               axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Run a shard-local Table→Table function over the mesh. `fn` receives
    each shard's local Table (with its live num_rows) and returns a local
    Table (capacity must be uniform across shards — it is, by SPMD).

    `fn` may instead return (Table, overflow_scalar): the int/bool scalar
    is accumulated into the output's traced `overflow` flag (shuffles
    report dropped rows this way). Input tables' flags propagate either
    way.

    The jitted shard_map body is cached on (fn, mesh, axis_name, arity) —
    repeat eager calls with the same fn hit jax.jit's compile cache
    instead of retracing a fresh closure each time (round-5 advisor
    finding: the per-call @jax.jit wrapper keyed the cache on a new
    function object every invocation). Pass the SAME function object (not
    a fresh lambda per call) to benefit."""
    key = (fn, mesh, axis_name, len(sts))
    body = _MAP_SHARDS_CACHE.get(key)
    if body is not None:
        _MAP_SHARDS_CACHE.move_to_end(key)
    else:
        @jax.jit
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(axis_name),) * len(sts),
                 out_specs=P(axis_name))
        def body(*locals_):
            tables = [st.table.with_num_rows(st.counts[0])
                      for st in locals_]
            out = fn(*tables)
            ov = jnp.int32(0)
            if isinstance(out, tuple):
                out, fn_ov = out
                ov = ov + jnp.asarray(fn_ov, jnp.int32)
            for st in locals_:
                if st.overflow is not None:
                    ov = ov + st.overflow[0]
            cnt = out.row_count()
            cnt = jnp.reshape(jnp.asarray(cnt, jnp.int32), (1,))
            return ShardedTable(table=out.with_num_rows(None), counts=cnt,
                                overflow=jnp.reshape(ov, (1,)))

        _MAP_SHARDS_CACHE[key] = body
        while len(_MAP_SHARDS_CACHE) > _MAP_SHARDS_CACHE_MAX:
            _MAP_SHARDS_CACHE.popitem(last=False)
    return body(*sts)


# ---------------------------------------------------------------------------
# Distributed groupby
# ---------------------------------------------------------------------------

class _AggPlan:
    """Decompose user aggs into a shuffle-safe two-phase (combiner) plan:
    partial aggregation before the shuffle, exact merge after. AVG travels
    as sum+count and is finalized by a divide (the distributed
    generalization of multi_pass_avg, groupby.cuh:308-419)."""

    def __init__(self, aggs):
        self.user = [(a[0], a[1], a[2] if len(a) > 2 else f"{a[1]}_{a[0]}")
                     for a in aggs]
        self.partial = []
        self.merge = []
        self.post_avg = []
        seen = set()

        def add(col, op, name):
            if name not in seen:
                self.partial.append((col, op, name))
                seen.add(name)

        for col, op, out in self.user:
            if op == "avg":
                s, c = f"__s_{col}", f"__c_{col}"
                add(col, "sum", s)
                add(col, "count", c)
                self.merge += [(s, "sum", s), (c, "sum", c)]
                self.post_avg.append((out, s, c))
            elif op in ("count", "count_distinct"):
                tmp = f"__n_{col}"
                add(col, "count", tmp)
                self.merge.append((tmp, "sum", out))
            else:
                tmp = f"__{op}_{col}"
                add(col, op, tmp)
                self.merge.append((tmp, op, out))

    def finalize(self, t: Table) -> Table:
        for out, s, c in self.post_avg:
            scol, ccol = t[s], t[c]
            avg = scol.data.astype(jnp.float64) / jnp.maximum(ccol.data, 1)
            valid = ccol.data > 0
            if scol.valid is not None:
                valid = jnp.logical_and(valid, scol.valid)
            t = t.with_column(Column(data=avg, valid=valid,
                                     info=DtypeInfo(GDFDtype.FLOAT64),
                                     name=out))
        return t.select([n for n in t.names if not n.startswith("__")])


def exact_slot_capacity(mesh: Mesh, sides, axis_name: str = DEFAULT_AXIS,
                        num_batches: int = 1) -> int:
    """Loss-proof slot sizing: the global max rows any shard sends to any
    destination, over every (ShardedTable, key_names[, salt_fn]) in
    `sides`, as a concrete int (rounded up to a num_batches multiple).

    ≅ the reference's exact-histogram-then-scatter discipline
    (hashing.cu:401-536): libgdf never drops rows on partition overflow,
    and neither do we — the price is this cheap counting pre-pass."""
    sides = [s if len(s) == 3 else (s[0], s[1], None) for s in sides]
    sts = [s[0] for s in sides]

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name),) * len(sts), out_specs=P())
    def run(*locals_):
        caps = []
        for stl, (_, keys, salt_fn) in zip(locals_, sides):
            t = stl.table.with_num_rows(stl.counts[0])
            salt = None if salt_fn is None else salt_fn(t)
            caps.append(required_slot_capacity(t, keys, axis_name, salt))
        out = caps[0]
        for c in caps[1:]:
            out = jnp.maximum(out, c)
        return out

    try:
        cap = max(int(run(*sts)), 1)
    except jax.errors.ConcretizationTypeError:
        raise ValueError(
            "exact slot sizing needs concrete counts — under jit pass an "
            "explicit slot_capacity (sized from a prior eager "
            "exact_slot_capacity call)") from None
    return -(-cap // num_batches) * num_batches


def _check_slot_capacity(mesh, sides, slot_capacity, axis_name):
    """Loud failure on a user-provided slot_capacity that would drop rows
    (the silent-overflow hazard). Skipped when called
    under a trace (the counting pre-pass needs concrete values); jitted
    pipelines own the check via an eager exact_slot_capacity() upfront."""
    try:
        need = exact_slot_capacity(mesh, sides, axis_name)
    except ValueError:
        return
    require(need <= slot_capacity, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
            f"shuffle would drop rows: a shard sends {need} rows to one "
            f"destination but slot_capacity={slot_capacity}; raise it or "
            f"use the salted path (dist_join_salted)")


def exact_groupby_slot_capacity(mesh: Mesh, st: ShardedTable,
                                key_names: Sequence[str], aggs,
                                axis_name: str = DEFAULT_AXIS,
                                num_batches: int = 1) -> int:
    """Exact slot sizing for dist_groupby's pre-aggregated exchange,
    computed eagerly from the ACTUAL input ShardedTable (e.g. a join
    output — whose per-shard distinct-key count can exceed any bound
    derived from upstream tables). The combiner runs in the pre-pass so
    the count matches exactly what the shuffle will send."""
    plan = _AggPlan(aggs)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name),),
             out_specs=P())
    def sized(stl):
        t = stl.table.with_num_rows(stl.counts[0])
        return required_slot_capacity(
            _local_groupby(t, key_names, plan.partial), key_names,
            axis_name)

    try:
        need = max(int(sized(st)), 1)
    except jax.errors.ConcretizationTypeError:
        raise ValueError(
            "exact groupby slot sizing needs concrete counts — call it "
            "eagerly (outside jit) on the real input table") from None
    return -(-need // num_batches) * num_batches


def dist_groupby(mesh: Mesh, st: ShardedTable, key_names: Sequence[str],
                 aggs, slot_capacity: int | None = None,
                 axis_name: str = DEFAULT_AXIS,
                 pre_aggregate: bool = True,
                 num_batches: int = 1) -> ShardedTable:
    """Distributed groupby; result stays sharded (each shard owns a
    disjoint set of groups — the shuffle co-locates equal keys).

    Skew note: with pre_aggregate=True (default) the combiner collapses
    every shard's rows to one row per distinct key BEFORE the shuffle, so
    hot keys cannot overflow a destination — the slot pre-pass then sizes
    by post-combine counts. This is the groupby analogue of salting.

    slot_capacity=None (default) sizes the exchange exactly (loss-proof);
    an explicit value is validated eagerly and raises if it would drop
    rows."""
    plan = _AggPlan(aggs)

    def pre(t: Table) -> Table:
        return _local_groupby(t, key_names, plan.partial)

    sides = [(st, key_names, None)]
    if pre_aggregate:
        # size by post-combine counts: run the combiner in the pre-pass
        @jax.jit
        @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name),),
                 out_specs=P())
        def sized(stl):
            t = stl.table.with_num_rows(stl.counts[0])
            return required_slot_capacity(pre(t), key_names, axis_name)

        try:
            need = max(int(sized(st)), 1)
        except jax.errors.ConcretizationTypeError:
            need = None  # traced: caller owns the check
        if need is not None:
            need = -(-need // num_batches) * num_batches
        if slot_capacity is None:
            if need is None:
                raise ValueError(
                    "dist_groupby under jit needs an explicit "
                    "slot_capacity") from None
            slot_capacity = need
        elif need is not None:
            require(need <= slot_capacity,
                    GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                    f"shuffle would drop rows ({need} > {slot_capacity})")
    else:
        if slot_capacity is None:
            slot_capacity = exact_slot_capacity(mesh, sides, axis_name,
                                                num_batches)
        else:
            _check_slot_capacity(mesh, sides, slot_capacity, axis_name)

    def body(t: Table):
        if pre_aggregate:
            t = pre(t)
        t, ov = shuffle_shard(t, key_names, axis_name, slot_capacity,
                              num_batches=num_batches,
                              return_overflow=True)
        if pre_aggregate:
            out = _local_groupby(t, key_names, plan.merge)
        else:
            out = _local_groupby(t, key_names, plan.partial)
            out = _rename_to_merge(out, plan)
        return plan.finalize(out), ov

    return map_shards(mesh, body, st, axis_name=axis_name)


def _rename_to_merge(t: Table, plan: _AggPlan) -> Table:
    mapping = {src: dst for (src, _, dst) in plan.merge}
    cols = tuple(c.with_name(mapping.get(n, n))
                 for n, c in zip(t.names, t.columns))
    return Table(columns=cols, num_rows=t.num_rows,
                 names=tuple(mapping.get(n, n) for n in t.names))


# ---------------------------------------------------------------------------
# Distributed joins
# ---------------------------------------------------------------------------

def dist_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
              left_on, right_on, how: str = "inner",
              out_capacity_per_shard: int | None = None,
              slot_capacity: int | None = None,
              axis_name: str = DEFAULT_AXIS,
              num_batches: int = 1) -> ShardedTable:
    """Distributed shuffle join: both sides shuffled on their keys with the
    SAME hash/partitioner, then joined shard-locally. FULL joins are safe:
    any key's rows live on exactly one shard.

    slot_capacity=None (default) sizes the exchange exactly from a
    counting pre-pass (loss-proof); an explicit value is validated and
    raises if it would drop rows. Heavily skewed keys make the exact
    capacity balloon (every hot-key row goes to one shard) — use
    dist_join_salted for those."""
    nshards = int(mesh.devices.size)
    lps = left.capacity // nshards
    rps = right.capacity // nshards
    sides = [(left, left_on, None), (right, right_on, None)]
    if slot_capacity is None:
        slot_capacity = exact_slot_capacity(mesh, sides, axis_name,
                                            num_batches)
    else:
        _check_slot_capacity(mesh, sides, slot_capacity, axis_name)
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + rps)

    def body(lt: Table, rt: Table):
        lt, ov_l = shuffle_shard(lt, left_on, axis_name, slot_capacity,
                                 num_batches=num_batches,
                                 return_overflow=True)
        rt, ov_r = shuffle_shard(rt, right_on, axis_name, slot_capacity,
                                 num_batches=num_batches,
                                 return_overflow=True)
        return _local_join(lt, rt, left_on, right_on, how=how,
                           out_capacity=out_capacity_per_shard), ov_l + ov_r

    out = map_shards(mesh, body, left, right, axis_name=axis_name)
    out = _flag_count_overflow(out, out_capacity_per_shard)
    _check_join_counts(out, out_capacity_per_shard)
    return out


def _flag_count_overflow(out: ShardedTable, cap: int) -> ShardedTable:
    """Fold `count > capacity` (exact, per shard) into the traced overflow
    flag so a fully-jitted pipeline still fails loudly at collect()."""
    over = (out.counts > cap).astype(jnp.int32)
    ov = over if out.overflow is None else out.overflow + over
    return ShardedTable(table=out.table, counts=out.counts, overflow=ov)


def _check_join_counts(out: ShardedTable, cap: int):
    """Eager output-capacity check: join counts are always exact (the
    count pass never truncates), so count > capacity is detectable. Raise
    rather than let collect() slice garbage."""
    try:
        counts = np.asarray(out.counts)
    except Exception:  # traced (inside jit) — caller owns the check
        return
    if counts.max(initial=0) > cap:
        raise ValueError(
            f"dist_join output overflow: a shard produced "
            f"{int(counts.max())} rows > out_capacity_per_shard={cap}; "
            f"re-run with a larger capacity")


class SaltedJoinPlan:
    """Planning product of the skew-aware join: the hot-bin mask plus
    loss-proof capacities, all CONCRETE. Built eagerly once
    (plan_salted_join); execution against a plan is pure and jittable —
    the shard-map body is constructed once per plan, so repeat calls
    (and fully-jitted pipelines) reuse one compiled program instead of
    retracing (round-4 weak #5: the salted path was eager-only)."""

    def __init__(self, mesh, left_on, right_on, how, hot, slot_capacity,
                 hot_capacity_per_shard, out_capacity_per_shard,
                 num_bins, axis_name):
        self.mesh = mesh
        self.left_on = tuple(left_on)
        self.right_on = tuple(right_on)
        self.how = how
        self.hot = jnp.asarray(hot)
        self.slot_capacity = int(slot_capacity)
        self.hot_capacity_per_shard = int(hot_capacity_per_shard)
        self.out_capacity_per_shard = int(out_capacity_per_shard)
        self.num_bins = int(num_bins)
        self.axis_name = axis_name
        self._body = None

    def left_salt(self, t: Table) -> jax.Array:
        bins = _bins_of(t, self.left_on, self.num_bins)
        is_hot = jnp.take(self.hot, bins)
        nshards = int(self.mesh.devices.size)
        spread = jnp.arange(t.capacity, dtype=jnp.int32) % nshards
        return jnp.where(is_hot, spread, 0)

    def body(self):
        if self._body is not None:
            return self._body
        from ..ops.compaction import compact_table
        plan = self

        def _body(lt: Table, rt: Table):
            # LEFT: salted shuffle (hot rows spread, cold co-located)
            lt, ov_l = shuffle_shard(lt, plan.left_on, plan.axis_name,
                                     plan.slot_capacity,
                                     salt=plan.left_salt(lt),
                                     return_overflow=True)
            # RIGHT: split hot/cold
            bins = _bins_of(rt, plan.right_on, plan.num_bins)
            is_hot = jnp.logical_and(jnp.take(plan.hot, bins),
                                     rt.live_mask())
            cold_t, n_cold = compact_table(rt, jnp.logical_and(
                jnp.logical_not(is_hot), rt.live_mask()))
            cold_t = cold_t.with_num_rows(n_cold)
            hot_t, n_hot = compact_table(rt, is_hot)
            hot_t = _slice_rows(hot_t, plan.hot_capacity_per_shard)
            hot_t = hot_t.with_num_rows(jnp.minimum(
                n_hot, plan.hot_capacity_per_shard))
            cold_sh, ov_r = shuffle_shard(cold_t, plan.right_on,
                                          plan.axis_name,
                                          plan.slot_capacity,
                                          return_overflow=True)
            hot_rep = all_gather_table(hot_t, plan.axis_name)
            rt_local = _concat_live(cold_sh, hot_rep)
            return (_local_join(lt, rt_local, plan.left_on, plan.right_on,
                                how=plan.how,
                                out_capacity=plan.out_capacity_per_shard),
                    ov_l + ov_r)

        self._body = _body
        return _body


def plan_salted_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                     left_on, right_on, how: str = "inner",
                     out_capacity_per_shard: int | None = None,
                     slot_capacity: int | None = None,
                     hot_capacity_per_shard: int | None = None,
                     num_bins: int = 1024, threshold: float = 4.0,
                     axis_name: str = DEFAULT_AXIS) -> SaltedJoinPlan:
    """Eagerly plan a skew-aware join: detect hot bins (psum'd key-hash
    histograms of BOTH sides) and compute loss-proof capacities. The
    returned plan makes dist_join_salted jittable and retrace-free."""
    require(how in ("inner", "left"), GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE,
            "salted join supports inner/left only")
    nshards = int(mesh.devices.size)
    lps = left.capacity // nshards
    rps = right.capacity // nshards

    try:
        hist, hot = detect_skew(mesh, right, right_on, axis_name=axis_name,
                                num_bins=num_bins, threshold=threshold)
        # also salt by LEFT-side heat: a key hot on the probe side floods
        # one shard even when the build side is uniform.
        hist_l, hot_l = detect_skew(mesh, left, left_on,
                                    axis_name=axis_name,
                                    num_bins=num_bins, threshold=threshold)
        hot = np.logical_or(hot, hot_l)
    except jax.errors.ConcretizationTypeError:
        raise ValueError(
            "plan_salted_join plans eagerly (skew detection + exact slot "
            "sizing need concrete counts) — call it outside jit, then "
            "pass the plan to dist_join_salted inside jit") from None
    # Construct the plan FIRST (capacities filled below) so the sizing
    # pre-pass salts with the exact same plan.left_salt the execution
    # body will use — a second copy of the salt logic could drift and
    # silently re-open the dropped-rows hazard the sizing prevents.
    plan = SaltedJoinPlan(mesh, left_on, right_on, how, hot, 1, 1, 1,
                          num_bins, axis_name)
    hotj = plan.hot

    # Exact loss-proof sizing pre-pass: max slot need over
    #   - the salted LEFT shuffle,
    #   - the RIGHT cold-only shuffle (hot rows go via all_gather),
    # plus the global max per-shard hot-row count (the replication bound).
    from .shuffle import dest_sizes

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name), P(axis_name)), out_specs=(P(), P()))
    def sizing(lst, rst):
        lt = lst.table.with_num_rows(lst.counts[0])
        rt = rst.table.with_num_rows(rst.counts[0])
        l_need = jnp.max(dest_sizes(lt, left_on, axis_name,
                                    salt=plan.left_salt(lt)))
        bins = _bins_of(rt, right_on, num_bins)
        is_hot = jnp.logical_and(jnp.take(hotj, bins), rt.live_mask())
        # cold destination sizes: histogram over live & !hot rows
        from ..ops.hashing import partition_ids
        part = partition_ids(rt, right_on, nshards)
        oh = part[:, None] == jnp.arange(nshards, dtype=jnp.int32)[None, :]
        cold_live = jnp.logical_and(rt.live_mask(),
                                    jnp.logical_not(is_hot))
        oh = jnp.logical_and(oh, cold_live[:, None])
        r_need = jnp.max(jnp.sum(oh, axis=0, dtype=jnp.int32))
        need = jax.lax.pmax(jnp.maximum(l_need, r_need), axis_name)
        hot_cnt = jax.lax.pmax(
            jnp.sum(is_hot, dtype=jnp.int32), axis_name)
        return need, hot_cnt

    need, hot_max = (int(x) for x in sizing(left, right))
    if slot_capacity is None:
        slot_capacity = max(need, 1)
    else:
        require(need <= slot_capacity, GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                f"salted shuffle would drop rows ({need} > "
                f"{slot_capacity})")
    if hot_capacity_per_shard is None:
        hot_capacity_per_shard = max(hot_max, 1)
    else:
        require(hot_max <= hot_capacity_per_shard,
                GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                f"hot-row replication would drop rows ({hot_max} > "
                f"{hot_capacity_per_shard})")
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + rps) + nshards * \
            hot_capacity_per_shard
    plan.slot_capacity = int(slot_capacity)
    plan.hot_capacity_per_shard = int(hot_capacity_per_shard)
    plan.out_capacity_per_shard = int(out_capacity_per_shard)
    return plan


def dist_join_salted(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                     left_on, right_on, how: str | None = None,
                     out_capacity_per_shard: int | None = None,
                     slot_capacity: int | None = None,
                     hot_capacity_per_shard: int | None = None,
                     num_bins: int = 1024, threshold: float = 4.0,
                     axis_name: str = DEFAULT_AXIS,
                     plan: SaltedJoinPlan | None = None) -> ShardedTable:
    """Skew-aware shuffle join (BASELINE config 5's Zipf pipeline).

    Hot keys (detected from the psum'd key-hash histogram, ≅ the driver
    reaction the reference designed its partition histogram for,
    hashing.cu:488-503) are handled by SALTING: hot LEFT rows spread
    round-robin over all shards; hot RIGHT rows are replicated to every
    shard (all_gather of the filtered hot subset). Cold keys take the
    normal co-located shuffle. inner/left only — a FULL join would emit
    unmatched replicated build rows once per shard.

    Without `plan`, planning runs eagerly here (needs concrete counts).
    With a `plan` from plan_salted_join, execution is PURE and can run
    inside a fully-jitted pipeline; repeat calls reuse one compiled
    shard-map body."""
    if plan is None:
        plan = plan_salted_join(
            mesh, left, right, left_on, right_on,
            how="inner" if how is None else how,
            out_capacity_per_shard=out_capacity_per_shard,
            slot_capacity=slot_capacity,
            hot_capacity_per_shard=hot_capacity_per_shard,
            num_bins=num_bins, threshold=threshold, axis_name=axis_name)
    else:
        # the plan OWNS keys/how/capacities — a mismatched explicit
        # argument would otherwise be silently ignored; how=None means
        # "the plan's" (so a left-join plan needs no re-passing)
        require(tuple(left_on) == plan.left_on
                and tuple(right_on) == plan.right_on
                and how in (None, plan.how)
                and axis_name == plan.axis_name,
                GDFStatus.GDF_INVALID_API_CALL,
                "dist_join_salted: keys/how/axis disagree with the plan")
        require(slot_capacity in (None, plan.slot_capacity)
                and hot_capacity_per_shard in (
                    None, plan.hot_capacity_per_shard)
                and out_capacity_per_shard in (
                    None, plan.out_capacity_per_shard),
                GDFStatus.GDF_INVALID_API_CALL,
                "dist_join_salted: explicit capacities disagree with "
                "the plan's (re-plan instead)")
    out = map_shards(mesh, plan.body(), left, right,
                     axis_name=plan.axis_name)
    out = _flag_count_overflow(out, plan.out_capacity_per_shard)
    _check_join_counts(out, plan.out_capacity_per_shard)
    return out


def _bins_of(t: Table, key_names, num_bins: int):
    from ..ops.hashing import partition_ids
    return partition_ids(t, key_names, num_bins)


def _concat_live(a: Table, b: Table) -> Table:
    """Concatenate two capacity+count tables (inside jit): stack the slabs
    and re-compact so live rows are contiguous."""
    from ..ops.compaction import compact_table
    cols = []
    for ca, cb in zip(a.columns, b.columns):
        va = ca.valid if ca.valid is not None else (
            None if cb.valid is None else jnp.ones((a.capacity,),
                                                   jnp.bool_))
        vb = cb.valid if cb.valid is not None else (
            None if va is None else jnp.ones((b.capacity,), jnp.bool_))
        cols.append(Column(
            data=jnp.concatenate([ca.data, cb.data]),
            valid=None if va is None else jnp.concatenate([va, vb]),
            info=ca.info, name=ca.name))
    keep = jnp.concatenate([a.live_mask(), b.live_mask()])
    t = Table(columns=tuple(cols), names=a.names)
    out, count = compact_table(t, keep)
    return out.with_num_rows(count)


def _slice_rows(t: Table, cap: int) -> Table:
    cols = tuple(Column(data=c.data[:cap],
                        valid=None if c.valid is None else c.valid[:cap],
                        info=c.info, name=c.name) for c in t.columns)
    return Table(columns=cols, names=t.names)


def broadcast_join(mesh: Mesh, left: ShardedTable, right: ShardedTable,
                   left_on, right_on, how: str = "inner",
                   out_capacity_per_shard: int | None = None,
                   axis_name: str = DEFAULT_AXIS) -> ShardedTable:
    """Replicated-build join: all_gather the (small) right side; the big
    probe side never moves. inner/left only (FULL would double-count
    unmatched build rows across shards)."""
    require(how in ("inner", "left"), GDFStatus.GDF_UNSUPPORTED_JOIN_TYPE,
            "broadcast join supports inner/left only")
    nshards = int(mesh.devices.size)
    lps = left.capacity // nshards
    if out_capacity_per_shard is None:
        out_capacity_per_shard = 2 * (lps + right.capacity)

    def body(lt: Table, rt: Table) -> Table:
        rt_full = all_gather_table(rt, axis_name)
        return _local_join(lt, rt_full, left_on, right_on, how=how,
                             out_capacity=out_capacity_per_shard)

    out = map_shards(mesh, body, left, right, axis_name=axis_name)
    out = _flag_count_overflow(out, out_capacity_per_shard)
    _check_join_counts(out, out_capacity_per_shard)
    return out


# ---------------------------------------------------------------------------
# Skew detection (BASELINE config 5)
# ---------------------------------------------------------------------------

def detect_skew(mesh: Mesh, st: ShardedTable, key_names,
                axis_name: str = DEFAULT_AXIS,
                num_bins: int | None = None, threshold: float = 4.0):
    """Global key-hash histogram (psum across shards); bins over
    threshold×mean are hot. A planning-time readout, mirroring how the
    reference exposes partition sizes to its host driver
    (hashing.cu:499-503)."""
    nbins = num_bins or int(mesh.devices.size)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=P(axis_name),
             out_specs=P())
    def run(stl: ShardedTable):
        t = stl.table.with_num_rows(stl.counts[0])
        return global_partition_histogram(t, key_names, axis_name, nbins)

    hist = np.asarray(run(st))
    mean = max(float(hist.mean()), 1.0)
    return hist, hist > threshold * mean
