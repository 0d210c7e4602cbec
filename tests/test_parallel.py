"""Distributed-layer tests on the virtual 8-device CPU mesh.

The reference has no distributed tests (nothing distributed to test,
SURVEY.md §4); these validate the new shuffle/join/groupby layer against
pandas oracles — the multi-host strategy SURVEY.md §4 prescribes."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from libgdf_tpu import Table, ops
from libgdf_tpu import parallel as par


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh()


def _df(t: Table) -> pd.DataFrame:
    return t.to_pandas()


def test_distribute_collect_roundtrip(mesh, rng):
    n = 1000  # not divisible by 8 → exercises padding
    a = rng.integers(0, 100, n).astype(np.int32)
    b = rng.standard_normal(n)
    na = rng.random(n) < 0.2
    t = Table.from_dict({"a": a, "b": b}, nulls={"a": na})
    st = par.distribute(t, mesh)
    assert int(st.total_rows()) == n
    back = par.collect(st)
    av, anull = back["a"].to_numpy_masked()
    np.testing.assert_array_equal(av[~anull], a[~na])
    np.testing.assert_array_equal(anull, na)
    np.testing.assert_array_equal(np.asarray(back["b"].data), b)


def test_map_shards_filter(mesh, rng):
    n = 1024
    a = rng.integers(0, 100, n).astype(np.int32)
    t = Table.from_dict({"a": a})
    st = par.distribute(t, mesh)

    def body(local):
        stencil = ops.compare_scalar(local["a"], 50, "lt")
        return ops.filter_table(local, stencil)

    out = par.collect(par.map_shards(mesh, body, st))
    got = np.sort(np.asarray(out["a"].data))
    np.testing.assert_array_equal(got, np.sort(a[a < 50]))


def test_shuffle_colocates_keys(mesh, rng):
    """After the shuffle, each key lives on exactly the shard its Murmur3
    hash selects (reference modulo partitioner, hashing.cu:192-206), and
    no rows are lost."""
    n, nshards = 2048, 8
    k = rng.integers(0, 500, n).astype(np.int64)
    v = rng.standard_normal(n)
    t = Table.from_dict({"k": k, "v": v})
    st = par.distribute(t, mesh)

    def body(local):
        return par.shuffle_shard(local, ["k"], par.DEFAULT_AXIS,
                                 slot_capacity=n // nshards)

    out = par.map_shards(mesh, body, st)
    counts = np.asarray(out.counts)
    assert counts.sum() == n
    # verify placement shard-by-shard
    expect_part = np.asarray(
        ops.partition_ids(t, ["k"], nshards))
    per = out.capacity // nshards
    data_k = np.asarray(out.table["k"].data)
    for s in range(nshards):
        shard_keys = data_k[s * per: s * per + counts[s]]
        for key in shard_keys:
            idx = np.where(k == key)[0][0]
            assert expect_part[idx] == s
    # integrity: multiset of (k, v) preserved
    got = sorted(zip(np.asarray(par.collect(out)["k"].data).tolist(),
                     np.asarray(par.collect(out)["v"].data).tolist()))
    expect = sorted(zip(k.tolist(), v.tolist()))
    assert got == expect


def test_dist_groupby_matches_pandas(mesh, rng):
    n = 4096
    k = rng.integers(0, 300, n).astype(np.int64)
    v = rng.standard_normal(n)
    nv = rng.random(n) < 0.15
    t = Table.from_dict({"k": k, "v": v}, nulls={"v": nv})
    st = par.distribute(t, mesh)
    out = par.dist_groupby(mesh, st, ["k"],
                           [("v", "sum", "s"), ("v", "count", "n"),
                            ("v", "avg", "m"), ("v", "min", "lo"),
                            ("v", "max", "hi")])
    got = _df(par.collect(out)).sort_values("k").reset_index(drop=True)
    pdf = pd.DataFrame({"k": k, "v": np.where(nv, np.nan, v)})
    exp = pdf.groupby("k")["v"].agg(
        ["sum", "count", "mean", "min", "max"]).reset_index()
    exp = exp.sort_values("k").reset_index(drop=True)
    assert len(got) == len(exp)
    np.testing.assert_array_equal(got["k"].values, exp["k"].values)
    np.testing.assert_allclose(got["s"].values, exp["sum"].values,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got["n"].values, exp["count"].values)
    np.testing.assert_allclose(
        got["m"].values.astype(np.float64)[exp["count"].values > 0],
        exp["mean"].values[exp["count"].values > 0], rtol=1e-9)
    np.testing.assert_allclose(got["lo"].astype(np.float64),
                               exp["min"].values, rtol=1e-9)
    np.testing.assert_allclose(got["hi"].astype(np.float64),
                               exp["max"].values, rtol=1e-9)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_dist_join_matches_pandas(mesh, rng, how):
    nl, nr = 2048, 512
    lk = rng.integers(0, 400, nl).astype(np.int32)
    lv = rng.standard_normal(nl)
    rk = rng.integers(200, 600, nr).astype(np.int32)
    rv = rng.standard_normal(nr)
    lt = Table.from_dict({"k": lk, "lv": lv})
    rt = Table.from_dict({"k": rk, "rv": rv})
    sl = par.distribute(lt, mesh)
    sr = par.distribute(rt, mesh)
    out = par.dist_join(mesh, sl, sr, ["k"], ["k"], how=how)
    got = _df(par.collect(out))
    exp = pd.DataFrame({"k": lk, "lv": lv}).merge(
        pd.DataFrame({"k": rk, "rv": rv}), on="k",
        how={"inner": "inner", "left": "left", "full": "outer"}[how])
    assert len(got) == len(exp), (len(got), len(exp))
    gs = got.sort_values(["k", "lv", "rv"], na_position="last").reset_index(
        drop=True)
    es = exp.sort_values(["k", "lv", "rv"], na_position="last").reset_index(
        drop=True)
    np.testing.assert_array_equal(gs["k"].values.astype(np.float64),
                                  es["k"].values.astype(np.float64))
    for c in ("lv", "rv"):
        np.testing.assert_allclose(gs[c].values.astype(np.float64),
                                   es[c].values.astype(np.float64),
                                   rtol=1e-9, equal_nan=True)


def test_broadcast_join_matches_shuffle_join(mesh, rng):
    nl, nr = 2048, 128
    lk = rng.integers(0, 100, nl).astype(np.int32)
    lv = rng.standard_normal(nl)
    rk = np.arange(128, dtype=np.int32)
    rv = rng.standard_normal(nr)
    sl = par.distribute(Table.from_dict({"k": lk, "lv": lv}), mesh)
    sr = par.distribute(Table.from_dict({"k": rk, "rv": rv}), mesh)
    a = _df(par.collect(par.broadcast_join(mesh, sl, sr, ["k"], ["k"])))
    b = _df(par.collect(par.dist_join(mesh, sl, sr, ["k"], ["k"])))
    a = a.sort_values(["k", "lv"]).reset_index(drop=True)
    b = b.sort_values(["k", "lv"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b)


def test_detect_skew_flags_hot_key(mesh, rng):
    n = 4096
    k = np.concatenate([np.full(n // 2, 7, dtype=np.int64),
                        rng.integers(100, 1000, n // 2)]).astype(np.int64)
    t = Table.from_dict({"k": k})
    st = par.distribute(t, mesh)
    hist, hot = par.detect_skew(mesh, st, ["k"], num_bins=8)
    assert hist.sum() == n
    hot_bin = int(np.asarray(ops.partition_ids(t, ["k"], 8))[0])
    assert hot[hot_bin]


def test_global_partition_histogram(mesh, rng):
    n = 1024
    k = rng.integers(0, 50, n).astype(np.int32)
    t = Table.from_dict({"k": k})
    st = par.distribute(t, mesh)
    from functools import partial
    from jax.sharding import PartitionSpec as P

    @partial(jax.shard_map, mesh=mesh, in_specs=P(par.DEFAULT_AXIS),
             out_specs=P())
    def run(stl):
        local = stl.table.with_num_rows(stl.counts[0])
        return par.global_partition_histogram(
            local, ["k"], par.DEFAULT_AXIS, 8)

    hist = np.asarray(run(st))
    expect = np.bincount(np.asarray(ops.partition_ids(t, ["k"], 8)),
                         minlength=8)
    np.testing.assert_array_equal(hist, expect)


def test_batched_shuffle_equals_monolithic(mesh, rng):
    """num_batches splits the exchange (pipelined all_to_all) but must be
    bit-identical to the single exchange."""
    n, nshards = 2048, 8
    k = rng.integers(0, 500, n).astype(np.int64)
    v = rng.standard_normal(n)
    nv = rng.random(n) < 0.2
    t = Table.from_dict({"k": k, "v": v}, nulls={"v": nv})
    st = par.distribute(t, mesh)
    S = 512

    def run(num_batches):
        def body(local):
            return par.shuffle_shard(local, ["k"], par.DEFAULT_AXIS,
                                     slot_capacity=S,
                                     num_batches=num_batches)
        out = par.map_shards(mesh, body, st)
        c = par.collect(out)
        vv, vn = c["v"].to_numpy_masked()
        return (np.asarray(c["k"].data), vv, vn)

    a, b = run(1), run(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_exact_slot_capacity_and_overflow_raises(mesh, rng):
    """Loss-proofness: default sizing is exact; an explicit too-small
    slot_capacity raises instead of silently dropping rows."""
    n = 2048
    # all rows share one key -> every row goes to ONE shard
    k = np.full(n, 7, dtype=np.int64)
    v = rng.standard_normal(n)
    t = Table.from_dict({"k": k, "v": v})
    st = par.distribute(t, mesh)
    need = par.exact_slot_capacity(mesh, [(st, ["k"])])
    assert need == n // 8  # each shard sends its whole slab to one peer
    # default (None) sizing survives the hot key
    out = par.dist_join(mesh, st, st, ["k"], ["k"],
                        out_capacity_per_shard=n * n)
    assert int(out.total_rows()) == n * n
    from libgdf_tpu.core.errors import GDFError
    with pytest.raises(GDFError):
        par.dist_join(mesh, st, st, ["k"], ["k"], slot_capacity=8,
                      out_capacity_per_shard=n * n)


def test_dist_join_output_overflow_raises(mesh, rng):
    n = 512
    k = np.zeros(n, dtype=np.int64)  # n x n join output
    t = Table.from_dict({"k": k})
    st = par.distribute(t, mesh)
    with pytest.raises(ValueError, match="output overflow"):
        par.dist_join(mesh, st, st, ["k"], ["k"],
                      out_capacity_per_shard=16)


def test_jitted_pipeline_overflow_raises_at_collect(mesh, rng):
    """The traced overflow flag (round 4): a FULLY-JITTED pipeline whose
    exchange slot is under-sized cannot run its eager checks — the flag
    must carry the loss signal to collect()/total_rows() and raise
    instead of returning truncated data."""
    import jax

    n = 2048
    k = np.full(n, 7, dtype=np.int64)  # hot key: all rows to one shard
    v = rng.standard_normal(n)
    t = Table.from_dict({"k": k, "v": v})
    st = par.distribute(t, mesh)

    @jax.jit
    def pipeline(st):
        # slot_capacity=8 drops rows; under trace the eager validation
        # is skipped, so only the flag can catch it
        return par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s")],
                                slot_capacity=8, pre_aggregate=False)

    out = pipeline(st)
    with pytest.raises(ValueError, match="dropped rows"):
        par.collect(out)
    with pytest.raises(ValueError, match="dropped rows"):
        int(out.total_rows())

    # correctly-sized jitted pipeline passes the same checks
    @jax.jit
    def pipeline_ok(st):
        return par.dist_groupby(mesh, st, ["k"], [("v", "sum", "s")],
                                slot_capacity=n, pre_aggregate=False)

    good = par.collect(pipeline_ok(st))
    assert good.capacity == 1  # one group


def test_salted_join_zipf_matches_pandas(mesh, rng):
    """BASELINE config 5 shape: a Zipf-hot key whose rows exceed any
    uniform slot heuristic; the salted path spreads the hot probe rows and
    replicates the hot build rows — pandas-exact results."""
    nl, nr = 4096, 512
    # ~half the probe rows hit key 3
    lk = np.where(rng.random(nl) < 0.5, 3,
                  rng.integers(0, 400, nl)).astype(np.int32)
    lv = rng.standard_normal(nl)
    rk = np.arange(nr, dtype=np.int32)  # build side unique (PK)
    rv = rng.standard_normal(nr)
    sl = par.distribute(Table.from_dict({"k": lk, "lv": lv}), mesh)
    sr = par.distribute(Table.from_dict({"k": rk, "rv": rv}), mesh)
    out = par.dist_join_salted(mesh, sl, sr, ["k"], ["k"], how="inner",
                               num_bins=64, threshold=3.0)
    got = _df(par.collect(out)).sort_values(
        ["k", "lv"]).reset_index(drop=True)
    exp = pd.DataFrame({"k": lk, "lv": lv}).merge(
        pd.DataFrame({"k": rk, "rv": rv}), on="k").sort_values(
        ["k", "lv"]).reset_index(drop=True)
    assert len(got) == len(exp)
    np.testing.assert_array_equal(got["k"].values, exp["k"].values)
    np.testing.assert_allclose(got["lv"].values, exp["lv"].values)
    np.testing.assert_allclose(got["rv"].values, exp["rv"].values)


def test_salted_join_planned_runs_under_jit(mesh, rng):
    """plan_salted_join + dist_join_salted(plan=...) inside a fully
    jitted pipeline (round-4 weak #5: the salted path was eager-only),
    matching the eager salted result exactly."""
    nl, nr = 2048, 256
    lk = np.where(rng.random(nl) < 0.5, 7,
                  rng.integers(0, 300, nl)).astype(np.int32)
    lv = rng.standard_normal(nl)
    rk = np.arange(nr, dtype=np.int32)
    rv = rng.standard_normal(nr)
    sl = par.distribute(Table.from_dict({"k": lk, "lv": lv}), mesh)
    sr = par.distribute(Table.from_dict({"k": rk, "rv": rv}), mesh)
    plan = par.plan_salted_join(mesh, sl, sr, ["k"], ["k"], how="inner",
                                num_bins=64, threshold=3.0)

    @jax.jit
    def pipeline(sl, sr):
        return par.dist_join_salted(mesh, sl, sr, ["k"], ["k"],
                                    plan=plan)

    got = _df(par.collect(pipeline(sl, sr))).sort_values(
        ["k", "lv"]).reset_index(drop=True)
    exp = pd.DataFrame({"k": lk, "lv": lv}).merge(
        pd.DataFrame({"k": rk, "rv": rv}), on="k").sort_values(
        ["k", "lv"]).reset_index(drop=True)
    assert len(got) == len(exp)
    np.testing.assert_allclose(got["lv"].values, exp["lv"].values)
    np.testing.assert_allclose(got["rv"].values, exp["rv"].values)


def test_salted_join_left_with_nulls(mesh, rng):
    nl, nr = 2048, 256
    lk = np.where(rng.random(nl) < 0.6, 11,
                  rng.integers(0, 600, nl)).astype(np.int32)
    lnull = rng.random(nl) < 0.1
    lv = rng.standard_normal(nl)
    rk = rng.permutation(1024)[:nr].astype(np.int32)
    rv = rng.standard_normal(nr)
    sl = par.distribute(Table.from_dict({"k": lk, "lv": lv},
                                        nulls={"k": lnull}), mesh)
    sr = par.distribute(Table.from_dict({"k": rk, "rv": rv}), mesh)
    out = par.dist_join_salted(mesh, sl, sr, ["k"], ["k"], how="left",
                               num_bins=64, threshold=3.0)
    got = _df(par.collect(out))
    pl = pd.DataFrame({"k": np.where(lnull, np.nan, lk), "lv": lv})
    exp = pl.merge(pd.DataFrame({"k": rk.astype(np.float64), "rv": rv}),
                   on="k", how="left")
    assert len(got) == len(exp)
    gs = got.sort_values(["lv"]).reset_index(drop=True)
    es = exp.sort_values(["lv"]).reset_index(drop=True)
    np.testing.assert_allclose(gs["lv"].values, es["lv"].values)
    np.testing.assert_allclose(gs["rv"].values.astype(np.float64),
                               es["rv"].values.astype(np.float64),
                               equal_nan=True)
