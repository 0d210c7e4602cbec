"""Join tests vs a host multimap oracle.

≅ reference tests/join/join-tests.cu:260-340: reference solution built with
a host std::multimap including full row-equality with valids (NULL never
matches); GDF result and oracle both sorted and compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libgdf_tpu import Table, ops


def _oracle_join(lkeys, rkeys, lnull, rnull, how):
    """Host multimap oracle. Returns sorted list of (l, r) index pairs,
    -1 for unmatched side."""
    from collections import defaultdict
    m = defaultdict(list)
    for j, k in enumerate(rkeys):
        if not rnull[j]:
            m[tuple(np.atleast_1d(k))].append(j)
    out = []
    matched_r = set()
    for i, k in enumerate(lkeys):
        hits = [] if lnull[i] else m.get(tuple(np.atleast_1d(k)), [])
        if hits:
            for j in hits:
                out.append((i, j))
                matched_r.add(j)
        elif how in ("left", "full"):
            out.append((i, -1))
    if how == "full":
        for j in range(len(rkeys)):
            if j not in matched_r:
                out.append((-1, j))
    return sorted(out)


def _run_join(lkeys, rkeys, lnull, rnull, how, multi=False):
    if multi:
        lt = Table.from_dict({"k1": lkeys[:, 0], "k2": lkeys[:, 1]},
                             nulls={"k1": lnull})
        rt = Table.from_dict({"k1": rkeys[:, 0], "k2": rkeys[:, 1]},
                             nulls={"k1": rnull})
        on = ["k1", "k2"]
    else:
        lt = Table.from_dict({"k": lkeys}, nulls={"k": lnull})
        rt = Table.from_dict({"k": rkeys}, nulls={"k": rnull})
        on = ["k"]
    li, ri, count = ops.join_indices(lt, rt, on, on, how=how)
    cnt = int(count)
    got = sorted(zip(np.asarray(li)[:cnt].tolist(),
                     np.asarray(ri)[:cnt].tolist()))
    return got


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_with_nulls(how, rng):
    nl, nr = 200, 150
    lk = rng.integers(0, 50, nl).astype(np.int32)
    rk = rng.integers(0, 50, nr).astype(np.int32)
    lnull = rng.random(nl) < 0.15
    rnull = rng.random(nr) < 0.15
    got = _run_join(lk, rk, lnull, rnull, how)
    expect = _oracle_join(lk, rk, lnull, rnull, how)
    assert got == expect


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_i64_keys_narrow_and_wide_range(how, rng):
    """64-bit keys: narrow runtime range takes the compressed 1-word
    sort, a >2^32 span takes the general 2-operand branch — identical
    results either way (the emit plan's dynamic key fold)."""
    nl, nr = 150, 120
    lnull = rng.random(nl) < 0.1
    rnull = rng.random(nr) < 0.1
    lk = rng.integers(0, 40, nl).astype(np.int64)
    rk = rng.integers(0, 40, nr).astype(np.int64)
    got = _run_join(lk, rk, lnull, rnull, how)
    assert got == _oracle_join(lk, rk, lnull, rnull, how)
    # same key structure, stretched past 2^32 (negative end too)
    stretch = np.int64(1) << 40
    lk2 = np.where(lk < 20, lk - stretch, lk + stretch)
    rk2 = np.where(rk < 20, rk - stretch, rk + stretch)
    got2 = _run_join(lk2, rk2, lnull, rnull, how)
    assert got2 == _oracle_join(lk2, rk2, lnull, rnull, how)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_multi_column(how, rng):
    nl, nr = 120, 100
    lk = rng.integers(0, 8, (nl, 2)).astype(np.int64)
    rk = rng.integers(0, 8, (nr, 2)).astype(np.int64)
    lnull = rng.random(nl) < 0.1
    rnull = rng.random(nr) < 0.1
    got = _run_join(lk, rk, lnull, rnull, how, multi=True)
    # oracle: a null in k1 kills the row
    expect = _oracle_join([tuple(r) for r in lk], [tuple(r) for r in rk],
                          lnull, rnull, how)
    assert got == expect


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_size_asymmetry(how, rng):
    """≅ join-tests.cu:578-707 size-asymmetric cases."""
    lk = rng.integers(0, 5, 1000).astype(np.int32)
    rk = np.arange(5, dtype=np.int32)
    got = _run_join(lk, rk, np.zeros(1000, bool), np.zeros(5, bool), how)
    expect = _oracle_join(lk, rk, np.zeros(1000, bool),
                          np.zeros(5, bool), how)
    assert got == expect


def test_join_all_equal_keys(rng):
    """Degenerate: every key equal (quadratic output)."""
    lk = np.zeros(30, np.int32)
    rk = np.zeros(40, np.int32)
    got = _run_join(lk, rk, np.zeros(30, bool), np.zeros(40, bool), "inner")
    assert len(got) == 30 * 40


def test_join_no_matches():
    lk = np.arange(10, dtype=np.int32)
    rk = np.arange(100, 110, dtype=np.int32)
    got = _run_join(lk, rk, np.zeros(10, bool), np.zeros(10, bool), "inner")
    assert got == []


def test_join_under_jit_with_capacity(rng):
    """join_indices is jittable with a static out_capacity."""
    lk = rng.integers(0, 20, 100).astype(np.int32)
    rk = rng.integers(0, 20, 80).astype(np.int32)
    lt = Table.from_dict({"k": lk})
    rt = Table.from_dict({"k": rk})

    @jax.jit
    def f(lt, rt):
        return ops.join_indices(lt, rt, ["k"], ["k"], "inner",
                                out_capacity=2048)

    li, ri, count = f(lt, rt)
    cnt = int(count)
    got = sorted(zip(np.asarray(li)[:cnt].tolist(),
                     np.asarray(ri)[:cnt].tolist()))
    expect = _oracle_join(lk, rk, np.zeros(100, bool), np.zeros(80, bool),
                          "inner")
    assert got == expect
    # dead slots are -1/-1
    assert (np.asarray(li)[cnt:] == -1).all()


def test_join_materialized_gathers_payloads(rng):
    lt = Table.from_dict({"k": np.asarray([1, 2, 3, 4], np.int32),
                          "lv": np.asarray([10., 20., 30., 40.],
                                           np.float32)})
    rt = Table.from_dict({"k": np.asarray([2, 2, 5], np.int32),
                          "rv": np.asarray([7, 8, 9], np.int64)})
    out = ops.join(lt, rt, ["k"], ["k"], how="left").compact()
    df = out.to_pandas().sort_values(["k", "rv"]).reset_index(drop=True)
    assert df["k"].tolist() == [1, 2, 2, 3, 4]
    assert df["lv"].tolist() == [10., 20., 20., 30., 40.]
    rv = df["rv"].tolist()
    assert rv[1:3] == [7, 8]
    import pandas as pd
    assert pd.isna(rv[0]) and pd.isna(rv[3]) and pd.isna(rv[4])


def test_join_respects_num_rows(rng):
    """Joining filtered (capacity+count) tables ignores dead rows."""
    lk = np.arange(20, dtype=np.int32)
    lt = Table.from_dict({"k": lk})
    lt = ops.filter_table(lt, ops.compare_scalar(lt["k"], 10, "lt"))
    rt = Table.from_dict({"k": np.arange(5, 15, dtype=np.int32)})
    li, ri, count = ops.join_indices(lt, rt, ["k"], ["k"], "inner")
    cnt = int(count)
    assert cnt == 5  # keys 5..9
    lvals = np.asarray(lt["k"].data)[np.asarray(li)[:cnt]]
    assert sorted(lvals.tolist()) == [5, 6, 7, 8, 9]


def test_join_nan_keys_never_match():
    lk = np.asarray([1.0, np.nan, 2.0], np.float32)
    rk = np.asarray([np.nan, 2.0], np.float32)
    lt = Table.from_dict({"k": lk})
    rt = Table.from_dict({"k": rk})
    li, ri, count = ops.join_indices(lt, rt, ["k"], ["k"], "inner")
    assert int(count) == 1  # only 2.0 == 2.0


def test_join_negative_zero_matches_zero():
    lk = np.asarray([-0.0], np.float64)
    rk = np.asarray([0.0], np.float64)
    lt = Table.from_dict({"k": lk})
    rt = Table.from_dict({"k": rk})
    _, _, count = ops.join_indices(lt, rt, ["k"], ["k"], "inner")
    assert int(count) == 1


def test_lex_searchsorted_matches_numpy(rng):
    import jax.numpy as jnp
    s = np.sort(rng.integers(0, 100, 500).astype(np.int64))
    q = rng.integers(-10, 110, 200).astype(np.int64)
    enc_s = ops.radix_encode(jnp.asarray(s))
    enc_q = ops.radix_encode(jnp.asarray(q))
    lo = np.asarray(ops.lex_searchsorted([enc_s], [enc_q], "left"))
    hi = np.asarray(ops.lex_searchsorted([enc_s], [enc_q], "right"))
    np.testing.assert_array_equal(lo, np.searchsorted(s, q, "left"))
    np.testing.assert_array_equal(hi, np.searchsorted(s, q, "right"))


def test_join_empty_right_side():
    """Left/full joins must handle a zero-row build side (every probe row
    unmatched; ≅ join_call's trivial-case handling, joining.cu:299-320)."""
    left = Table.from_dict({"k": np.arange(5, dtype=np.int64),
                            "v": np.arange(5, dtype=np.float64)})
    right = Table.from_dict({"k": np.array([], np.int64),
                             "w": np.array([], np.float64)})
    out = ops.join(left, right, ["k"], ["k"], how="left").to_pandas()
    assert len(out) == 5
    assert out["w"].isna().all()
    inner = ops.join(left, right, ["k"], ["k"], how="inner").compact()
    assert inner.capacity == 0


def test_join_empty_left_side():
    left = Table.from_dict({"k": np.array([], np.int64),
                            "v": np.array([], np.float64)})
    right = Table.from_dict({"k": np.arange(3, dtype=np.int64),
                             "w": np.arange(3, dtype=np.float64)})
    out = ops.join(left, right, ["k"], ["k"], how="full").to_pandas()
    assert len(out) == 3
    assert out["v"].isna().all()
    assert sorted(out["k"].tolist()) == [0, 1, 2]


def test_join_capacity_overflow_raises_eagerly(rng):
    """Eager joins raise when the exact output exceeds out_capacity —
    never silent truncation."""
    from libgdf_tpu.core.errors import GDFError
    lk = np.zeros(50, np.int32)
    rk = np.zeros(50, np.int32)   # 2500 output rows
    lt, rt = Table.from_dict({"k": lk}), Table.from_dict({"k": rk})
    with pytest.raises(GDFError):
        ops.join_indices(lt, rt, ["k"], ["k"], "inner", out_capacity=100)


def test_join_capacity_overflow_exact_count_under_jit(rng):
    """Under jit the returned count is the EXACT total (even past the
    capacity), so callers can detect overflow and re-run."""
    lk = np.zeros(40, np.int32)
    rk = np.zeros(40, np.int32)   # 1600 output rows

    @jax.jit
    def f(lt, rt):
        return ops.join_indices(lt, rt, ["k"], ["k"], "inner",
                                out_capacity=64)

    li, ri, count = f(Table.from_dict({"k": lk}), Table.from_dict({"k": rk}))
    assert int(count) == 1600
    # the slots that fit are valid join rows
    assert (np.asarray(li) >= 0).all() and (np.asarray(ri) >= 0).all()


def test_join_no_small_shard_ceiling():
    """Joins beyond the old 2^29 combined-row cap trace fine (the int64
    emit payload removed the ceiling; shape-only check, no allocation)."""
    n = (1 << 29) + 1024

    def f(lk, rk):
        lt = Table.from_dict({"k": lk})
        rt = Table.from_dict({"k": rk})
        return ops.join_indices(lt, rt, ["k"], ["k"], "inner",
                                out_capacity=4096)

    out = jax.eval_shape(f, jax.ShapeDtypeStruct((n,), jnp.int32),
                         jax.ShapeDtypeStruct((1024,), jnp.int32))
    assert out[0].shape == (4096,)


def test_sorted_search_bounds(rng):
    """ops.sorted_search_bounds == np.searchsorted left/right."""
    from libgdf_tpu.ops.sorted_search import sorted_search_bounds
    s = np.sort(rng.integers(0, 50, 200).astype(np.uint32))
    q = rng.integers(0, 55, 64).astype(np.uint32)
    lo, hi = sorted_search_bounds([jnp.asarray(s)], [jnp.asarray(q)])
    np.testing.assert_array_equal(np.asarray(lo),
                                  np.searchsorted(s, q, "left"))
    np.testing.assert_array_equal(np.asarray(hi),
                                  np.searchsorted(s, q, "right"))


def test_join_fast_path_matches_general_path(rng):
    """PK-FK (unique build side) takes the gather-free fast path; forcing
    the same rows down the general path (by duplicating one build row and
    capping its effect) must give identical pairs."""
    m, n = 500, 64
    lk = rng.integers(0, n, m).astype(np.int32)
    rk = np.arange(n, dtype=np.int32)            # unique -> fast path
    left = Table.from_dict({"k": lk})
    right = Table.from_dict({"k": rk})
    li, ri, cnt = ops.inner_join(left, right, ["k"], ["k"], out_capacity=m)
    cnt = int(cnt)
    pairs_fast = sorted(zip(np.asarray(li)[:cnt].tolist(),
                            np.asarray(ri)[:cnt].tolist()))

    # general path: duplicate build key `n` (absent from probe keys is not
    # guaranteed, so pick a key value outside the probe range)
    rk2 = np.concatenate([rk, [1 << 20, 1 << 20]]).astype(np.int32)
    right2 = Table.from_dict({"k": rk2})
    li2, ri2, cnt2 = ops.inner_join(left, right2, ["k"], ["k"],
                                    out_capacity=m)
    cnt2 = int(cnt2)
    assert cnt2 == cnt
    pairs_gen = sorted(zip(np.asarray(li2)[:cnt2].tolist(),
                           np.asarray(ri2)[:cnt2].tolist()))
    assert pairs_fast == pairs_gen


def test_assume_unique_build_hint(rng):
    """Planner hint compiles only the fast path; verified at runtime —
    duplicates on the build side poison the count to -1 instead of
    emitting a wrong join."""
    lk = rng.integers(0, 100, 500).astype(np.int32)
    rk = np.arange(100, dtype=np.int32)
    lt = Table.from_dict({"k": lk})
    rt = Table.from_dict({"k": rk})
    li0, ri0, c0 = ops.join_indices(lt, rt, ["k"], ["k"], "inner",
                                    out_capacity=500)
    li1, ri1, c1 = ops.join_indices(lt, rt, ["k"], ["k"], "inner",
                                    out_capacity=500,
                                    assume_unique_build=True)
    assert int(c0) == int(c1) == 500
    np.testing.assert_array_equal(np.asarray(li0), np.asarray(li1))
    np.testing.assert_array_equal(np.asarray(ri0), np.asarray(ri1))
    # violated hint: duplicate build keys -> poisoned count
    rt2 = Table.from_dict({"k": np.array([1, 1, 2], dtype=np.int32)})
    _, _, c2 = ops.join_indices(lt, rt2, ["k"], ["k"], "inner",
                                out_capacity=2000,
                                assume_unique_build=True)
    assert int(c2) == -1
