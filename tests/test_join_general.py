"""The join's general (many-to-many) path: scatter each emitting row's
words at its output offset, carry them forward, rank = slot - base.

Checked against a numpy oracle for build multiplicities 1-5, with the
output capacity cut below the true count (offsets past it are dropped,
the count stays exact), and through the int64-word branch that keeps
shards past 2^28 rows correct."""
import jax
import numpy as np
import pytest

from libgdf_tpu import Table, ops
from libgdf_tpu.ops import join_mod


def _oracle(lk, lnull, rk, how):
    """Sorted (l, r) pairs; -1 marks the unmatched side."""
    pairs = []
    by_key = {}
    for j, k in enumerate(rk):
        by_key.setdefault(int(k), []).append(j)
    matched = set()
    for i, k in enumerate(lk):
        hits = [] if lnull[i] else by_key.get(int(k), [])
        pairs += [(i, j) for j in hits]
        matched.update(hits)
        if not hits and how in ("left", "full"):
            pairs.append((i, -1))
    if how == "full":
        pairs += [(-1, j) for j in range(len(rk)) if j not in matched]
    return sorted(pairs)


def _data(rng, mult, nl=300, ndistinct=40):
    lk = rng.integers(0, ndistinct + 10, nl).astype(np.int32)
    lnull = rng.random(nl) < 0.1
    rk = np.repeat(rng.permutation(ndistinct), mult).astype(np.int32)
    return lk, lnull, rk


def _join(lk, lnull, rk, how, cap=None):
    lt = Table.from_dict({"k": lk}, nulls={"k": lnull})
    rt = Table.from_dict({"k": rk})
    if cap is None:
        return ops.join_indices(lt, rt, ["k"], ["k"], how)
    return jax.jit(lambda lt, rt: ops.join_indices(
        lt, rt, ["k"], ["k"], how, out_capacity=cap))(lt, rt)


def _pairs(li, ri, count):
    count = int(count)
    return sorted(zip(np.asarray(li)[:count].tolist(),
                      np.asarray(ri)[:count].tolist()))


@pytest.mark.parametrize("mult", [1, 2, 3, 4, 5])
def test_general_path_multiplicities(rng, mult):
    lk, lnull, rk = _data(rng, mult)
    li, ri, count = _join(lk, lnull, rk, "inner")
    assert _pairs(li, ri, count) == _oracle(lk, lnull, rk, "inner")


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_offsets_past_capacity_are_dropped(rng, how):
    lk, lnull, rk = _data(rng, 3)
    full_li, full_ri, total = _join(lk, lnull, rk, how)
    total = int(total)
    cap = total // 2
    li, ri, count = _join(lk, lnull, rk, how, cap=cap)
    assert int(count) == total          # exact, so overflow is visible
    np.testing.assert_array_equal(np.asarray(li), np.asarray(full_li)[:cap])
    np.testing.assert_array_equal(np.asarray(ri), np.asarray(full_ri)[:cap])


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_int64_word_branch(rng, how, monkeypatch):
    """Row ids past _PACK_MAX switch the emit words to int64 (and the
    merge sort to its multi-operand form); the result is the same."""
    lk, lnull, rk = _data(rng, 4)
    monkeypatch.setattr(join_mod, "_PACK_MAX", 16)
    li, ri, count = _join(lk, lnull, rk, how)
    assert _pairs(li, ri, count) == _oracle(lk, lnull, rk, how)
