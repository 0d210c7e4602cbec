"""Stream compaction (ops/compaction.py: compact_arrays) against numpy.

Every array keeps its capacity; the first `count` rows are the kept
rows in their original order.

≅ reference streamcompaction tests (libgdf/src/tests/streamcompaction/...)."""
import jax.numpy as jnp
import numpy as np
import pytest

from libgdf_tpu.ops.compaction import compact_arrays


def _check(outs, cnt, arrays, keep):
    cnt = int(cnt)
    assert cnt == int(keep.sum())
    for o, a in zip(outs, arrays):
        assert o.shape == a.shape and o.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(o)[:cnt], a[keep])


@pytest.mark.parametrize("n,p", [
    (100, 0.5), (1024, 0.0), (1024, 1.0), (3072, 0.95), (2048, 1.0),
    (5897, 0.3), (4096, 0.02), (2049, 0.6),
])
def test_compact_matches_numpy(rng, n, p):
    x = rng.integers(-2**31, 2**31, n).astype(np.int32)
    y = rng.standard_normal(n).astype(np.float32)
    keep = (rng.random(n) < p) if 0 < p < 1 else np.full(n, bool(p))
    outs, cnt = compact_arrays([jnp.asarray(x), jnp.asarray(y)],
                               jnp.asarray(keep))
    _check(outs, cnt, [x, y], keep)


def test_compact_8byte_words_and_validity(rng):
    n = 3172
    a = rng.integers(-2**62, 2**62, n).astype(np.int64)
    b = rng.standard_normal(n).astype(np.float64)
    valid = rng.random(n) < 0.7
    keep = rng.random(n) < 0.4
    outs, cnt = compact_arrays(
        [jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid)],
        jnp.asarray(keep))
    _check(outs, cnt, [a, b, valid], keep)


def test_compact_many_bool_planes(rng):
    n = 2081
    bools = [rng.random(n) < 0.5 for _ in range(12)]
    keep = rng.random(n) < 0.6
    outs, cnt = compact_arrays([jnp.asarray(b) for b in bools],
                               jnp.asarray(keep))
    _check(outs, cnt, bools, keep)


def test_compact_empty():
    (out,), cnt = compact_arrays([jnp.zeros((0,), jnp.int32)],
                                 jnp.zeros((0,), bool))
    assert int(cnt) == 0 and out.shape == (0,)
