"""The engine's scans (ops/engine.py) against numpy, over the dtype matrix.

Values are small integers, so every sum is exact in any order and in
every dtype, float16 included: the scans must match numpy exactly.

≅ reference prefix-sum tests (libgdf/src/tests/prefixsum/...)."""
import jax.numpy as jnp
import numpy as np
import pytest

from libgdf_tpu.ops import engine

DTYPES = [np.int32, np.uint32, np.int64, np.uint64, np.float32, np.float64,
          np.float16]
N = 300


def _vals(rng, dtype, n=N):
    lo = 0 if np.issubdtype(dtype, np.unsignedinteger) else -5
    return rng.integers(lo, 6, n).astype(dtype)


def _segments(rng, n=N):
    starts = rng.random(n) < 0.05
    starts[0] = True
    return starts


def _seg_oracle(x, starts, ufunc):
    out = np.empty_like(x)
    bounds = list(np.flatnonzero(starts)) + [x.size]
    for a, b in zip(bounds[:-1], bounds[1:]):
        out[a:b] = ufunc.accumulate(x[a:b])
    return out


SCANS = {
    "cumsum": (engine.cumsum, np.cumsum),
    "cummax": (engine.cummax, np.maximum.accumulate),
    "cummin": (engine.cummin, np.minimum.accumulate),
    "cummin_reverse": (lambda x: engine.cummin(x, reverse=True),
                       lambda x: np.minimum.accumulate(x[::-1])[::-1]),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("scan", list(SCANS))
def test_scan_matches_numpy(rng, dtype, scan):
    fn, oracle = SCANS[scan]
    x = _vals(rng, dtype)
    got = np.asarray(fn(jnp.asarray(x)))
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, oracle(x).astype(dtype))


SEG = {"sum": (engine.seg_scan_sum, np.add),
       "min": (engine.seg_scan_min, np.minimum),
       "max": (engine.seg_scan_max, np.maximum)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", list(SEG))
def test_segmented_scan_matches_numpy(rng, dtype, kind):
    fn, ufunc = SEG[kind]
    x = _vals(rng, dtype)
    starts = _segments(rng)
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(starts)))
    np.testing.assert_array_equal(got, _seg_oracle(x, starts, ufunc))


def test_cumsum_accumulates_in_requested_dtype(rng):
    x = rng.integers(0, 2, N).astype(bool)
    got = engine.cumsum(jnp.asarray(x), jnp.int32)
    assert got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got), np.cumsum(x))


def test_int64_sums_are_exact_past_32_bits(rng):
    x = rng.integers(-2**40, 2**40, N).astype(np.int64) * np.int64(2**20)
    starts = _segments(rng)
    np.testing.assert_array_equal(np.asarray(engine.cumsum(jnp.asarray(x))),
                                  np.cumsum(x))
    np.testing.assert_array_equal(
        np.asarray(engine.seg_scan_sum(jnp.asarray(x), jnp.asarray(starts))),
        _seg_oracle(x, starts, np.add))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_f64_segmented_minmax_propagates_nan(rng, kind):
    """A NaN poisons the rest of its segment and no other segment — the
    same rule as jnp.minimum / jnp.maximum, on every backend."""
    fn, ufunc = SEG[kind]
    x = rng.standard_normal(N) * 1e12
    starts = _segments(rng)
    nan_at = rng.choice(N, 4, replace=False)
    x[nan_at] = np.nan
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(starts)))
    np.testing.assert_array_equal(got, _seg_oracle(x, starts, ufunc))
    assert np.isnan(got).sum() >= 4


@pytest.mark.parametrize("density", [0.0, 0.03, 1.0])
def test_last_valid_scan(rng, density):
    valid = rng.random(N) < density
    vals = np.arange(N, dtype=np.int32) + 1000
    filled, seen = engine.last_valid_scan(jnp.asarray(valid),
                                          jnp.asarray(vals))
    last = np.maximum.accumulate(np.where(valid, np.arange(N), -1))
    np.testing.assert_array_equal(np.asarray(seen), last >= 0)
    np.testing.assert_array_equal(
        np.asarray(filled), np.where(last >= 0, last + 1000, vals))
