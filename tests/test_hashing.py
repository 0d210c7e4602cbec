"""Hashing tests: bit-exact MurmurHash3_32, hash_combine, hash_partition.

The pure-Python oracle below implements the published MurmurHash3_32
algorithm (public domain, Austin Appleby) exactly as the reference vendors
it (hash_functions.cuh:30-121), so these tests prove row placement parity
with libgdf."""
import jax.numpy as jnp
import numpy as np
import pytest

from libgdf_tpu import Column, Table, ops

M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85ebca6b) & M32
    h ^= h >> 13
    h = (h * 0xc2b2ae35) & M32
    h ^= h >> 16
    return h


def mmh3_py(data: bytes, seed=0):
    """Reference MurmurHash3_x86_32 oracle."""
    c1, c2 = 0xcc9e2d51, 0x1b873593
    h1 = seed
    nblocks = len(data) // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 4:(i + 1) * 4], "little")
        k1 = (k1 * c1) & M32
        k1 = _rotl(k1, 15)
        k1 = (k1 * c2) & M32
        h1 ^= k1
        h1 = _rotl(h1, 13)
        h1 = (h1 * 5 + 0xe6546b64) & M32
    tail = data[nblocks * 4:]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & M32
        k1 = _rotl(k1, 15)
        k1 = (k1 * c2) & M32
        h1 ^= k1
    h1 ^= len(data)
    return _fmix(h1)


def hash_combine_py(lhs, rhs):
    return (lhs ^ ((rhs + 0x9e3779b9 + ((lhs << 6) & M32) + (lhs >> 2))
                   & M32)) & M32


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.float32, np.float64])
def test_murmur3_bit_exact(dtype, rng):
    if np.issubdtype(dtype, np.floating):
        x = (rng.standard_normal(200) * 1e3).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, 200, endpoint=True,
                         dtype=np.int64).astype(dtype)
    got = np.asarray(ops.murmur3_32(jnp.asarray(x)))
    expect = np.asarray([mmh3_py(v.tobytes()) for v in x], np.uint32)
    np.testing.assert_array_equal(got, expect)


def test_murmur3_known_vectors():
    # Canonical MurmurHash3_x86_32 test vectors.
    assert mmh3_py(b"", 0) == 0
    assert mmh3_py((0x12345678).to_bytes(4, "little"), 0) == \
        int(ops.murmur3_32(jnp.asarray([0x12345678], jnp.int32))[0])


def test_hash_combine_matches_boost(rng):
    a = rng.integers(0, M32, 100, dtype=np.uint32)
    b = rng.integers(0, M32, 100, dtype=np.uint32)
    got = np.asarray(ops.hash_combine(jnp.asarray(a), jnp.asarray(b)))
    expect = np.asarray([hash_combine_py(int(x), int(y))
                         for x, y in zip(a, b)], np.uint32)
    np.testing.assert_array_equal(got, expect)


def test_multi_column_row_hash(rng):
    """hash_row: first column as-is, then combine (gdf_table.cuh:704-854)."""
    a = rng.integers(0, 1000, 50, dtype=np.int32)
    b = rng.integers(0, 1000, 50, dtype=np.int64)
    t = Table.from_dict({"a": a, "b": b})
    got = np.asarray(ops.hash_columns(t.columns))
    expect = np.asarray(
        [hash_combine_py(mmh3_py(x.tobytes()), mmh3_py(y.tobytes()))
         for x, y in zip(a, b)], np.uint32)
    np.testing.assert_array_equal(got, expect)


def test_hash_partition_membership_and_offsets(rng):
    """Every row lands in the partition its row-hash maps to
    (≅ tests/hashing/hash-partition-test.cu:166-252), and offsets mark
    contiguous partition starts."""
    n, P = 1000, 7
    a = rng.integers(0, 100, n, dtype=np.int32)
    b = rng.standard_normal(n).astype(np.float32)
    t = Table.from_dict({"a": a, "b": b})
    out, offsets = ops.hash_partition(t, ["a"], P)
    out_a = np.asarray(out["a"].data)
    out_b = np.asarray(out["b"].data)
    offsets = np.asarray(offsets)
    expect_part = np.asarray([mmh3_py(v.tobytes()) % P for v in a])
    # partition histogram
    counts = np.bincount(expect_part, minlength=P)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    np.testing.assert_array_equal(offsets, starts)
    # membership: rows in [offsets[p], offsets[p+1]) hash to p
    bounds = list(offsets) + [n]
    for p in range(P):
        seg = out_a[bounds[p]:bounds[p + 1]]
        assert all(mmh3_py(v.tobytes()) % P == p for v in seg)
    # row integrity: (a, b) pairs survive the rearrangement
    got = sorted(zip(out_a.tolist(), out_b.tolist()))
    expect = sorted(zip(a.tolist(), b.tolist()))
    assert got == expect


def test_partition_sizes(rng):
    n, P = 512, 5
    a = rng.integers(0, 50, n, dtype=np.int32)
    t = Table.from_dict({"a": a})
    pid = ops.partition_ids(t, ["a"], P)
    sizes = np.asarray(ops.partition_sizes(pid, P))
    expect = np.bincount(np.asarray(pid), minlength=P)
    np.testing.assert_array_equal(sizes, expect)


def test_identity_hash(rng):
    a = rng.integers(0, 1000, 64, dtype=np.int32)
    t = Table.from_dict({"a": a})
    h = np.asarray(ops.hash_columns(t.columns, hash_fn="identity"))
    np.testing.assert_array_equal(h, a.astype(np.uint32))


def test_f64_ieee_bits_exact(rng):
    """core/bits.py arithmetic IEEE-754 decomposition is bit-exact with a
    numpy view(uint64), across normals, denormals, zeros, infinities, and
    exponent boundaries (row hashing and sort encoding rely on this
    path, which uses no 64-bit bitcast)."""
    from libgdf_tpu.core.bits import f64_ieee_bits

    special = np.array([
        0.0, 1.0, -1.0, 2.0, 0.5, 1.5, -2.5, np.inf, -np.inf,
        np.finfo(np.float64).max, np.finfo(np.float64).min,
        np.finfo(np.float64).tiny,            # smallest normal
        2.0 ** -1022, 2.0 ** 1023,
        1.0 + 2.0 ** -52,                     # 1 + ulp
        2.0 - 2.0 ** -52,                     # just under 2
    ])
    randoms = rng.standard_normal(2000) * np.exp(
        rng.uniform(-300, 300, 2000))
    x = np.concatenate([special, randoms]).astype(np.float64)
    got = np.asarray(f64_ieee_bits(jnp.asarray(x)))
    expect = x.view(np.uint64)
    np.testing.assert_array_equal(got, expect)
    # canonicalizations: -0.0 -> +0.0 bits, NaN -> quiet NaN, denormals
    # flush to +0.0 bits (XLA FTZ applies to comparisons too, so even the
    # sign of a denormal is unrecoverable).
    canon = np.asarray(f64_ieee_bits(jnp.asarray(
        [-0.0, np.nan, 5e-324, -5e-324, np.finfo(np.float64).tiny / 2])))
    np.testing.assert_array_equal(
        canon, np.array([0, 0x7FF8000000000000, 0, 0, 0],
                        dtype=np.uint64))


def test_murmur3_64bit_dtypes(rng):
    """64-bit column hashing (the arithmetic bits path) matches
    the reference algorithm byte-for-byte via the pure-python oracle."""
    for arr in [rng.integers(-2**62, 2**62, 64).astype(np.int64),
                (rng.standard_normal(64) * 1e6).astype(np.float64)]:
        t = Table.from_dict({"a": arr})
        h = np.asarray(ops.hash_columns(t.columns))
        expect = np.array([mmh3_py(v.tobytes()) for v in arr],
                          dtype=np.uint32)
        np.testing.assert_array_equal(h, expect)


# ---------------------------------------------------------------------------
# FNV-1a 64 (gpu_hash_columns, hashops.cu:25-120)
# ---------------------------------------------------------------------------

M64 = (1 << 64) - 1


def fnv1a_ref(row_vals_and_widths):
    """Oracle replicating the reference's hash_fnv_array_op exactly:
    little-endian bytes, each byte xored as a SIGN-EXTENDED char."""
    h = 14695981039346656037
    for val, width in row_vals_and_widths:
        raw = int(val) & ((1 << (8 * width)) - 1)
        for j in range(width):
            byte = (raw >> (8 * j)) & 0xFF
            sx = byte if byte < 0x80 else byte | (M64 ^ 0xFF)  # sign-extend
            h = ((h ^ sx) * 1099511628211) & M64
    return h


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.float32, np.float64])
def test_fnv1a_bit_exact(dtype, rng):
    n = 64
    if np.issubdtype(dtype, np.floating):
        vals = rng.standard_normal(n).astype(dtype)
    else:
        info = np.iinfo(dtype)
        vals = rng.integers(info.min, info.max, n).astype(dtype)
    got = np.asarray(ops.fnv1a_64_columns([jnp.asarray(vals)]))
    width = np.dtype(dtype).itemsize
    for i in range(n):
        raw = int(np.frombuffer(vals[i:i + 1].tobytes(), dtype=np.uint64
                                if width == 8 else np.uint32 if width == 4
                                else np.uint16 if width == 2 else np.uint8
                                )[0])
        assert int(got[i]) == fnv1a_ref([(raw, width)]), (dtype, i)


def test_fnv1a_multi_column(rng):
    a = rng.integers(-100, 100, 16).astype(np.int32)
    b = rng.integers(0, 1 << 15, 16).astype(np.int16)
    got = np.asarray(ops.fnv1a_64_columns([jnp.asarray(a), jnp.asarray(b)]))
    for i in range(16):
        want = fnv1a_ref([(int(a[i]) & 0xFFFFFFFF, 4),
                          (int(b[i]) & 0xFFFF, 2)])
        assert int(got[i]) == want


def test_gpu_hash_columns_compat(rng):
    from libgdf_tpu.compat import gdf as compat
    a = Column.from_array(rng.integers(0, 100, 8).astype(np.int64))
    out = compat.gpu_hash_columns([a])
    assert out.data.dtype == jnp.int64
    want = np.asarray(ops.fnv1a_64_columns([a])).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(out.data), want)
