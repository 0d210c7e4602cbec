"""Raw-bit views of columns, from arithmetic alone.

The engine's first backend could not compile a 64-bit `bitcast-convert`,
so this module produces the IEEE-754 / two's-complement bit pattern
of any fixed-width column using only arithmetic:

  - integers 64-bit: `astype(uint64)` (XLA integer convert is modular
    two's complement == a bitcast);
  - float64: exact binary decomposition — scale-by-powers-of-two binary
    search for the exponent, exact mantissa extraction (every step
    multiplies by a power of two or subtracts aligned values, so no
    rounding occurs). Verified bit-exact against numpy's view(uint64) in
    tests/test_hashing.py (modulo: -0.0 canonicalizes to +0.0's bits, NaN
    to the canonical quiet NaN — both are hash/sort-order irrelevant).
  - 32-bit and narrower: plain bitcast (supported everywhere).

Used by row hashing (bit-exact MurmurHash3_32 placement parity with the
reference, hash_functions.cuh:30-121) and by radix key encoding
(ops/sort.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Descending powers of two for the exponent binary search; 512+…+1 = 1023
# covers the full float64 exponent range after denormal pre-scaling.
_EXP_STEPS = (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)


def f64_ieee_bits(x: jax.Array) -> jax.Array:
    """IEEE-754 bit pattern of a float64 array as uint64, arithmetic-only.

    Canonicalizations (all hash/sort-order benign, and matching XLA's
    flush-to-zero float semantics — XLA flushes denormal operands in
    arithmetic, so their bits are unrecoverable here):
      -0.0 and denormals -> ±0.0's bits; NaN -> canonical quiet NaN
    (0x7FF8000000000000). Normals and ±inf are bit-exact."""
    assert x.dtype == jnp.float64, x.dtype
    neg = x < 0.0  # note: False for -0.0 (canonicalized)
    nan = x != x
    inf = jnp.isinf(x)
    m = jnp.abs(x)
    # Denormals flush to zero (see docstring).
    zero = m < jnp.float64(2.0 ** -1022)
    finite = ~(nan | inf | zero)

    # Replace non-finite lanes with 1.0 so the search below stays in range.
    mm = jnp.where(finite, m, jnp.float64(1.0))
    e = jnp.zeros(x.shape, jnp.int64)

    # Binary-search scale mm into [1, 2); every multiply is by a power of
    # two, hence exact. Pass 1: reduce mm >= 2.
    for k in _EXP_STEPS:
        big = mm >= jnp.float64(2.0 ** k)
        mm = jnp.where(big, mm * jnp.float64(2.0 ** -k), mm)
        e = jnp.where(big, e + k, e)
    # Pass 2: raise mm < 1.
    for k in _EXP_STEPS:
        small = mm < jnp.float64(2.0 ** (1 - k))
        mm = jnp.where(small, mm * jnp.float64(2.0 ** k), mm)
        e = jnp.where(small, e - k, e)

    # mm in [1,2): mm-1 has exactly the 52 fraction bits; *2^52 is exact.
    frac = ((mm - jnp.float64(1.0)) * jnp.float64(2.0 ** 52)).astype(
        jnp.int64).astype(jnp.uint64)
    biased = (e + jnp.int64(1023)).astype(jnp.uint64)

    bits = (biased << 52) | frac
    bits = jnp.where(zero, jnp.uint64(0), bits)
    bits = jnp.where(inf, jnp.uint64(0x7FF) << 52, bits)
    bits = jnp.where(nan, jnp.uint64(0x7FF8000000000000), bits)
    return bits | (neg.astype(jnp.uint64) << 63)


def to_unsigned_bits(data: jax.Array) -> jax.Array:
    """Bit pattern of any fixed-width numeric column as the same-width
    unsigned integer dtype, avoiding 64-bit bitcasts."""
    dt = data.dtype
    if dt == jnp.float64:
        return f64_ieee_bits(data)
    if dt.kind in "iu" and dt.itemsize == 8:
        return data.astype(jnp.uint64)  # modular convert == bitcast
    if dt == jnp.bool_:
        return data.astype(jnp.uint8)
    if dt.kind == "u":
        return data
    udt = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}[dt.itemsize]
    return jax.lax.bitcast_convert_type(data, udt)


def f64_from_ieee_bits(bits: jax.Array) -> jax.Array:
    """Inverse of f64_ieee_bits: reconstruct float64 values from their
    IEEE-754 bit pattern using only exact arithmetic (no 64-bit bitcast).
    Denormal payloads decode to 0 (matching the forward canonicalization)."""
    assert bits.dtype == jnp.uint64, bits.dtype
    sign = (bits >> 63) != 0
    e = ((bits >> 52) & jnp.uint64(0x7FF)).astype(jnp.int64)
    frac = (bits & jnp.uint64((1 << 52) - 1)).astype(jnp.int64)
    nan = jnp.logical_and(e == 0x7FF, frac != 0)
    inf = jnp.logical_and(e == 0x7FF, frac == 0)
    zero = e == 0

    # mantissa in [1, 2): exact (frac < 2^52, scale by 2^-52 exact).
    m = jnp.float64(1.0) + frac.astype(jnp.float64) * jnp.float64(2.0 ** -52)
    ee = jnp.where(zero | (e == 0x7FF), jnp.int64(1023), e) - 1023
    # Scale by 2^ee via exact power-of-two multiplies.
    for k in _EXP_STEPS:
        up = ee >= k
        m = jnp.where(up, m * jnp.float64(2.0 ** k), m)
        ee = jnp.where(up, ee - k, ee)
    for k in _EXP_STEPS:
        dn = ee <= -k
        m = jnp.where(dn, m * jnp.float64(2.0 ** -k), m)
        ee = jnp.where(dn, ee + k, ee)
    m = jnp.where(zero, jnp.float64(0.0), m)
    m = jnp.where(inf, jnp.float64(jnp.inf), m)
    m = jnp.where(nan, jnp.float64(jnp.nan), m)
    return jnp.where(sign, -m, m)


def from_unsigned_bits(u: jax.Array, dtype) -> jax.Array:
    """Inverse of to_unsigned_bits: reinterpret the unsigned bit pattern
    as `dtype`, avoiding 64-bit bitcasts."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return f64_from_ieee_bits(u)
    if dtype.kind in "iu" and dtype.itemsize == 8:
        return u.astype(dtype)  # modular convert == bitcast
    if dtype == jnp.bool_:
        return u != 0
    if dtype.kind == "u":
        return u.astype(dtype)
    return jax.lax.bitcast_convert_type(u, dtype)


def u64_words(u: jax.Array):
    """(lo32, hi32) uint32 words of a uint64 array, arithmetic-only."""
    assert u.dtype == jnp.uint64, u.dtype
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (u >> 32).astype(jnp.uint32)
    return lo, hi
