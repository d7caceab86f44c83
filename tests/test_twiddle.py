"""Twiddle oracle tests: order preservation, bijectivity, edge bit patterns.

Mirrors the reference's key-ordering traits semantics (CUB util_type.cuh:839-942,
radix_rank_sort_operations.cuh:79-104,575-618): signed = XOR sign bit, float =
flip-if-negative, descending = extra complement, -0.0 canonicalized to +0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda.radixsort_tpu import twiddle

INT_DTYPES = [jnp.uint8, jnp.uint16, jnp.uint32, jnp.uint64,
              jnp.int8, jnp.int16, jnp.int32, jnp.int64]
FLOAT_DTYPES = [jnp.float16, jnp.bfloat16, jnp.float32, jnp.float64]


def _rand(dtype, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    d = jnp.dtype(dtype)
    if jnp.issubdtype(d, jnp.integer):
        info = jnp.iinfo(d)
        vals = rng.integers(int(info.min), int(info.max), size=n, endpoint=True,
                            dtype=np.int64 if info.min < 0 else np.uint64)
        return jnp.asarray(vals.astype(d))
    # floats: random bit patterns -> covers denormals, infs, weird exponents
    u = twiddle.unsigned_dtype(d)
    bits = rng.integers(0, 2 ** (8 * d.itemsize), size=n, dtype=np.uint64)
    arr = jnp.asarray(bits.astype(jnp.dtype(u)), dtype=u).view(d)
    # drop NaNs for the order test (NaN order is bit-pattern defined, tested
    # separately in test_sort_oracle)
    return jnp.where(jnp.isnan(arr), jnp.zeros_like(arr), arr)


@pytest.mark.parametrize("dtype", INT_DTYPES + FLOAT_DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_order_preserved(dtype, descending):
    x = _rand(dtype)
    bits = np.asarray(twiddle.twiddle_in(x, descending=descending))
    order = np.argsort(bits, kind="stable")
    xs = np.asarray(x.astype(jnp.float64) if jnp.issubdtype(jnp.dtype(dtype), jnp.floating) else x)[order]
    if descending:
        assert np.all(xs[:-1] >= xs[1:])
    else:
        assert np.all(xs[:-1] <= xs[1:])


@pytest.mark.parametrize("dtype", INT_DTYPES + FLOAT_DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_roundtrip(dtype, descending):
    x = _rand(dtype, seed=1)
    bits = twiddle.twiddle_in(x, descending=descending)
    back = twiddle.twiddle_out(bits, dtype, descending=descending)
    # -0.0 canonicalizes to +0.0; otherwise bit-exact.
    xs = np.asarray(x)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.floating):
        xs = np.where(xs == 0, np.zeros_like(xs), xs)
    np.testing.assert_array_equal(np.asarray(back), xs)


def test_float_special_order():
    f = jnp.array([np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5,
                   np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny],
                  dtype=jnp.float32)
    bits = np.asarray(twiddle.twiddle_in(f))
    order = np.argsort(bits, kind="stable")
    expect = [-np.inf, -1.5, -np.finfo(np.float32).tiny, 0.0, 0.0,
              np.finfo(np.float32).tiny, 1.5, np.inf]
    got = np.asarray(f)[order]
    got = np.where(got == 0, 0.0, got)
    np.testing.assert_array_equal(got, np.array(expect, dtype=np.float32))


def test_nan_order():
    # positive NaNs above +inf, negative NaNs below -inf (reference semantics)
    pnan = np.uint32(0x7FC00000).view(np.float32)
    nnan = np.uint32(0xFFC00000).view(np.float32)
    f = jnp.array([pnan, np.inf, -np.inf, nnan], dtype=jnp.float32)
    bits = np.asarray(twiddle.twiddle_in(f))
    assert bits[0] > bits[1]  # +NaN > +inf
    assert bits[3] < bits[2]  # -NaN < -inf
