"""`segmented_scan` against a numpy loop: every named op over several
dtypes, inclusive and exclusive, heads at block-sized boundaries, long runs
and floats."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda.radixsort_tpu.ops.scan import segmented_scan

_NP_OPS = {"sum": np.add, "prod": np.multiply, "min": np.minimum,
           "max": np.maximum}


def _identity(op, dtype):
    if op == "sum":
        return dtype.type(0)
    if op == "prod":
        return dtype.type(1)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.inf if op == "min" else -np.inf)
    info = np.iinfo(dtype)
    return dtype.type(info.max if op == "min" else info.min)


def _oracle(v, flags, op, exclusive=False):
    f = _NP_OPS[op]
    out = np.empty_like(v)
    acc = None
    for i in range(v.shape[0]):
        if i == 0 or flags[i]:
            acc = None
        if exclusive:
            out[i] = _identity(op, v.dtype) if acc is None else acc
        acc = v[i] if acc is None else f(acc, v[i])
        if not exclusive:
            out[i] = acc
    return out


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
def test_ops_dtypes_vs_numpy(rng, op, dtype, exclusive):
    n = 3000
    if op == "prod":   # keep products small and exact
        v = rng.choice(np.array([1, 1, 1, 2, -1], dtype=dtype), size=n)
    elif np.issubdtype(dtype, np.floating):
        v = rng.integers(-64, 64, size=n).astype(dtype) / dtype(8)
    else:
        v = rng.integers(-999, 999, size=n).astype(dtype)
    fl = rng.random(n) < 0.05
    got = np.asarray(segmented_scan(jnp.asarray(v), jnp.asarray(fl), op,
                                    exclusive=exclusive))
    np.testing.assert_array_equal(got, _oracle(v, fl, op, exclusive))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_sizes_vs_numpy(rng, op):
    for n in (1, 127, 128, 4096, 4097, 3 * 4096 + 5):
        v = rng.integers(-999, 999, size=n).astype(np.int32)
        fl = rng.random(n) < 0.03
        got = np.asarray(segmented_scan(jnp.asarray(v), jnp.asarray(fl), op))
        np.testing.assert_array_equal(got, _oracle(v, fl, op),
                                      err_msg=f"n={n} op={op}")


def test_float_and_long_runs(rng):
    n = 3 * 4096
    v = rng.standard_normal(n).astype(np.float32)
    fl = np.zeros(n, bool)   # one run spanning the whole array
    got = np.asarray(segmented_scan(jnp.asarray(v), jnp.asarray(fl), "sum"))
    np.testing.assert_allclose(got, np.cumsum(v.astype(np.float64)),
                               rtol=2e-4, atol=1e-3)
    got2 = np.asarray(segmented_scan(jnp.asarray(v), jnp.asarray(fl), "max"))
    np.testing.assert_array_equal(got2, np.maximum.accumulate(v))


def test_heads_at_block_boundaries(rng):
    n = 4 * 4096
    v = rng.integers(0, 9, size=n).astype(np.int32)
    fl = np.zeros(n, bool)
    fl[4096::4096] = True
    got = np.asarray(segmented_scan(jnp.asarray(v), jnp.asarray(fl), "sum"))
    want = np.concatenate([np.cumsum(c) for c in np.split(v, 4)])
    np.testing.assert_array_equal(got, want)


def test_empty():
    e = jnp.zeros((0,), jnp.int32)
    out = segmented_scan(e, jnp.zeros((0,), bool))
    assert out.shape == (0,)
