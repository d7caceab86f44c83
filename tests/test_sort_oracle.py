"""Sort oracle tests — the CUB-style property sweep (SURVEY.md §4).

Ground truth is numpy stable sort on twiddled bits. Sweeps dtypes, sizes
(0, 1, sub-tile, tile boundary, multi-tile), descending, bit subranges,
duplicates-heavy/constant inputs, stability via index payloads, and the
reference engine vs the xla engine cross-check.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu import twiddle

REF = rs.SortConfig(engine="reference", tile_rows=8)  # tiny tiles => many tiles
XLA = rs.SortConfig(engine="xla")

SIZES = [0, 1, 2, 100, 1023, 1024, 1025, 4096, 50_000]


def _np_oracle(keys, descending=False, begin_bit=None, end_bit=None):
    """Stable sort permutation from numpy, on masked twiddled bits."""
    bits = np.asarray(twiddle.twiddle_in(jnp.asarray(keys), descending=descending))
    w = twiddle.bit_width(keys.dtype)
    b = 0 if begin_bit is None else begin_bit
    e = w if end_bit is None else end_bit
    mask = ((1 << e) - 1) & ~((1 << b) - 1)
    perm = np.argsort(bits.astype(np.uint64) & np.uint64(mask), kind="stable")
    return keys[perm], perm


def _rand_keys(dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    d = jnp.dtype(dtype)
    if jnp.issubdtype(d, jnp.integer):
        info = jnp.iinfo(d)
        return rng.integers(int(info.min), int(info.max), size=n, endpoint=True,
                            dtype=np.int64 if info.min < 0 else np.uint64).astype(d)
    u = np.dtype(f"uint{8 * d.itemsize}") if d != jnp.bfloat16 else np.uint16
    bits = rng.integers(0, 2 ** (8 * d.itemsize), size=n, dtype=np.uint64).astype(u)
    if d == jnp.bfloat16:
        return np.asarray(jnp.asarray(bits).view(jnp.bfloat16))
    arr = bits.view(d.name)
    return arr


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("engine", ["reference", "xla"])
def test_u32_sizes(n, engine):
    cfg = REF if engine == "reference" else XLA
    keys = _rand_keys(np.uint32, n)
    got = np.asarray(rs.sort(jnp.asarray(keys), config=cfg))
    np.testing.assert_array_equal(got, np.sort(keys, kind="stable"))


DTYPES = [np.uint32, np.int32, np.float32, np.uint64, np.int64, np.float64,
          np.uint16, np.int8]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_dtypes(dtype, descending):
    keys = _rand_keys(dtype, 10_000, seed=2)
    want, _ = _np_oracle(keys, descending=descending)
    got = np.asarray(rs.sort(jnp.asarray(keys), descending=descending, config=REF))
    # float comparison must be bitwise (NaN patterns, -0.0 canonicalization)
    if np.issubdtype(dtype, np.floating):
        want2 = np.where(want == 0, np.zeros_like(want), want)
        np.testing.assert_array_equal(
            got.view(np.uint64 if got.itemsize == 8 else np.uint32),
            want2.view(np.uint64 if got.itemsize == 8 else np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("begin_bit,end_bit", [(0, 8), (8, 24), (4, 13), (0, 0), (16, 32)])
def test_bit_subrange(begin_bit, end_bit):
    keys = _rand_keys(np.uint32, 20_000, seed=3)
    want, perm = _np_oracle(keys, begin_bit=begin_bit, end_bit=end_bit)
    got = np.asarray(rs.sort(jnp.asarray(keys), begin_bit=begin_bit,
                             end_bit=end_bit, config=REF))
    np.testing.assert_array_equal(got, want)


def test_stability_pairs():
    # many duplicate keys; values are original indices — stable sort keeps them
    # ascending within equal keys (the index-tagged-pairs test of CUB's suite).
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 16, size=30_000).astype(np.uint32)
    vals = np.arange(30_000, dtype=np.int32)
    k, v = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), config=REF)
    k, v = np.asarray(k), np.asarray(v)
    np.testing.assert_array_equal(k, np.sort(keys, kind="stable"))
    np.testing.assert_array_equal(v, np.argsort(keys, kind="stable"))


def test_pairs_pytree_payload():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=5_000, dtype=np.uint64).astype(np.uint32)
    payload = {"a": jnp.asarray(rng.standard_normal(5_000), dtype=jnp.float32),
               "b": jnp.asarray(rng.integers(0, 99, size=5_000), dtype=jnp.int32)}
    k, p = rs.sort_pairs(jnp.asarray(keys), payload, config=REF)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(p["a"]), np.asarray(payload["a"])[perm])
    np.testing.assert_array_equal(np.asarray(p["b"]), np.asarray(payload["b"])[perm])


@pytest.mark.parametrize("maker", [
    lambda n: np.zeros(n, np.uint32),                      # constant
    lambda n: np.full(n, 0xFFFFFFFF, np.uint32),           # constant max
    lambda n: np.arange(n, dtype=np.uint32),               # pre-sorted
    lambda n: np.arange(n, dtype=np.uint32)[::-1].copy(),  # reversed
    lambda n: np.tile(np.arange(4, dtype=np.uint32), n // 4),  # few distinct
])
def test_degenerate_distributions(maker):
    keys = maker(8192)
    got = np.asarray(rs.sort(jnp.asarray(keys), config=REF))
    np.testing.assert_array_equal(got, np.sort(keys, kind="stable"))


def test_argsort():
    keys = _rand_keys(np.float32, 9_999, seed=6)
    keys = np.where(np.isnan(keys), np.float32(0), keys)
    perm = np.asarray(rs.argsort(jnp.asarray(keys), config=REF))
    _, want = _np_oracle(keys)
    np.testing.assert_array_equal(perm, want)


def test_u64_pairs_256_boundary():
    # u64 keys exercise the two-limb (hi, lo) column decomposition.
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    vals = np.arange(4096, dtype=np.int32)
    k, v = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), config=REF)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[perm])
    np.testing.assert_array_equal(np.asarray(v), perm)


def test_engines_agree():
    keys = _rand_keys(np.uint32, 65_536, seed=8)
    a = np.asarray(rs.sort(jnp.asarray(keys), config=REF))
    b = np.asarray(rs.sort(jnp.asarray(keys), config=XLA))
    np.testing.assert_array_equal(a, b)


def _bits_view(x):
    """Bitwise view for float comparisons (NaN patterns, -0.0)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        x = np.where(x == 0, np.zeros_like(x), x)
        return x.view(np.dtype(f"uint{8 * x.itemsize}"))
    return x


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_xla_numpy_agree(dtype):
    """The reference LSD engine, the lax.sort engine and numpy give the same
    stable order."""
    keys = _rand_keys(dtype, 6_000, seed=9)
    want, _ = _np_oracle(keys)
    a = rs.sort(jnp.asarray(keys), config=REF)
    b = rs.sort(jnp.asarray(keys), config=XLA)
    np.testing.assert_array_equal(_bits_view(a), _bits_view(want))
    np.testing.assert_array_equal(_bits_view(b), _bits_view(want))


@pytest.mark.parametrize("engine", ["reference", "xla"])
@pytest.mark.parametrize("pay_dtype", [np.float64, np.int64])
def test_pairs_8_byte_payloads(engine, pay_dtype):
    rng = np.random.default_rng(10)
    n = 7_000
    keys = rng.integers(0, 300, size=n).astype(np.uint32)
    if pay_dtype == np.float64:
        vals = rng.standard_normal(n)
    else:
        vals = rng.integers(-2**62, 2**62, size=n, dtype=np.int64)
    cfg = REF if engine == "reference" else XLA
    k, v = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), config=cfg)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[perm])
    assert np.asarray(v).dtype == pay_dtype
    np.testing.assert_array_equal(np.asarray(v), vals[perm])
