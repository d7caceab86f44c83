"""End-to-end sort plumbing on both engines: bit-range restriction (the
masked-copy path), key+payload pairs, 64-bit limb decomposition across the
limb boundary, constant keys and payload dtypes. Broad dtype/size coverage
lives in test_sort_oracle.py."""

import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs

ENGINES = pytest.mark.parametrize(
    "cfg", [rs.SortConfig(engine="xla"),
            rs.SortConfig(engine="reference", tile_rows=8)],
    ids=["xla", "reference"])


@ENGINES
def test_u32_low_byte(cfg):
    rng = np.random.default_rng(0)
    n = 20_000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = np.asarray(rs.sort(jnp.asarray(keys), end_bit=8, config=cfg))
    perm = np.argsort(keys & 0xFF, kind="stable")
    np.testing.assert_array_equal(got, keys[perm])


@ENGINES
def test_pairs_low16(cfg):
    rng = np.random.default_rng(1)
    n = 5_000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.int32)
    gk, gv = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                           end_bit=16, config=cfg)
    perm = np.argsort(keys & 0xFFFF, kind="stable")
    np.testing.assert_array_equal(np.asarray(gk), keys[perm])
    np.testing.assert_array_equal(np.asarray(gv), vals[perm])


@ENGINES
def test_u64_cross_limb_bits(cfg):
    # bit range [28, 36) spans both u32 limbs: hi limb sorts bits [0,4),
    # lo limb bits [28,32)
    rng = np.random.default_rng(2)
    n = 8_000
    keys = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    got = np.asarray(
        rs.sort(jnp.asarray(keys), begin_bit=28, end_bit=36, config=cfg)
    )
    mask = np.uint64(((1 << 36) - 1) & ~((1 << 28) - 1))
    perm = np.argsort(keys & mask, kind="stable")
    np.testing.assert_array_equal(got, keys[perm])


@ENGINES
def test_constant_and_hot_byte_keys(cfg):
    """Constant keys keep payload order (stability); keys that vary only in
    one byte sort on it."""
    rng = np.random.default_rng(3)
    n = 6_000
    keys = np.full(n, 0xABCD1234, dtype=np.uint32)
    vals = np.arange(n, dtype=np.int32)
    gk, gv = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                           end_bit=16, config=cfg)
    np.testing.assert_array_equal(np.asarray(gk), keys)
    np.testing.assert_array_equal(np.asarray(gv), vals)
    keys = (0x5A000000 | (rng.integers(0, 256, size=n) << 8)).astype(np.uint32)
    got = np.asarray(rs.sort(jnp.asarray(keys), end_bit=16, config=cfg))
    np.testing.assert_array_equal(got, np.sort(keys))


@ENGINES
def test_payload_dtypes(cfg):
    """bool, i16, i64 and f64 payloads follow their keys bit-exactly."""
    rng = np.random.default_rng(5)
    n = 2500
    k = rng.integers(0, 2**16, n, dtype=np.uint64).astype(np.uint32)
    o = np.argsort(k, kind="stable")
    vb = rng.integers(0, 2, n).astype(bool)
    v16 = rng.integers(-2**15, 2**15, n).astype(np.int16)
    v64 = rng.integers(-2**60, 2**60, n, dtype=np.int64)
    f64 = rng.standard_normal(n)
    gk, (ob, o16, o64, of) = rs.sort_pairs(
        jnp.asarray(k), (jnp.asarray(vb), jnp.asarray(v16),
                         jnp.asarray(v64), jnp.asarray(f64)),
        config=cfg, end_bit=16)
    np.testing.assert_array_equal(np.asarray(gk), k[o])
    np.testing.assert_array_equal(np.asarray(ob), vb[o])
    np.testing.assert_array_equal(np.asarray(o16), v16[o])
    np.testing.assert_array_equal(np.asarray(o64), v64[o])
    np.testing.assert_array_equal(np.asarray(of), f64[o])
