"""Native host-runtime tests (C++ build + ctypes bindings)."""

import numpy as np
import pytest

from cuda.radixsort_tpu.utils import native


def test_native_builds():
    assert native.lib() is not None, "g++ build of csrc/hostutils.cpp failed"


def test_random_deterministic():
    a = native.random_u32(100_000, seed=7)
    b = native.random_u32(100_000, seed=7)
    c = native.random_u32(100_000, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # rough uniformity
    h = np.bincount(a >> 28, minlength=16)
    assert h.min() > 100_000 / 16 * 0.9


def test_lsd_sort_oracle():
    keys = native.random_u32(500_000, seed=1)
    got = native.lsd_sort_u32(keys)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert native.verify_sorted_u32(got) == -1
    assert native.verify_sorted_u32(keys[::-1].copy()) != -1
    assert native.compare_u32(got, np.sort(keys)) == -1


def test_lsd_sort_pairs():
    keys = native.random_u32(200_000, seed=2) % 1000  # duplicates: stability
    vals = np.arange(200_000, dtype=np.int32)
    gk, gv = native.lsd_sort_pairs_u32(keys, vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_histogram16():
    keys = native.random_u32(300_000, seed=3)
    for shift in (0, 12, 28):
        got = native.histogram16(keys, shift)
        want = np.bincount((keys >> shift) & 15, minlength=16)
        np.testing.assert_array_equal(got, want)


def test_skewed():
    keys = native.skewed_u32(200_000, seed=4, hot_key=99, hot_fraction=0.6)
    frac = np.mean(keys == 99)
    assert 0.55 < frac < 0.65


def test_profiling_speed_of_light():
    from cuda.radixsort_tpu.utils import profiling
    r = profiling.speed_of_light(4.8e12, 1.0, kind="NVIDIA H200")
    assert abs(r["fraction_of_sol"] - 1.0) < 1e-9


def test_profiling_timed_calls():
    import jax.numpy as jnp
    from cuda.radixsort_tpu.utils import profiling
    r = profiling.timed_calls(lambda x: x * 2, (jnp.arange(1024),), m=3)
    assert len(r["samples"]) == 3 and r["seconds"] > 0
    assert min(r["samples"]) <= r["seconds"] <= max(r["samples"])


def test_native_u64_oracles():
    from cuda.radixsort_tpu.utils import native

    rng = np.random.default_rng(5)
    k = rng.integers(0, 2**63, size=100_000, dtype=np.uint64)
    v = np.arange(100_000, dtype=np.uint32)
    sk = native.lsd_sort_u64(k)
    np.testing.assert_array_equal(sk, np.sort(k))
    assert native.verify_sorted_u64(sk) == -1
    assert native.verify_sorted_u64(k[::-1].copy()) >= 0
    ok, ov = native.lsd_sort_pairs_u64(k, v)
    o = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(ok, k[o])
    np.testing.assert_array_equal(ov, v[o])
    assert native.compare_u64(sk, ok) == -1
    bad = sk.copy(); bad[17] ^= np.uint64(1)
    assert native.compare_u64(sk, bad) == 17
