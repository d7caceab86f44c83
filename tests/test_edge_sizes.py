"""Edge sizes (0, 1, 2) across the public operator surface + DeviceTopK /
DeviceTransform compat. CUB sweeps size 0/1/partial-tile in its device
tests (SURVEY §4); this is the analogue."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.cub_compat import DeviceTopK, DeviceTransform


@pytest.mark.parametrize("n", [0, 1, 2])
def test_edge_sizes_all_ops(n):
    x = jnp.asarray(np.arange(n, dtype=np.uint32)[::-1].copy())
    v = jnp.asarray(np.arange(n, dtype=np.int32))
    np.testing.assert_array_equal(np.asarray(rs.sort(x)),
                                  np.sort(np.asarray(x)))
    ok, ov = rs.sort_pairs(x, v)
    np.testing.assert_array_equal(np.asarray(ok), np.sort(np.asarray(x)))
    uk, cnt = rs.unique(x)
    assert int(cnt) == n  # descending iota: every element distinct
    gk, gv, gc = rs.groupby(x, v, agg="sum")
    assert int(gc) == n
    m = rs.merge_sorted(jnp.sort(x), jnp.sort(x))
    np.testing.assert_array_equal(
        np.asarray(m), np.sort(np.concatenate([x, x])))
    out = rs.comparator_sort(x, lambda a, b: a < b)
    np.testing.assert_array_equal(np.asarray(out), np.sort(np.asarray(x)))
    if n:
        vals, idx = rs.top_k(x, 1)
        assert int(vals[0]) == n - 1
        assert int(rs.kth_value(x, 0)) == 0


def test_device_topk(rng=np.random.default_rng(5)):
    x = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    v = np.arange(3000, dtype=np.int32)
    mx = DeviceTopK.MaxKeys(jnp.asarray(x), 10)
    np.testing.assert_array_equal(np.asarray(mx), np.sort(x)[::-1][:10])
    mn, mv = DeviceTopK.MinPairs(jnp.asarray(x), jnp.asarray(v), 7)
    np.testing.assert_array_equal(np.asarray(mn), np.sort(x)[:7])
    np.testing.assert_array_equal(x[np.asarray(mv)], np.asarray(mn))


def test_device_transform():
    a = jnp.arange(100, dtype=jnp.int32)
    b = jnp.arange(100, dtype=jnp.int32) * 2
    out = DeviceTransform.Transform((a, b), lambda x, y: x + y)
    np.testing.assert_array_equal(np.asarray(out), np.arange(100) * 3)
    out1 = DeviceTransform.Transform(a, lambda x: x * x)
    np.testing.assert_array_equal(np.asarray(out1), np.arange(100) ** 2)


def test_device_n_boundary_loud_error():
    """Device paths are int32-indexed; >2^31 rows must fail loudly with a
    pointer to the out-of-core path, not wrap (CUB instead
    widens offsets, device_radix_sort.cuh:353)."""
    too_big = jax.ShapeDtypeStruct(((1 << 31) + 128,), jnp.uint32)
    vals = jax.ShapeDtypeStruct(((1 << 31) + 128,), jnp.int32)
    with pytest.raises(ValueError, match="int32-indexed"):
        jax.eval_shape(rs.sort, too_big)
    with pytest.raises(ValueError, match="sort_external"):
        jax.eval_shape(rs.sort_pairs, too_big, vals)
    with pytest.raises(ValueError, match="int32-indexed"):
        jax.eval_shape(rs.argsort, too_big)
    with pytest.raises(ValueError, match="int32-indexed"):
        jax.eval_shape(lambda k: rs.sort_struct((k,)), too_big)
