"""Distributed selection ops (parallel/dselect.py) on the CPU-8 mesh."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda.radixsort_tpu.parallel import dselect, dsort


@pytest.fixture(scope="module")
def mesh():
    return dsort.make_mesh()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("n,k", [(8 * 1024, 0), (8 * 1024 + 13, 777),
                                 (4096, 4095)])
def test_kth_value_distributed(mesh, rng, n, k):
    x = rng.integers(0, 5000, size=n, dtype=np.uint32)  # duplicates
    got = dselect.kth_value_distributed(jnp.asarray(x), k, mesh=mesh)
    assert int(got) == int(np.sort(x)[k])


def test_kth_value_distributed_largest_and_signed(mesh, rng):
    x = rng.integers(-(2**31), 2**31, size=6000).astype(np.int32)
    got = dselect.kth_value_distributed(jnp.asarray(x), 5, mesh=mesh,
                                        largest=True)
    assert int(got) == int(np.sort(x)[::-1][5])


def test_kth_value_distributed_float(mesh, rng):
    x = rng.normal(size=5003).astype(np.float32)
    x[::97] = -0.0
    got = dselect.kth_value_distributed(jnp.asarray(x), 2501, mesh=mesh)
    assert float(got) == float(np.sort(x)[2501])


@pytest.mark.parametrize("n,k", [(8 * 1024, 100), (8 * 1000 + 3, 17)])
def test_top_k_distributed(mesh, rng, n, k):
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    vals, idx = dselect.top_k_distributed(jnp.asarray(x), k, mesh=mesh)
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_array_equal(vals, np.sort(x)[::-1][:k])
    np.testing.assert_array_equal(x[idx], vals)


def test_top_k_distributed_ties_match_single_chip(mesh, rng):
    from cuda.radixsort_tpu.ops.select import top_k as local_topk

    x = rng.integers(0, 4, size=4096, dtype=np.uint32)  # massive ties
    vals, idx = dselect.top_k_distributed(jnp.asarray(x), 50, mesh=mesh)
    lv, li = local_topk(jnp.asarray(x), 50, largest=True)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(lv))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(li))


def test_top_k_distributed_smallest(mesh, rng):
    x = rng.integers(0, 2**32, size=5555, dtype=np.uint32)
    vals, idx = dselect.top_k_distributed(jnp.asarray(x), 33, mesh=mesh,
                                          largest=False)
    np.testing.assert_array_equal(np.asarray(vals), np.sort(x)[:33])
    np.testing.assert_array_equal(x[np.asarray(idx)], np.asarray(vals))


def test_top_k_distributed_k_exceeds_shard(mesh, rng):
    # k > per-shard rows: every shard contributes everything
    x = rng.integers(0, 1000, size=800, dtype=np.uint32)
    vals, _ = dselect.top_k_distributed(jnp.asarray(x), 300, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(vals), np.sort(x)[::-1][:300])


@pytest.mark.parametrize("n", [8 * 512, 8 * 512 + 5])
def test_distinct_distributed(mesh, rng, n):
    # few distinct values -> runs span shard boundaries
    x = rng.integers(0, 37, size=n, dtype=np.uint32)
    uk, counts = dselect.distinct_distributed(jnp.asarray(x), mesh=mesh)
    uk, counts = np.asarray(uk), np.asarray(counts)
    rows = uk.shape[0] // counts.shape[0]
    got = np.concatenate([uk.reshape(counts.shape[0], rows)[d, : counts[d]]
                          for d in range(counts.shape[0])])
    np.testing.assert_array_equal(got, np.unique(x))


def test_distinct_distributed_single_value(mesh):
    # one global run: only device holding the head keeps one copy
    x = np.full(4096, 42, np.uint32)
    uk, counts = dselect.distinct_distributed(jnp.asarray(x),
                                              mesh=dsort.make_mesh())
    assert int(np.asarray(counts).sum()) == 1
    rows = uk.shape[0] // counts.shape[0]
    d = int(np.flatnonzero(np.asarray(counts))[0])
    assert int(np.asarray(uk).reshape(-1, rows)[d, 0]) == 42


def test_distinct_distributed_signed(mesh, rng):
    x = rng.integers(-50, 50, size=3000).astype(np.int32)
    uk, counts = dselect.distinct_distributed(jnp.asarray(x), mesh=mesh)
    uk, counts = np.asarray(uk), np.asarray(counts)
    rows = uk.shape[0] // counts.shape[0]
    got = np.concatenate([uk.reshape(-1, rows)[d, : counts[d]]
                          for d in range(counts.shape[0])])
    np.testing.assert_array_equal(got, np.unique(x))


def _np_group_quantiles(keys, values, qs):
    gk = np.unique(keys)
    out = {q: np.array([np.quantile(values[keys == g].astype(np.float64), q)
                        for g in gk]) for q in qs}
    return gk, out


@pytest.mark.parametrize("n,ng", [(8 * 1024, 7), (6007, 1), (4096, 13)])
def test_groupby_quantile_distributed(mesh, rng, n, ng):
    keys = rng.integers(0, ng, size=n, dtype=np.uint32) * 3 + 1
    vals = rng.integers(0, 100000, size=n, dtype=np.uint32)
    gk, qcols, cnt = dselect.groupby_quantile_distributed(
        jnp.asarray(keys), jnp.asarray(vals), qs=(0.0, 0.5, 1.0),
        mesh=mesh, max_groups=16)
    cnt = int(cnt)
    ok, oq = _np_group_quantiles(keys, vals, (0.0, 0.5, 1.0))
    assert cnt == len(ok)
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], ok)
    for q, col in zip((0.0, 0.5, 1.0), qcols):
        np.testing.assert_allclose(np.asarray(col)[:cnt], oq[q],
                                   rtol=1e-6)


def test_groupby_quantile_distributed_float_vals_signed_keys(mesh, rng):
    keys = rng.integers(-4, 4, size=5000).astype(np.int32)
    vals = rng.normal(size=5000).astype(np.float32)
    gk, qcols, cnt = dselect.groupby_quantile_distributed(
        jnp.asarray(keys), jnp.asarray(vals), qs=(0.25, 0.75),
        mesh=mesh, max_groups=8)
    cnt = int(cnt)
    ok, oq = _np_group_quantiles(keys, vals, (0.25, 0.75))
    assert cnt == len(ok)
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], ok)
    for q, col in zip((0.25, 0.75), qcols):
        np.testing.assert_allclose(np.asarray(col)[:cnt], oq[q],
                                   rtol=1e-5, atol=1e-6)


def test_groupby_quantile_distributed_matches_single_chip(mesh, rng):
    from cuda.radixsort_tpu.ops.aggregate import groupby_quantile

    keys = rng.integers(0, 5, size=4099, dtype=np.uint32)
    vals = rng.integers(0, 1000, size=4099, dtype=np.uint32)
    gk, qcols, cnt = dselect.groupby_quantile_distributed(
        jnp.asarray(keys), jnp.asarray(vals), qs=(0.5,), mesh=mesh,
        max_groups=8)
    lk, lq, lcnt = groupby_quantile(jnp.asarray(keys), jnp.asarray(vals),
                                    qs=(0.5,))
    cnt = int(cnt)
    assert cnt == int(lcnt)
    np.testing.assert_array_equal(np.asarray(gk)[:cnt],
                                  np.asarray(lk)[:cnt])
    np.testing.assert_allclose(np.asarray(qcols[0])[:cnt],
                               np.asarray(lq[0])[:cnt], rtol=1e-6)


def test_groupby_quantile_distributed_extreme_key_bits(mesh, rng):
    # a real group whose twiddled key equals the pad bit pattern
    keys = np.where(rng.random(4096) < 0.3, np.uint32(0xFFFFFFFF),
                    np.uint32(5)).astype(np.uint32)
    vals = rng.integers(0, 100, size=4096, dtype=np.uint32)
    gk, qcols, cnt = dselect.groupby_quantile_distributed(
        jnp.asarray(keys), jnp.asarray(vals), qs=(0.5,), mesh=mesh,
        max_groups=4)
    cnt = int(cnt)
    ok, oq = _np_group_quantiles(keys, vals, (0.5,))
    assert cnt == len(ok)
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], ok)
    np.testing.assert_allclose(np.asarray(qcols[0])[:cnt], oq[0.5],
                               rtol=1e-6)

def test_groupby_quantile_distributed_overflow_groups(mesh, rng):
    # 12 distinct groups, max_groups=8: truncation must be REPORTED
    # (n_groups > max_groups) and the 8 key-smallest groups must stay
    # exact — rows of dropped groups may not corrupt kept slots
    # (searchsorted would otherwise clip them in).
    keys = rng.integers(0, 12, size=6000).astype(np.uint32) * 7 + 2
    vals = rng.integers(0, 100000, size=6000).astype(np.uint32)
    gk, qcols, cnt = dselect.groupby_quantile_distributed(
        jnp.asarray(keys), jnp.asarray(vals), qs=(0.5,), mesh=mesh,
        max_groups=8)
    assert int(cnt) > 8  # truncation signalled
    ok, oq = _np_group_quantiles(keys, vals, (0.5,))
    np.testing.assert_array_equal(np.asarray(gk)[:8], ok[:8])
    np.testing.assert_allclose(np.asarray(qcols[0])[:8], oq[0.5][:8],
                               rtol=1e-6)
