"""Public ops on the GPU against numpy at 2^24 rows. Marked ``gpu``: they
skip on the CPU and run inside chip_smoke.py (or with RS_TEST_GPU=1 on a
machine with a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs

pytestmark = pytest.mark.gpu

N = 1 << 24


def _u32(seed):
    return jax.random.bits(jax.random.PRNGKey(seed), (N,), jnp.uint32)


def test_gpu_sort_u32():
    keys = _u32(0)
    np.testing.assert_array_equal(np.asarray(rs.sort(keys)),
                                  np.sort(np.asarray(keys)))


def test_gpu_sort_descending_i64():
    keys = jax.random.bits(jax.random.PRNGKey(1), (N,), jnp.uint64).astype(
        jnp.int64)
    np.testing.assert_array_equal(np.asarray(rs.sort(keys, descending=True)),
                                  np.sort(np.asarray(keys))[::-1])


def test_gpu_sort_pairs_u64_stable():
    k = jax.random.bits(jax.random.PRNGKey(2), (N,), jnp.uint64) & jnp.uint64(
        0xFFFF)
    v = jnp.arange(N, dtype=jnp.int32)
    ko, vo = rs.sort_pairs(k, v)
    perm = np.argsort(np.asarray(k), kind="stable")
    np.testing.assert_array_equal(np.asarray(vo), perm)
    np.testing.assert_array_equal(np.asarray(ko), np.asarray(k)[perm])


def test_gpu_join_inner():
    nb = N // 8
    bk = jax.random.permutation(jax.random.PRNGKey(3), nb).astype(jnp.uint32)
    bv = (bk * jnp.uint32(7)).astype(jnp.int32)
    pk = _u32(4) % jnp.uint32(2 * nb)
    ok, ov, oi, cnt = rs.join(bk, bv, pk)
    c = int(cnt)
    hp = np.asarray(pk)
    want = np.nonzero(hp < nb)[0]
    assert c == want.shape[0]
    ok, ov, oi = np.asarray(ok)[:c], np.asarray(ov)[:c], np.asarray(oi)[:c]
    np.testing.assert_array_equal(np.sort(oi), want)
    np.testing.assert_array_equal(hp[oi], ok)
    np.testing.assert_array_equal(ov, (ok * np.uint32(7)).astype(np.int32))


def test_gpu_groupby_sum_i64():
    keys = _u32(5) % jnp.uint32(1 << 16)
    vals = jax.random.randint(jax.random.PRNGKey(6), (N,), -(1 << 30),
                              1 << 30, jnp.int64)
    gk, gv, cnt = rs.groupby(keys, vals, agg="sum")
    hk, hv = np.asarray(keys), np.asarray(vals)
    order = np.argsort(hk, kind="stable")
    uk, starts = np.unique(hk[order], return_index=True)
    sums = np.add.reduceat(hv[order], starts)
    c = int(cnt)
    np.testing.assert_array_equal(np.asarray(gk)[:c], uk)
    np.testing.assert_array_equal(np.asarray(gv)[:c], sums)


def test_gpu_groupby_mean_f64():
    # float sums run in another order than numpy's; relative error of an
    # f64 sum of ~256 terms stays far below 1e-12
    keys = _u32(7) % jnp.uint32(1 << 16)
    vals = jax.random.normal(jax.random.PRNGKey(8), (N,), jnp.float64)
    gk, gv, cnt = rs.groupby(keys, vals, agg="mean")
    hk, hv = np.asarray(keys), np.asarray(vals)
    sums = np.bincount(hk, weights=hv, minlength=1 << 16)
    cnts = np.bincount(hk, minlength=1 << 16)
    c = int(cnt)
    k = np.asarray(gk)[:c]
    np.testing.assert_allclose(np.asarray(gv)[:c], sums[k] / cnts[k],
                               rtol=1e-12, atol=1e-12)


def test_gpu_query_plan():
    import chip_smoke as cs

    fact, dim = cs._query_tables(N, N // 8, 9)
    cols, count, _ = cs.query_plan(fact, dim).run()
    cs.check_query(fact, N // 8, cols, count)


def test_gpu_plan_quantiles_one_card_mesh():
    """The mesh plan's quantile refinement counts with a float32 matmul of
    0/1 matrices; exact counts are required for exact medians."""
    from cuda.radixsort_tpu.parallel import dsort

    keys = _u32(10) % jnp.uint32(9)
    vals = (_u32(11) % jnp.uint32(1000)).astype(jnp.int32)
    t = rs.table(k=keys, v=vals)
    out, cnt, _ = (rs.Query(t).quantiles("k", "v", (0.5,), max_groups=16)
                   .run(mesh=dsort.make_mesh(1)))
    hk, hv = np.asarray(keys), np.asarray(vals)
    c = int(np.asarray(cnt).sum())
    assert c == 9
    for k, q in zip(np.asarray(out["k"])[:c], np.asarray(out["q50"])[:c]):
        assert float(q) == float(np.median(hv[hk == k]))
