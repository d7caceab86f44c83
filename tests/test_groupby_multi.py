"""Multi-key multi-aggregate group-by: ops.groupby_multi, Table.groupby_agg,
Query.groupby_agg (single-chip + distributed)."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda.radixsort_tpu.ops.aggregate import groupby_multi
from cuda.radixsort_tpu.parallel import dsort
from cuda.radixsort_tpu.pipeline.plan import Query
from cuda.radixsort_tpu.table import table


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(44)


@pytest.fixture(scope="module")
def mesh():
    return dsort.make_mesh()


def _oracle(a, b, v, mask=None):
    if mask is None:
        mask = np.ones(a.shape[0], bool)
    out = {}
    for i in np.flatnonzero(mask):
        k = (int(a[i]), int(b[i]))
        s, c, mn, mx = out.get(k, (0, 0, None, None))
        vi = int(v[i])
        out[k] = (s + vi, c + 1,
                  vi if mn is None else min(mn, vi),
                  vi if mx is None else max(mx, vi))
    return dict(sorted(out.items()))


def test_groupby_multi_two_keys_all_aggs(rng):
    n = 3000
    a = rng.integers(0, 5, size=n).astype(np.uint32)
    b = rng.integers(0, 7, size=n).astype(np.int32)
    v = rng.integers(-50, 50, size=n).astype(np.int32)
    kc, vc, cnt = groupby_multi(
        (jnp.asarray(a), jnp.asarray(b)),
        (jnp.asarray(v), jnp.asarray(v), jnp.asarray(v), jnp.asarray(v)),
        ("sum", "count", "min", "max"))
    cnt = int(cnt)
    oracle = _oracle(a, b, v)
    assert cnt == len(oracle)
    got_keys = list(zip(np.asarray(kc[0])[:cnt].tolist(),
                        np.asarray(kc[1])[:cnt].tolist()))
    assert got_keys == list(oracle)  # key-ascending lexicographic
    for j, field in enumerate(range(4)):
        np.testing.assert_array_equal(
            np.asarray(vc[j])[:cnt],
            np.array([oracle[k][field] for k in oracle]))


def test_groupby_multi_valid_mask(rng):
    n = 1000
    a = rng.integers(0, 4, size=n).astype(np.uint32)
    b = rng.integers(0, 4, size=n).astype(np.uint32)
    v = rng.integers(0, 100, size=n).astype(np.int32)
    valid = rng.random(n) < 0.5
    kc, vc, cnt = groupby_multi(
        (jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(v),), ("sum",),
        valid=jnp.asarray(valid))
    oracle = _oracle(a, b, v, valid)
    assert int(cnt) == len(oracle)
    np.testing.assert_array_equal(
        np.asarray(vc[0])[: int(cnt)],
        np.array([oracle[k][0] for k in oracle]))


def test_table_groupby_agg(rng):
    n = 2000
    a = rng.integers(0, 6, size=n).astype(np.uint32)
    v = rng.integers(0, 100, size=n).astype(np.int32)
    t = table(a=jnp.asarray(a), v=jnp.asarray(v))
    out, cnt = t.groupby_agg(["a"], {"total": ("v", "sum"),
                                     "n": ("v", "count"),
                                     "lo": ("v", "min")})
    cnt = int(cnt)
    uk = np.unique(a)
    assert cnt == uk.shape[0]
    np.testing.assert_array_equal(np.asarray(out["a"])[:cnt], uk)
    np.testing.assert_array_equal(
        np.asarray(out["total"])[:cnt],
        np.array([v[a == k].sum() for k in uk]))
    np.testing.assert_array_equal(
        np.asarray(out["n"])[:cnt],
        np.array([(a == k).sum() for k in uk]))
    np.testing.assert_array_equal(
        np.asarray(out["lo"])[:cnt],
        np.array([v[a == k].min() for k in uk]))
    with pytest.raises(ValueError):
        t.groupby_agg(["a"], {"a": ("v", "sum")})


def test_query_groupby_agg_single_and_distributed(rng):
    mesh = dsort.make_mesh()
    n = 8 * 400 + 3
    a = rng.integers(0, 9, size=n).astype(np.uint32)
    b = rng.integers(0, 3, size=n).astype(np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(a=jnp.asarray(a), b=jnp.asarray(b), v=jnp.asarray(v))

    def plan(t):
        return (Query(t)
                .where(lambda t: t["v"] > 300)
                .groupby_agg(["a", "b"], {"s": ("v", "sum"),
                                          "c": ("v", "count"),
                                          "hi": ("v", "max")}))

    so, sc, _ = plan(t).run()
    sc = int(sc)
    mask = v > 300
    oracle = {}
    for i in np.flatnonzero(mask):
        k = (int(a[i]), int(b[i]))
        s, c, hi = oracle.get(k, (0, 0, -1))
        oracle[k] = (s + int(v[i]), c + 1, max(hi, int(v[i])))
    assert sc == len(oracle)
    got = {(int(ka), int(kb)): (int(s), int(c), int(hi))
           for ka, kb, s, c, hi in zip(
               np.asarray(so["a"])[:sc], np.asarray(so["b"])[:sc],
               np.asarray(so["s"])[:sc], np.asarray(so["c"])[:sc],
               np.asarray(so["hi"])[:sc])}
    assert got == oracle

    do, dcounts, _ = plan(t).run(mesh=mesh)
    dcounts = np.asarray(dcounts)
    rows = np.asarray(do["a"]).shape[0] // dcounts.shape[0]
    dgot = {}
    for d in range(dcounts.shape[0]):
        sl = slice(d * rows, d * rows + dcounts[d])
        for ka, kb, s, c, hi in zip(
                np.asarray(do["a"])[sl], np.asarray(do["b"])[sl],
                np.asarray(do["s"])[sl], np.asarray(do["c"])[sl],
                np.asarray(do["hi"])[sl]):
            dgot[(int(ka), int(kb))] = (int(s), int(c), int(hi))
    assert dgot == oracle


def test_groupby_mean_single(rng):
    """mean on the single-chip groupby: int values -> f32 means."""
    from cuda.radixsort_tpu.ops.aggregate import groupby
    n = 2000
    k = rng.integers(0, 11, size=n).astype(np.uint32)
    v = rng.integers(-40, 40, size=n).astype(np.int32)
    gk, gv, cnt = groupby(jnp.asarray(k), jnp.asarray(v), agg="mean")
    cnt = int(cnt)
    assert gv.dtype == jnp.float32
    uk = np.unique(k)
    assert cnt == uk.shape[0]
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], uk)
    want = np.array([v[k == u].mean() for u in uk], np.float32)
    np.testing.assert_allclose(np.asarray(gv)[:cnt], want, rtol=1e-6)


def test_groupby_mean_float_dtype(rng):
    """float values keep their dtype through mean."""
    from cuda.radixsort_tpu.ops.aggregate import groupby
    n = 512
    k = rng.integers(0, 5, size=n).astype(np.uint32)
    v = rng.random(n).astype(np.float32)
    gk, gv, cnt = groupby(jnp.asarray(k), jnp.asarray(v), agg="mean")
    cnt = int(cnt)
    assert gv.dtype == jnp.float32
    uk = np.unique(k)
    want = np.array([v[k == u].mean() for u in uk], np.float64)
    np.testing.assert_allclose(np.asarray(gv)[:cnt], want, rtol=1e-5)


def test_groupby_multi_mean_mixed(rng):
    """mean mixed with sum/count in one groupby_multi call."""
    n = 3000
    a = rng.integers(0, 6, size=n).astype(np.uint32)
    v = rng.integers(0, 100, size=n).astype(np.int32)
    kc, vc, cnt = groupby_multi(
        (jnp.asarray(a),),
        (jnp.asarray(v), jnp.asarray(v), jnp.asarray(v)),
        ("sum", "mean", "count"))
    cnt = int(cnt)
    uk = np.unique(a)
    assert cnt == uk.shape[0]
    np.testing.assert_array_equal(
        np.asarray(vc[0])[:cnt], [v[a == u].sum() for u in uk])
    np.testing.assert_allclose(
        np.asarray(vc[1])[:cnt],
        np.array([v[a == u].mean() for u in uk], np.float32), rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(vc[2])[:cnt], [(a == u).sum() for u in uk])


def test_query_groupby_mean_distributed(mesh, rng):
    """mean travels as (sum, count) through the two-phase exchange and is
    assembled after the final re-aggregation — dist result == single-chip."""
    n = 8 * 512 + 7
    k = rng.integers(0, 23, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    def plan(t):
        return (Query(t)
                .groupby_agg(["k"], {"m": ("v", "mean"),
                                     "s": ("v", "sum")}))

    so, sc, _ = plan(t).run()
    sc = int(sc)
    uk = np.unique(k)
    assert sc == uk.shape[0]
    want_m = {int(u): v[k == u].mean() for u in uk}
    want_s = {int(u): int(v[k == u].sum()) for u in uk}
    for kk, m, s in zip(np.asarray(so["k"])[:sc], np.asarray(so["m"])[:sc],
                        np.asarray(so["s"])[:sc]):
        np.testing.assert_allclose(m, want_m[int(kk)], rtol=1e-6)
        assert int(s) == want_s[int(kk)]

    do, dcounts, _ = plan(t).run(mesh=mesh)
    dcounts = np.asarray(dcounts)
    rows = np.asarray(do["k"]).shape[0] // dcounts.shape[0]
    seen = 0
    for d in range(dcounts.shape[0]):
        sl = slice(d * rows, d * rows + dcounts[d])
        for kk, m in zip(np.asarray(do["k"])[sl], np.asarray(do["m"])[sl]):
            np.testing.assert_allclose(m, want_m[int(kk)], rtol=1e-6)
            seen += 1
    assert seen == uk.shape[0]


def test_query_groupby_single_mean_distributed(mesh, rng):
    """Query.groupby(..., agg='mean') on a mesh routes through the
    decomposed path (it cannot re-aggregate means directly)."""
    n = 8 * 256
    k = rng.integers(0, 9, size=n, dtype=np.uint32)
    v = rng.integers(0, 50, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))
    out, counts, _ = (Query(t).groupby("k", "v", agg="mean")
                      .run(mesh=mesh))
    counts = np.asarray(counts)
    rows = np.asarray(out["k"]).shape[0] // counts.shape[0]
    uk = np.unique(k)
    want = {int(u): v[k == u].mean() for u in uk}
    seen = 0
    for d in range(counts.shape[0]):
        sl = slice(d * rows, d * rows + counts[d])
        for kk, m in zip(np.asarray(out["k"])[sl],
                         np.asarray(out["v"])[sl]):
            np.testing.assert_allclose(m, want[int(kk)], rtol=1e-6)
            seen += 1
    assert seen == uk.shape[0]


def test_groupby_var_std_single(rng):
    from cuda.radixsort_tpu.ops.aggregate import groupby
    n = 3000
    k = rng.integers(0, 15, size=n).astype(np.uint32)
    v = rng.integers(-30, 30, size=n).astype(np.int32)
    for agg in ("var", "std"):
        gk, gv, cnt = groupby(jnp.asarray(k), jnp.asarray(v), agg=agg)
        cnt = int(cnt)
        uk = np.unique(k)
        assert cnt == uk.shape[0]
        want = np.array([v[k == u].astype(np.float64).var() for u in uk])
        if agg == "std":
            want = np.sqrt(want)
        np.testing.assert_allclose(np.asarray(gv)[:cnt], want,
                                   rtol=1e-4, atol=1e-4)


def test_groupby_multi_var_mixed(rng):
    n = 2000
    a = rng.integers(0, 8, size=n).astype(np.uint32)
    v = rng.integers(0, 50, size=n).astype(np.int32)
    kc, vc, cnt = groupby_multi(
        (jnp.asarray(a),),
        (jnp.asarray(v), jnp.asarray(v), jnp.asarray(v)),
        ("var", "mean", "std"))
    cnt = int(cnt)
    uk = np.unique(a)
    wv = np.array([v[a == u].astype(np.float64).var() for u in uk])
    wm = np.array([v[a == u].mean() for u in uk])
    np.testing.assert_allclose(np.asarray(vc[0])[:cnt], wv, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(vc[1])[:cnt], wm, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(vc[2])[:cnt], np.sqrt(wv),
                               rtol=1e-4)


def test_query_groupby_var_distributed(mesh, rng):
    n = 8 * 400 + 1
    k = rng.integers(0, 19, size=n, dtype=np.uint32)
    v = rng.integers(0, 100, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    def plan(t):
        return Query(t).groupby_agg(["k"], {"vr": ("v", "var"),
                                            "sd": ("v", "std")})

    do, dcounts, _ = plan(t).run(mesh=mesh)
    dcounts = np.asarray(dcounts)
    rows = np.asarray(do["k"]).shape[0] // dcounts.shape[0]
    uk = np.unique(k)
    want = {int(u): v[k == u].astype(np.float64).var() for u in uk}
    seen = 0
    kk, vr, sd = (np.asarray(do["k"]), np.asarray(do["vr"]),
                  np.asarray(do["sd"]))
    for d in range(dcounts.shape[0]):
        for i in range(d * rows, d * rows + dcounts[d]):
            np.testing.assert_allclose(vr[i], want[int(kk[i])],
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(sd[i], np.sqrt(want[int(kk[i])]),
                                       rtol=1e-3, atol=1e-3)
            seen += 1
    assert seen == uk.shape[0]


def test_groupby_quantile_and_median(rng):
    from cuda.radixsort_tpu.ops.aggregate import groupby, groupby_quantile
    n = 3000
    k = rng.integers(0, 12, size=n).astype(np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    gk, qcols, cnt = groupby_quantile(jnp.asarray(k), jnp.asarray(v),
                                      (0.0, 0.25, 0.5, 1.0))
    cnt = int(cnt)
    uk = np.unique(k)
    assert cnt == uk.shape[0]
    np.testing.assert_array_equal(np.asarray(gk)[:cnt], uk)
    for qi, q in enumerate((0.0, 0.25, 0.5, 1.0)):
        want = np.array([np.quantile(v[k == u], q) for u in uk])
        np.testing.assert_allclose(np.asarray(qcols[qi])[:cnt], want,
                                   rtol=1e-5, atol=1e-3)
    mk, mv, mc = groupby(jnp.asarray(k), jnp.asarray(v), agg="median")
    np.testing.assert_allclose(
        np.asarray(mv)[: int(mc)],
        np.array([np.median(v[k == u]) for u in uk]), rtol=1e-6)


def test_groupby_median_valid_mask(rng):
    from cuda.radixsort_tpu.ops.aggregate import groupby
    n = 1200
    k = rng.integers(0, 6, size=n).astype(np.uint32)
    v = rng.integers(0, 500, size=n).astype(np.int32)
    mask = rng.random(n) < 0.5
    gk, gv, cnt = groupby(jnp.asarray(k), jnp.asarray(v), agg="median",
                          valid=jnp.asarray(mask))
    cnt = int(cnt)
    uk = np.unique(k[mask])
    assert cnt == uk.shape[0]
    want = np.array([np.median(v[mask & (k == u)]) for u in uk])
    np.testing.assert_allclose(np.asarray(gv)[:cnt], want, rtol=1e-6)


def test_query_groupby_median_distributed(mesh, rng):
    n = 8 * 350 + 3
    k = rng.integers(0, 14, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))
    out, counts, _ = (Query(t).groupby("k", "v", agg="median")
                      .run(mesh=mesh))
    counts = np.asarray(counts)
    rows = np.asarray(out["k"]).shape[0] // counts.shape[0]
    uk = np.unique(k)
    want = {int(u): np.median(v[k == u]) for u in uk}
    kk, vv = np.asarray(out["k"]), np.asarray(out["v"])
    seen = 0
    for d in range(counts.shape[0]):
        for i in range(d * rows, d * rows + counts[d]):
            np.testing.assert_allclose(vv[i], want[int(kk[i])], rtol=1e-6)
            seen += 1
    assert seen == uk.shape[0]


def test_groupby_quantile_bf16_values(rng):
    """Review fix: quantile INDEX math must run in f32 even when the value
    dtype's mean dtype is low-precision (bf16)."""
    from cuda.radixsort_tpu.ops.aggregate import groupby_quantile
    n = 4000  # one group of 4000 rows: (n-1)*0.5 not representable in bf16
    k = np.zeros(n, np.uint32)
    v = np.arange(n, dtype=np.float32).astype(jnp.bfloat16)
    gk, (m,), cnt = groupby_quantile(jnp.asarray(k), jnp.asarray(v), (0.5,))
    assert int(cnt) == 1
    got = float(np.asarray(m.astype(jnp.float32))[0])
    assert abs(got - (n - 1) / 2) <= 2.0  # bf16 value rounding only


def test_groupby_quantile_composite_keys(rng):
    from cuda.radixsort_tpu.ops.aggregate import groupby_quantile
    n = 2000
    a = rng.integers(0, 4, size=n).astype(np.uint32)
    b = rng.integers(0, 3, size=n).astype(np.uint32)
    v = rng.integers(0, 500, size=n).astype(np.int32)
    (ka, kb), (med,), cnt = groupby_quantile(
        (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(v), (0.5,))
    cnt = int(cnt)
    pairs = sorted(set(zip(a.tolist(), b.tolist())))
    assert cnt == len(pairs)
    for i, (pa, pb) in enumerate(pairs):
        assert (int(np.asarray(ka)[i]), int(np.asarray(kb)[i])) == (pa, pb)
        want = np.median(v[(a == pa) & (b == pb)])
        np.testing.assert_allclose(float(np.asarray(med)[i]), want,
                                   rtol=1e-6)


def test_query_groupby_agg_with_median(mesh, rng):
    n = 8 * 300 + 5
    a = rng.integers(0, 7, size=n).astype(np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(a=jnp.asarray(a), v=jnp.asarray(v))

    def plan(t):
        return Query(t).groupby_agg(
            ["a"], {"s": ("v", "sum"), "md": ("v", "median"),
                    "m": ("v", "mean")})

    so, sc, _ = plan(t).run()
    sc = int(sc)
    uk = np.unique(a)
    assert sc == uk.shape[0]
    for i in range(sc):
        u = int(np.asarray(so["a"])[i])
        assert int(np.asarray(so["s"])[i]) == v[a == u].sum()
        np.testing.assert_allclose(float(np.asarray(so["md"])[i]),
                                   np.median(v[a == u]), rtol=1e-6)
        np.testing.assert_allclose(float(np.asarray(so["m"])[i]),
                                   v[a == u].mean(), rtol=1e-5)

    do, dc, _ = plan(t).run(mesh=mesh)
    dc = np.asarray(dc)
    rows = np.asarray(do["a"]).shape[0] // dc.shape[0]
    seen = 0
    da, ds, dm = (np.asarray(do["a"]), np.asarray(do["s"]),
                  np.asarray(do["md"]))
    for d in range(dc.shape[0]):
        for i in range(d * rows, d * rows + dc[d]):
            u = int(da[i])
            assert int(ds[i]) == v[a == u].sum()
            np.testing.assert_allclose(float(dm[i]), np.median(v[a == u]),
                                       rtol=1e-6)
            seen += 1
    assert seen == uk.shape[0]


def test_query_quantiles_single_and_distributed(mesh, rng):
    n = 8 * 300 + 7
    k = rng.integers(0, 9, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    def plan(t):
        return (Query(t).where(lambda t: t["v"] > 100)
                .quantiles("k", "v", (0.25, 0.5, 0.9)))

    mask = v > 100
    uk = np.unique(k[mask])
    so, sc, _ = plan(t).run()
    sc = int(sc)
    assert sc == uk.shape[0]
    assert "quantiles" in plan(t).explain()
    for i in range(sc):
        u = int(np.asarray(so["k"])[i])
        grp = v[mask & (k == u)]
        for cname, q in (("q25", 0.25), ("q50", 0.5), ("q90", 0.9)):
            np.testing.assert_allclose(float(np.asarray(so[cname])[i]),
                                       np.quantile(grp, q), rtol=1e-5,
                                       atol=1e-3)

    do, dc, _ = plan(t).run(mesh=mesh)
    dc = np.asarray(dc)
    rows = np.asarray(do["k"]).shape[0] // dc.shape[0]
    seen = 0
    kk = np.asarray(do["k"])
    q50 = np.asarray(do["q50"])
    for d in range(dc.shape[0]):
        for i in range(d * rows, d * rows + dc[d]):
            grp = v[mask & (k == int(kk[i]))]
            np.testing.assert_allclose(float(q50[i]), np.median(grp),
                                       rtol=1e-5, atol=1e-3)
            seen += 1
    assert seen == uk.shape[0]


def test_query_quantiles_max_groups_hint_distributed(mesh, rng):
    """The max_groups planner hint routes the distributed quantiles stage
    through histogram refinement (zero row movement) — results must match
    the raw-row-exchange path and the numpy oracle."""
    n = 8 * 300 + 5
    k = rng.integers(0, 11, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    q = (Query(t).where(lambda t: t["v"] > 100)
         .quantiles("k", "v", (0.5, 0.9), max_groups=16))
    assert "max_groups=16" in q.explain()
    do, dc, _ = q.run(mesh=mesh)
    dc = np.asarray(dc)

    mask = v > 100
    uk = np.unique(k[mask])
    rows = np.asarray(do["k"]).shape[0] // dc.shape[0]
    got = {}
    for d in range(dc.shape[0]):
        for i in range(d * rows, d * rows + dc[d]):
            got[int(np.asarray(do["k"])[i])] = (
                float(np.asarray(do["q50"])[i]),
                float(np.asarray(do["q90"])[i]))
    assert sorted(got) == [int(u) for u in uk]
    for u in uk:
        grp = v[mask & (k == u)]
        np.testing.assert_allclose(got[int(u)][0], np.quantile(grp, 0.5),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got[int(u)][1], np.quantile(grp, 0.9),
                                   rtol=1e-5, atol=1e-3)

    # single-chip run ignores the hint but must still be correct
    so, sc, _ = q.run()
    assert int(sc) == uk.shape[0]


def test_query_quantiles_auto_route_no_hint(mesh, rng):
    """With NO max_groups hint, a <=64-group input must
    auto-route to the zero-row-movement refinement path (observable: the
    sharded output is exactly 64 slots per device, not the exchange
    path's row-padded width), and stay correct."""
    n = 8 * 300 + 3
    k = rng.integers(0, 13, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    q = (Query(t).where(lambda t: t["v"] > 100)
         .quantiles("k", "v", (0.5,)))
    do, dc, _ = q.run(mesh=mesh)
    dc = np.asarray(dc)
    ndev = dc.shape[0]
    # refinement path signature: 64 (auto max_groups) slots per shard
    assert np.asarray(do["k"]).shape[0] == 64 * ndev

    mask = v > 100
    uk = np.unique(k[mask])
    assert int(dc.sum()) == uk.shape[0]
    got = {}
    kk, q50 = np.asarray(do["k"]), np.asarray(do["q50"])
    for d in range(ndev):
        for i in range(d * 64, d * 64 + dc[d]):
            got[int(kk[i])] = float(q50[i])
    for u in uk:
        np.testing.assert_allclose(
            got[int(u)], np.quantile(v[mask & (k == u)], 0.5),
            rtol=1e-5, atol=1e-3)


def test_query_quantiles_auto_route_many_groups_falls_back(mesh, rng):
    """>64 distinct source groups: the auto-router must KEEP the whole-row
    exchange (correct at any group count) — no silent 64-group
    truncation."""
    n = 8 * 400
    k = rng.integers(0, 200, size=n, dtype=np.uint32)  # ~200 groups
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    q = Query(t).quantiles("k", "v", (0.5,))
    do, dc, _ = q.run(mesh=mesh)
    dc = np.asarray(dc)
    uk = np.unique(k)
    assert int(dc.sum()) == uk.shape[0]  # every group present
    rows = np.asarray(do["k"]).shape[0] // dc.shape[0]
    assert rows != 64  # exchange path, not the 64-slot refinement layout
    got = {}
    kk, q50 = np.asarray(do["k"]), np.asarray(do["q50"])
    for d in range(dc.shape[0]):
        for i in range(d * rows, d * rows + dc[d]):
            got[int(kk[i])] = float(q50[i])
    for u in uk[::17]:  # spot-check
        np.testing.assert_allclose(
            got[int(u)], np.quantile(v[k == u], 0.5), rtol=1e-5, atol=1e-3)


def test_query_quantiles_auto_route_skips_derived_key(mesh, rng):
    """A key column rewritten by with_column must NOT auto-route (the
    source-column estimate would be invalid) — and must stay correct via
    the exchange path."""
    n = 8 * 200
    k = rng.integers(0, 500, size=n, dtype=np.uint32)
    v = rng.integers(0, 1000, size=n).astype(np.int32)
    t = table(k=jnp.asarray(k), v=jnp.asarray(v))

    # rewrites k to a <=4-group column; source-column estimate (500 groups)
    # is stale, so the router must skip (safe) and exchange
    q = (Query(t).with_column("k", lambda t: t["k"] % jnp.uint32(4))
         .quantiles("k", "v", (0.5,)))
    do, dc, _ = q.run(mesh=mesh)
    dc = np.asarray(dc)
    k4 = k % 4
    uk = np.unique(k4)
    assert int(dc.sum()) == uk.shape[0]
    rows = np.asarray(do["k"]).shape[0] // dc.shape[0]
    assert rows != 64
    got = {}
    kk, q50 = np.asarray(do["k"]), np.asarray(do["q50"])
    for d in range(dc.shape[0]):
        for i in range(d * rows, d * rows + dc[d]):
            got[int(kk[i])] = float(q50[i])
    for u in uk:
        np.testing.assert_allclose(
            got[int(u)], np.quantile(v[k4 == u], 0.5), rtol=1e-5, atol=1e-3)
