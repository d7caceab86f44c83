"""Distributed sort/shuffle tests on the 8-virtual-device CPU mesh (SURVEY §4.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda.radixsort_tpu.parallel import dsort

NDEV = len(jax.devices())


@pytest.fixture(scope="module")
def mesh():
    return dsort.make_mesh(NDEV)


@pytest.mark.parametrize("n", [NDEV, 1024, 10_000, 1 << 16])
def test_uniform_u32(mesh, n):
    rng = np.random.default_rng(n)
    keys = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    out, counts, _st = dsort.sort_distributed(keys, mesh=mesh)
    assert int(np.asarray(counts).sum()) >= n  # sentinels padded input
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(np.asarray(keys)))


def test_skewed_heavy_hitter(mesh):
    # 70% of keys identical — splitter balance must not break correctness.
    rng = np.random.default_rng(7)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xDEADBEEF
    rng.shuffle(keys)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_signed_and_float(mesh):
    rng = np.random.default_rng(3)
    n = 4096
    i32 = rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(i32), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.int32, n)
    np.testing.assert_array_equal(got, np.sort(i32))

    f32 = rng.standard_normal(n).astype(np.float32)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(f32), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.float32, n)
    np.testing.assert_array_equal(got, np.sort(f32))


def test_descending(mesh):
    rng = np.random.default_rng(5)
    n = 4096
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    out, counts, _st = dsort.sort_distributed(
        jnp.asarray(keys), mesh=mesh, descending=True
    )
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n, descending=True)
    np.testing.assert_array_equal(got, np.sort(keys)[::-1])


def test_sized_exchange(mesh):
    # two-phase: cap from the sizing pass is tight and correct
    rng = np.random.default_rng(21)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    out, counts, cap, _st = dsort.sort_distributed_sized(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    s = n // NDEV
    assert cap < s  # balanced data: sized cap beats the default full-shard cap
    assert cap >= int(np.asarray(counts).max()) // NDEV  # sanity: covers lanes


def test_sized_exchange_skewed(mesh):
    # heavy hitter: one bucket holds 70% of keys -> cap must grow to fit it
    rng = np.random.default_rng(22)
    n = 1 << 13
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xDEADBEEF
    rng.shuffle(keys)
    out, counts, cap, _st = dsort.sort_distributed_sized(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


# ---------------------------------------------------------------------------
# adversarial tests: sentinel-valued keys must
# survive the exchange, and a heavy single key must spread across devices.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1 << 12, 10_000])
def test_sentinel_keys_survive(mesh, n):
    # many keys equal u32 max (== the pad fill value) — all must survive
    rng = np.random.default_rng(33)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[:: 7] = 0xFFFFFFFF
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n  # exact count, no sentinel loss
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_i32_max_and_nan_patterns(mesh):
    rng = np.random.default_rng(34)
    n = 4096
    i32 = rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)
    i32[: 64] = np.iinfo(np.int32).max  # twiddles to 0xFFFFFFFF
    out, counts, _st = dsort.sort_distributed(jnp.asarray(i32), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n
    got = dsort.reconstruct_sorted(out, counts, jnp.int32, n)
    np.testing.assert_array_equal(got, np.sort(i32))

    # +NaN with all-ones payload bits twiddles to 0xFFFFFFFF
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[: 64] = np.frombuffer(
        np.uint32(0x7FFFFFFF).tobytes(), dtype=np.float32
    )[0]
    out, counts, _st = dsort.sort_distributed(jnp.asarray(f32), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.float32, n)
    np.testing.assert_array_equal(got, np.sort(f32))


@pytest.mark.parametrize("n", [NDEV * 100 + 3, (1 << 13) - 1])
def test_non_divisible_n(mesh, n):
    rng = np.random.default_rng(35)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: 5] = 0xFFFFFFFF  # padding shares the value; counts must not conflate
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_heavy_hitter_balance(mesh):
    # one key = 70% of mass: per-device row counts must stay within 2x of
    # the mean (round-1 behavior: the whole key landed on one device)
    rng = np.random.default_rng(36)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xDEADBEEF
    rng.shuffle(keys)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    c = np.asarray(counts).astype(np.float64)
    assert c.max() / c.mean() <= 2.0, c
    # stats pytree agrees with the observed balance
    assert float(_st.skew) <= 2.0
    np.testing.assert_array_equal(np.asarray(_st.rows_out), np.asarray(counts))
    assert int(np.asarray(_st.rows_in).sum()) == n
    assert 0.0 < float(_st.cap_utilization) <= 1.0


def test_heavy_hitter_pair_balance(mesh):
    # two heavy keys in DIFFERENT buckets (40% + 40%) + stragglers
    rng = np.random.default_rng(37)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.4 * n)] = 0x10000001
    keys[int(0.4 * n): int(0.8 * n)] = 0xF0000001
    rng.shuffle(keys)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    c = np.asarray(counts).astype(np.float64)
    assert c.max() / c.mean() <= 2.0, c


def test_heavy_hitter_with_bucket_stragglers(mesh):
    # heavy key shares its top-16-bit bucket with LARGER straggler keys:
    # spreading must keep the global order (interval routing of stragglers)
    rng = np.random.default_rng(38)
    n = 1 << 13
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xDEAD0001
    # stragglers in the same 0xDEAD**** bucket, above and below the heavy key
    keys[int(0.7 * n): int(0.7 * n) + 32] = 0xDEAD0000
    keys[int(0.7 * n) + 32: int(0.7 * n) + 64] = 0xDEADFFFF
    rng.shuffle(keys)
    out, counts, _st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("rounds", [2, 4])
def test_round_based_exchange(mesh, rounds):
    # double-buffered exchange rounds: same result, any round count
    rng = np.random.default_rng(60 + rounds)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[:: 11] = 0xFFFFFFFF
    out, counts, st = dsort.sort_distributed(
        jnp.asarray(keys), mesh=mesh, rounds=rounds)
    assert int(np.asarray(counts).sum()) == n
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_default_routed_rounds_engage(mesh, monkeypatch):
    """sort_distributed picks rounds>1 ITSELF once a send
    lane crosses the threshold — here lowered so a CPU-sized sort lands on
    the double-buffered path without an explicit rounds argument."""
    monkeypatch.setenv("RS_EXCHANGE_ROUNDS_LANE_BYTES", "1024")
    assert dsort.resolve_rounds(1 << 12) == 2   # 16 KB lane > 1 KB
    assert dsort.resolve_rounds(64) == 1
    jax.clear_caches()  # env is read at trace time — drop stale traces
    rng = np.random.default_rng(61)
    n = 1 << 14                                  # lane = 2^11 rows = 8 KB
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[:: 11] = 0xFFFFFFFF
    out, counts, st = dsort.sort_distributed(jnp.asarray(keys), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_round_based_exchange_sized_skewed(mesh):
    rng = np.random.default_rng(65)
    n = (1 << 14) - 5
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: n // 2] = 0x1234ABCD
    rng.shuffle(keys)
    cap = dsort.round_cap(int(dsort.exchange_cap_for_sort(
        jnp.asarray(keys), mesh=mesh)))
    out, counts, st = dsort.sort_distributed(
        jnp.asarray(keys), mesh=mesh, cap=cap, rounds=4)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_pairs_distributed_stable(mesh):
    rng = np.random.default_rng(70)
    n = (1 << 13) - 3
    keys = rng.integers(0, 64, size=n).astype(np.uint32)  # duplicate-heavy
    keys[:: 9] = 0xFFFFFFFF
    vals = np.arange(n, dtype=np.int32)
    ok, ov, counts, st = dsort.sort_pairs_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh)
    assert int(np.asarray(counts).sum()) == n
    ok, ov, c = np.asarray(ok), np.asarray(ov), np.asarray(counts)
    per = ok.shape[0] // NDEV
    gk = np.concatenate([ok[d*per:d*per+c[d]] for d in range(NDEV)])
    gv = np.concatenate([ov[d*per:d*per+c[d]] for d in range(NDEV)])
    o = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[o])
    np.testing.assert_array_equal(gv, vals[o])


def test_sort_pairs_distributed_heavy_key_stable(mesh):
    # 70%-mass key: spread across devices must preserve payload order
    rng = np.random.default_rng(71)
    n = 1 << 13
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xCAFEBABE
    rng.shuffle(keys)
    vals = np.arange(n, dtype=np.int32)
    ok, ov, counts, st = dsort.sort_pairs_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh)
    ok, ov, c = np.asarray(ok), np.asarray(ov), np.asarray(counts)
    per = ok.shape[0] // NDEV
    gk = np.concatenate([ok[d*per:d*per+c[d]] for d in range(NDEV)])
    gv = np.concatenate([ov[d*per:d*per+c[d]] for d in range(NDEV)])
    o = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[o])
    np.testing.assert_array_equal(gv, vals[o])
    assert c.max() / c.mean() <= 2.0


def test_sort_pairs_distributed_descending(mesh):
    rng = np.random.default_rng(72)
    n = 1 << 12
    keys = rng.integers(0, 32, size=n).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    ok, ov, counts, st = dsort.sort_pairs_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, descending=True)
    ok, ov, c = np.asarray(ok), np.asarray(ov), np.asarray(counts)
    per = ok.shape[0] // NDEV
    gk = np.concatenate([ok[d*per:d*per+c[d]] for d in range(NDEV)])
    gv = np.concatenate([ov[d*per:d*per+c[d]] for d in range(NDEV)])
    o = np.argsort(-keys.astype(np.int64), kind="stable")
    np.testing.assert_array_equal(gk, keys[o])
    np.testing.assert_array_equal(gv, vals[o])


# ------------------------------------------------- hierarchical (host x chip)


@pytest.fixture(scope="module")
def mesh2d():
    return dsort.make_mesh_2d(2, NDEV // 2)


@pytest.mark.parametrize("n", [1024, (1 << 14) - 7])
def test_hier_sort_u32(mesh2d, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[:: 11] = 0xFFFFFFFF  # sentinel-valued real keys must survive
    out, counts, (st1, st2) = dsort.sort_distributed_hier(
        jnp.asarray(keys), mesh=mesh2d)
    assert int(np.asarray(counts).sum()) == n
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    # stage-1 wire bytes are per-host lanes; rows conserved end to end
    assert int(np.asarray(st2.rows_out).sum()) == n


def test_hier_sort_matches_flat_tuple_axis(mesh2d):
    # flattened sort over the SAME 2D mesh via a tuple axis — the layout
    # contract says both orders agree (host-major linearization)
    rng = np.random.default_rng(81)
    n = (1 << 13) - 3
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    out_f, counts_f, _ = dsort.sort_distributed(
        jnp.asarray(keys), mesh=mesh2d, axis_name=("host", "chip"))
    got_f = dsort.reconstruct_sorted(out_f, counts_f, jnp.uint32, n)
    out_h, counts_h, _ = dsort.sort_distributed_hier(
        jnp.asarray(keys), mesh=mesh2d)
    got_h = dsort.reconstruct_sorted(out_h, counts_h, jnp.uint32, n)
    np.testing.assert_array_equal(got_f, np.sort(keys))
    np.testing.assert_array_equal(got_h, got_f)


def test_hier_sort_descending_f32(mesh2d):
    rng = np.random.default_rng(82)
    n = 4096
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[: 32] = -0.0
    out, counts, _ = dsort.sort_distributed_hier(
        jnp.asarray(f32), mesh=mesh2d, descending=True)
    got = dsort.reconstruct_sorted(out, counts, jnp.float32, n,
                                   descending=True)
    np.testing.assert_array_equal(got, np.sort(f32)[::-1])


def test_hier_sort_skewed_balance(mesh2d):
    # 70%-mass key must spread across the full 8-device mesh, not one host
    rng = np.random.default_rng(83)
    n = 1 << 14
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: int(0.7 * n)] = 0xBEEFCAFE
    rng.shuffle(keys)
    out, counts, _ = dsort.sort_distributed_hier(jnp.asarray(keys),
                                                 mesh=mesh2d)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    c = np.asarray(counts)
    assert c.max() / c.mean() <= 2.0


def test_groupby_distributed_tuple_axis(mesh2d):
    from cuda.radixsort_tpu.parallel import shuffle

    rng = np.random.default_rng(84)
    n = (1 << 12) - 9
    keys = rng.integers(0, 100, size=n).astype(np.uint32)
    vals = rng.integers(0, 1000, size=n).astype(np.int32)
    uk, uv, counts, _ = shuffle.groupby_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh2d,
        axis_name=("host", "chip"), agg="sum")
    uk, uv, c = np.asarray(uk), np.asarray(uv), np.asarray(counts)
    per = uk.shape[0] // NDEV
    gk = np.concatenate([uk[d*per:d*per+c[d]] for d in range(NDEV)])
    gv = np.concatenate([uv[d*per:d*per+c[d]] for d in range(NDEV)])
    want_k = np.unique(keys)
    want_v = np.array([vals[keys == k].sum() for k in want_k], np.int64)
    order = np.argsort(gk, kind="stable")
    np.testing.assert_array_equal(np.sort(gk), want_k)
    np.testing.assert_array_equal(gv[order].astype(np.int64), want_v)


def test_exchange_rounds_default_routing():
    """The double-buffered exchange engages itself at >4 MB send lanes
    (BASELINE.json:5,11)."""
    from cuda.radixsort_tpu.parallel import dsort
    assert dsort.resolve_rounds((4 * 1024 * 1024) // 4 + 1) == 2
    assert dsort.resolve_rounds((4 * 1024 * 1024) // 4) == 1
