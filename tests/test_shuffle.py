"""Distributed shuffle / join / aggregate tests on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda.radixsort_tpu.parallel import dsort, shuffle

NDEV = len(jax.devices())


@pytest.fixture(scope="module")
def mesh():
    return dsort.make_mesh(NDEV)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_distributed_zipf(mesh, agg):
    rng = np.random.default_rng(11)
    n = NDEV * 4096
    # Zipf-skewed keys: one key takes ~60% of rows
    keys = np.where(rng.random(n) < 0.6, 42,
                    rng.integers(0, 300, size=n)).astype(np.uint32)
    vals = rng.integers(-500, 500, size=n).astype(np.int32)

    gk, gv, cnt, _st = shuffle.groupby_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, agg=agg
    )
    gk, gv, cnt = np.asarray(gk), np.asarray(gv), np.asarray(cnt)
    per = gk.shape[0] // NDEV
    got = {}
    for d in range(NDEV):
        c = cnt[d]
        for k, v in zip(gk[d * per : d * per + c], gv[d * per : d * per + c]):
            assert k not in got, "group appears on two devices"
            got[int(k)] = int(v)

    uniq = np.unique(keys)
    assert len(got) == len(uniq)
    for k in uniq:
        sel = vals[keys == k]
        want = {"sum": sel.sum(), "count": len(sel),
                "min": sel.min(), "max": sel.max()}[agg]
        assert got[int(k)] == want, (agg, k)


def test_join_distributed_broadcast(mesh):
    rng = np.random.default_rng(12)
    nb, npr = NDEV * 128, NDEV * 4096
    bk = rng.permutation(np.arange(4 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(4 * nb, dtype=np.uint32), size=npr)
    lut = dict(zip(bk.tolist(), bv.tolist()))

    ok, ov, oi, cnt, _st = shuffle.join_distributed_broadcast(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh
    )
    ok, ov, oi, cnt = [np.asarray(x) for x in (ok, ov, oi, cnt)]
    per = ok.shape[0] // NDEV
    got = []
    for d in range(NDEV):
        c = cnt[d]
        for k, v, i in zip(ok[d*per:d*per+c], ov[d*per:d*per+c], oi[d*per:d*per+c]):
            assert pk[i] == k  # probe_idx is the GLOBAL probe row
            got.append((int(k), int(v), int(i)))
    want = [(int(k), lut[int(k)], i) for i, k in enumerate(pk) if int(k) in lut]
    assert sorted(got) == sorted(want)


def test_exchange_rows_basic(mesh):
    """Rows land on their dest device, in (src, order) order, none lost."""
    rng = np.random.default_rng(13)
    n = NDEV * 512
    data = rng.integers(0, 2**31, size=n).astype(np.int32)
    dest = rng.integers(0, NDEV, size=n).astype(np.int32)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def fn(d, x):
        (rx,), v = shuffle.exchange_rows(
            [x.reshape(-1)], d.reshape(-1), NDEV, "x", 512
        )
        return rx.reshape(1, -1), v.reshape(1, -1)

    rx, v = jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x"))
    ))(jnp.asarray(dest), jnp.asarray(data))
    rx, v = np.asarray(rx).reshape(NDEV, -1), np.asarray(v).reshape(NDEV, -1)
    received = []
    for d in range(NDEV):
        received.extend(rx[d][v[d]].tolist())
        # every valid row on device d was destined for d
        srcs = np.nonzero(v[d])[0]
    assert sorted(received) == sorted(data.tolist())
    for d in range(NDEV):
        want = np.concatenate(
            [data[s * 512:(s + 1) * 512][dest[s * 512:(s + 1) * 512] == d]
             for s in range(NDEV)]
        )
        np.testing.assert_array_equal(rx[d][v[d]], want)


def test_groupby_distributed_sized(mesh):
    rng = np.random.default_rng(23)
    n = NDEV * 4096
    keys = np.where(rng.random(n) < 0.6, 42,
                    rng.integers(0, 300, size=n)).astype(np.uint32)
    vals = rng.integers(-500, 500, size=n).astype(np.int32)
    gk, gv, cnt, cap, _st = shuffle.groupby_distributed_sized(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, agg="sum")
    assert cap < n // NDEV  # ~300 distinct keys: far below the default cap
    gk, gv, cnt = np.asarray(gk), np.asarray(gv), np.asarray(cnt)
    per = gk.shape[0] // NDEV
    got = {}
    for d in range(NDEV):
        for k, v in zip(gk[d * per : d * per + cnt[d]],
                        gv[d * per : d * per + cnt[d]]):
            got[int(k)] = int(v)
    for k in np.unique(keys):
        assert got[int(k)] == vals[keys == k].sum()


# ---------------------------------------------------------------------------
# adversarial groupby tests: no reserved key values,
# no divisibility restriction.
# ---------------------------------------------------------------------------


def _check_groupby(mesh, keys, vals, agg):
    gk, gv, cnt, _st = shuffle.groupby_distributed(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, agg=agg
    )
    gk, gv, cnt = np.asarray(gk), np.asarray(gv), np.asarray(cnt)
    per = gk.shape[0] // NDEV
    got = {}
    for d in range(NDEV):
        c = cnt[d]
        for k, v in zip(gk[d * per: d * per + c], gv[d * per: d * per + c]):
            assert k not in got, "group appears on two devices"
            got[int(k)] = int(v)
    uniq = np.unique(keys)
    assert len(got) == len(uniq)
    for k in uniq:
        sel = vals[keys == k]
        want = {"sum": sel.sum(), "count": len(sel),
                "min": sel.min(), "max": sel.max()}[agg]
        assert got[int(k)] == want, (agg, k)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_max_key_not_reserved(mesh, agg):
    # key 0xFFFFFFFF is a REAL group and must survive with exact aggregates
    rng = np.random.default_rng(44)
    n = NDEV * 1024
    keys = rng.integers(0, 50, size=n).astype(np.uint32)
    keys[:: 5] = 0xFFFFFFFF
    vals = rng.integers(-500, 500, size=n).astype(np.int32)
    _check_groupby(mesh, keys, vals, agg)


@pytest.mark.parametrize("n", [NDEV * 300 + 1, NDEV * 1024 - 3, 17])
def test_groupby_non_divisible(mesh, n):
    rng = np.random.default_rng(45)
    keys = rng.integers(0, 40, size=n).astype(np.uint32)
    vals = rng.integers(-500, 500, size=n).astype(np.int32)
    _check_groupby(mesh, keys, vals, "sum")
    _check_groupby(mesh, keys, vals, "count")


def test_groupby_non_divisible_sized(mesh):
    rng = np.random.default_rng(46)
    n = NDEV * 500 + 7
    keys = rng.integers(0, 64, size=n).astype(np.uint32)
    keys[: 9] = 0xFFFFFFFF
    vals = rng.integers(-500, 500, size=n).astype(np.int32)
    gk, gv, cnt, cap, _st = shuffle.groupby_distributed_sized(
        jnp.asarray(keys), jnp.asarray(vals), mesh=mesh, agg="min")
    gk, gv, cnt = np.asarray(gk), np.asarray(gv), np.asarray(cnt)
    per = gk.shape[0] // NDEV
    got = {}
    for d in range(NDEV):
        for k, v in zip(gk[d*per:d*per+cnt[d]], gv[d*per:d*per+cnt[d]]):
            got[int(k)] = int(v)
    for k in np.unique(keys):
        assert got[int(k)] == vals[keys == k].min()


# ---------------------------------------------------------------------------
# hash-exchange distributed join
# ---------------------------------------------------------------------------


def _join_oracle(bk, bv, pk):
    lut = dict(zip(bk.tolist(), bv.tolist()))
    return sorted(
        (int(k), lut[int(k)], i) for i, k in enumerate(pk) if int(k) in lut
    )


def _collect_join(ok, ov, oi, cnt, pk):
    ok, ov, oi, cnt = [np.asarray(x) for x in (ok, ov, oi, cnt)]
    per = ok.shape[0] // NDEV
    got = []
    for d in range(NDEV):
        c = cnt[d]
        for k, v, i in zip(ok[d*per:d*per+c], ov[d*per:d*per+c],
                           oi[d*per:d*per+c]):
            assert pk[i] == k
            got.append((int(k), int(v), int(i)))
    return sorted(got)


@pytest.mark.parametrize("nb,npr", [(NDEV * 256, NDEV * 2048),
                                    (NDEV * 256 + 5, NDEV * 2048 - 7)])
def test_join_distributed_hash(mesh, nb, npr):
    rng = np.random.default_rng(55)
    bk = rng.permutation(np.arange(4 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(4 * nb, dtype=np.uint32), size=npr)
    ok, ov, oi, cnt, _st = shuffle.join_distributed_hash(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh)
    assert _collect_join(ok, ov, oi, cnt, pk) == _join_oracle(bk, bv, pk)


def test_join_distributed_hash_skewed_probe(mesh):
    # Zipf probe: one key is 60% of probes; output rows stay key-partitioned
    rng = np.random.default_rng(56)
    nb, npr = NDEV * 128, NDEV * 2048
    bk = rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    hot = bk[17]
    pk = np.where(rng.random(npr) < 0.6, hot,
                  rng.choice(np.arange(2 * nb, dtype=np.uint32), size=npr))
    pk = pk.astype(np.uint32)
    ok, ov, oi, cnt, _st = shuffle.join_distributed_hash(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh)
    assert _collect_join(ok, ov, oi, cnt, pk) == _join_oracle(bk, bv, pk)


def test_join_distributed_hash_duplicate_builds(mesh):
    # duplicate build keys resolve to the LAST duplicate (local join contract)
    rng = np.random.default_rng(57)
    nb, npr = NDEV * 64, NDEV * 512
    bk = rng.integers(0, 100, size=nb).astype(np.uint32)
    bv = np.arange(nb, dtype=np.int32)
    pk = rng.integers(0, 200, size=npr).astype(np.uint32)
    ok, ov, oi, cnt, _st = shuffle.join_distributed_hash(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh)
    lut = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        lut[k] = v  # last duplicate wins
    want = sorted((int(k), lut[int(k)], i)
                  for i, k in enumerate(pk) if int(k) in lut)
    assert _collect_join(ok, ov, oi, cnt, pk) == want


def test_join_distributed_sized(mesh):
    rng = np.random.default_rng(58)
    nb, npr = NDEV * 256, NDEV * 1024 + 13
    bk = rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(2 * nb, dtype=np.uint32), size=npr)
    ok, ov, oi, cnt, (bcap, pcap), _st = shuffle.join_distributed_sized(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh)
    assert _collect_join(ok, ov, oi, cnt, pk) == _join_oracle(bk, bv, pk)
    # balanced hash: caps well below the ndev*shard worst case
    assert bcap <= 2 * (nb // NDEV) and pcap <= 2 * (npr // NDEV)


def test_join_distributed_router(mesh):
    rng = np.random.default_rng(59)
    nb, npr = NDEV * 128, NDEV * 1024
    bk = rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(2 * nb, dtype=np.uint32), size=npr)
    want = _join_oracle(bk, bv, pk)
    for thresh in (0, 10**9):  # force hash path, then broadcast path
        ok, ov, oi, cnt, _st = shuffle.join_distributed(
            jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=mesh,
            broadcast_threshold=thresh)
        assert _collect_join(ok, ov, oi, cnt, pk) == want

def test_exchange_rows_undersized_cap_is_loud(mesh):
    """A cap below the true per-destination send count must NOT silently
    drop the overflow rows: the received validity is
    poisoned to all-False mesh-wide, so the failure is obvious."""
    rng = np.random.default_rng(7)
    n = NDEV * 64
    data = rng.integers(0, 2**31, size=n).astype(np.int32)
    dest = np.zeros(n, np.int32)  # everything to device 0: count=64 > cap=16

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def fn(d, x):
        (rx,), v = shuffle.exchange_rows(
            [x.reshape(-1)], d.reshape(-1), NDEV, "x", 16
        )
        return rx.reshape(1, -1), v.reshape(1, -1)

    rx, v = jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x"))
    ))(jnp.asarray(dest), jnp.asarray(data))
    assert not np.asarray(v).any()


def test_describe_flags_overflow():
    from cuda.radixsort_tpu.parallel.stats import ExchangeStats, describe

    st = ExchangeStats(
        rows_in=jnp.asarray([10], jnp.int32),
        rows_out=jnp.asarray([10], jnp.int32),
        wire_bytes=jnp.asarray([1e10], jnp.float32),  # > int32 range
        cap=jnp.asarray(4, jnp.int32),
        cap_utilization=jnp.asarray(2.5, jnp.float32),
        skew=jnp.asarray(1.0, jnp.float32),
    )
    s = describe(st)
    assert "OVERFLOW" in s and "wire_MB=10000" in s
