"""Algorithmic-scaling asserts on the virtual mesh.

Wall-clock scaling is meaningless on 8 virtual CPU devices sharing one
socket, but the exchange ALGEBRA is not: with per-device rows held fixed
(weak scaling), the wire bytes each device puts on the interconnect must
stay O(rows_per_device) as the mesh grows 2 -> 8 — a hidden O(N_total)
replication would quadruple it. These tests pin that invariant for the
sized sort / groupby / join exchanges, so a four-card measurement
(chip_smoke.py --multichip) can't be ambushed by a scaling bug the CPU
mesh could have caught.

Accounting note: ExchangeStats.wire_bytes is the PADDED-LANE bound
(ndev-1 lanes x cap rows); with a SIZED cap (~ per-lane true max ~
rows_per_device / ndev x slack) the per-device bound is
~ rows_per_device x (ndev-1)/ndev x bytes/row — growing 2 -> 8 devices
by at most (7/8)/(1/2) = 1.75x for a healthy exchange, vs ~7x if a stage
secretly replicated the whole table. The assert bound 2.5x separates the
two regimes with margin for cap rounding (round_cap rounds up to a power
of two).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu.parallel import dsort, shuffle

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")

R = 1 << 12  # rows per device (weak scaling)


def _per_dev_wire(st, ndev):
    wb = np.asarray(st.wire_bytes, np.float64)
    return float(wb.sum()) / ndev


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_sort_exchange_bytes_per_device_weak_scaling():
    per_dev = {}
    for ndev in (2, 8):
        mesh = dsort.make_mesh(ndev)
        keys = jnp.asarray(_keys(ndev * R, 3))
        out, counts, cap, st = dsort.sort_distributed_sized(keys, mesh=mesh)
        assert int(np.asarray(counts).sum()) == ndev * R
        per_dev[ndev] = _per_dev_wire(st, ndev)
    growth = per_dev[8] / per_dev[2]
    assert growth < 2.5, (per_dev, growth)


def test_groupby_exchange_bytes_per_device_weak_scaling():
    per_dev = {}
    for ndev in (2, 8):
        mesh = dsort.make_mesh(ndev)
        rng = np.random.default_rng(4)
        # many groups (~R): partial-aggregate rows scale with groups/device
        keys = jnp.asarray(
            rng.integers(0, R, size=ndev * R, dtype=np.int64).astype(
                np.uint32))
        vals = jnp.asarray(rng.integers(0, 100, size=ndev * R).astype(
            np.int32))
        gk, gv, cnt, cap, st = shuffle.groupby_distributed_sized(
            keys, vals, mesh=mesh, agg="sum")
        per_dev[ndev] = _per_dev_wire(st, ndev)
    growth = per_dev[8] / per_dev[2]
    assert growth < 2.5, (per_dev, growth)


def test_join_exchange_bytes_per_device_weak_scaling():
    per_dev = {}
    for ndev in (2, 8):
        mesh = dsort.make_mesh(ndev)
        rng = np.random.default_rng(5)
        nb = ndev * (R // 4)
        bk = jnp.asarray(
            rng.permutation(np.arange(2 * nb, dtype=np.uint32))[:nb])
        bv = jnp.asarray(rng.integers(0, 1000, size=nb).astype(np.int32))
        pk = jnp.asarray(rng.choice(
            np.arange(2 * nb, dtype=np.uint32), size=ndev * R))
        ok, ov, oi, cnt, caps, st = shuffle.join_distributed_sized(
            bk, bv, pk, mesh=mesh)
        per_dev[ndev] = _per_dev_wire(st, ndev)
    growth = per_dev[8] / per_dev[2]
    assert growth < 2.5, (per_dev, growth)
