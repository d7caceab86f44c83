"""Distributed all-to-all shuffle + distributed join/aggregate (BASELINE.json:5,9,10).

The shuffle generalizes dsort.py's key exchange to arbitrary column sets:
rows are routed to owner devices by bucket id (usually a key hash), via ONE
padded all_to_all per column batch, with counts exchanged alongside. Skew
strategy, per operator:

  * aggregate: LOCAL partial aggregation BEFORE the exchange — a heavy key
    collapses to one partial row per device, so Zipf skew cannot unbalance
    the exchange (the repartitioning demanded by BASELINE.json:10 becomes
    unnecessary by construction);
  * join: when the build side is small (the FK-join benchmark shape),
    BROADCAST it (all_gather) and never move the probe side — heavy probe
    keys stay put; otherwise hash-exchange both sides.

All collectives ride `jax.lax` (psum/all_gather/all_to_all) inside
shard_map, so XLA schedules them asynchronously against compute (the
exchange/compute overlap of BASELINE.json:11 is XLA's async collectives —
measured in bench, not hand-scheduled).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.aggregate import groupby as local_groupby
from cuda.radixsort_tpu.ops.join import join as local_join
from cuda.radixsort_tpu.ops.partition import hash32
from cuda.radixsort_tpu.parallel import stats as stats_lib
from cuda.radixsort_tpu.parallel.dsort import axis_size


def exchange_rows(columns, dest, ndev: int, axis_name: str, cap: int):
    """Route each local row to device dest[row]. columns: list of (S,) arrays.

    Returns (received_columns, valid_mask): each (ndev*cap,) with rows from
    source device d in slice [d*cap, (d+1)*cap) and valid_mask marking real
    rows. Rows keep (source device, original order) — deterministic.

    cap must cover every send lane (the sized protocols measure it
    exactly). If any source's per-destination count exceeds cap, the
    overflow is LOUD, not a silent row drop: the
    received validity is poisoned to all-False mesh-wide (one scalar psum)
    so downstream results are obviously empty rather than subtly short,
    and ExchangeStats reports util > 1.0 (describe() prints OVERFLOW).
    """
    s = dest.shape[0]
    pos = jnp.arange(s, dtype=jnp.uint32)
    dsorted, order = jax.lax.sort(
        [dest.astype(jnp.uint32), pos], num_keys=2, is_stable=False, dimension=0
    )
    order = order.astype(jnp.int32)
    # per-dest counts via searchsorted on the sorted dests (no scatter-add);
    # rows with dest >= ndev (invalid/masked) sort last and are excluded
    bounds = jnp.searchsorted(
        dsorted, jnp.arange(ndev + 1, dtype=dsorted.dtype), side="left"
    ).astype(jnp.int32)
    counts = jnp.diff(bounds)
    seg = bounds[:-1]
    idx = seg[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
    gidx = jnp.where(valid, jnp.clip(idx, 0, s - 1), 0).reshape(-1)

    maxc = jnp.max(counts)
    over_any = jax.lax.psum((maxc > cap).astype(jnp.int32), axis_name) > 0

    recv_valid = jax.lax.all_to_all(
        valid.reshape(ndev, cap), axis_name, split_axis=0, concat_axis=0
    ).reshape(-1)
    recv_valid = recv_valid & jnp.logical_not(over_any)
    out = []
    for c in columns:
        send = jnp.where(
            valid.reshape(-1), jnp.take(jnp.take(c, order, axis=0), gidx, axis=0),
            jnp.zeros((), c.dtype),
        ).reshape(ndev, cap)
        recv = jax.lax.all_to_all(send, axis_name, split_axis=0, concat_axis=0)
        out.append(recv.reshape(-1))
    return out, recv_valid


def _owner_of_keys(keys, ndev: int):
    return (hash32(keys) % jnp.uint32(ndev)).astype(jnp.int32)


def _owner_of_key_tuple(cols, ndev: int):
    """Hash owner of a COMPOSITE key: xor-chain the per-column mixes.
    The single shared definition — every distributed op that localizes by
    key tuple must route identically or rows of one group land on
    different devices."""
    cols = list(cols)
    h = hash32(cols[0])
    for c in cols[1:]:
        h = hash32(c.astype(jnp.uint32) ^ h)
    return (h % jnp.uint32(ndev)).astype(jnp.int32)


def _agg_identity(agg: str, dtype):
    """Neutral element of the aggregation — rows carrying it never change a
    group's result, which is how padding/invalid rows are neutralized."""
    if agg == "min":
        return jnp.array(
            jnp.iinfo(dtype).max if jnp.issubdtype(dtype, jnp.integer)
            else jnp.inf, dtype)
    if agg == "max":
        return jnp.array(
            jnp.iinfo(dtype).min if jnp.issubdtype(dtype, jnp.integer)
            else -jnp.inf, dtype)
    return jnp.zeros((), dtype)


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "agg", "cap", "config")
)
def groupby_distributed(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    agg: str = "sum",
    cap: int | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Distributed group-by over sharded rows. Two-phase: local partial
    aggregate -> hash exchange of partials -> local final aggregate.

    Returns (group_keys, aggregates, count, stats) per shard, concatenated
    over the mesh axis: device d holds the groups whose key-hash routes to d;
    rows [0, count_d) of its slice are valid. stats.rows_in counts the
    PARTIAL group rows entering the exchange (raw rows never move — that is
    the point of the two-phase design).
    """
    if agg not in ("sum", "count", "min", "max"):
        raise ValueError(agg)
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("groupby_distributed needs at least one row")
    # count == sum of ones: lets padding rows carry the identity (0)
    if agg == "count":
        values = jnp.ones((n,), jnp.int32)
        agg = "sum"
    s = -(-n // ndev)
    pad = s * ndev - n
    ident = _agg_identity(agg, values.dtype)
    if pad:
        # pad rows reuse a REAL key with the identity value — they merge
        # into an existing group and change nothing (no reserved key values,
        # no divisibility restriction)
        keys = jnp.concatenate([keys, jnp.broadcast_to(keys[:1], (pad,))])
        values = jnp.concatenate([values, jnp.full((pad,), ident, values.dtype)])
    # partials per device <= distinct keys, capped by shard size; heavy keys
    # collapse locally so cap = local shard size is always enough.
    ccap = cap or s

    def shard_fn(k, v):
        k, v = k.reshape(-1), v.reshape(-1)
        gk, gv, cnt = local_groupby(k, v, agg=agg, config=config)
        valid0 = jnp.arange(gk.shape[0]) < cnt
        # invalid tail rows route to dest=ndev: they sort last in the
        # exchange and are never picked up (counts exclude them)
        dest = jnp.where(valid0, _owner_of_keys(gk, ndev), ndev)
        (rk, rv), rvalid = exchange_rows([gk, gv], dest, ndev, axis_name, ccap)
        # second phase: aggregate received partials. Invalid fill rows get
        # (max key, identity value): they group last and contribute nothing.
        # A REAL key 0xFFFFFFFF lands in the same group — its aggregate is
        # still correct (fills are identities), so the group is dropped only
        # when it holds no real max-key row.
        sent = jnp.uint32(0xFFFFFFFF)
        rku = rk.astype(jnp.uint32)
        k2 = jnp.where(rvalid, rku, sent)
        rv = jnp.where(rvalid, rv, ident)
        g2k, g2v, c2 = local_groupby(k2, rv, agg=agg, config=config)
        has_invalid = jnp.any(~rvalid)
        has_real_max = jnp.any(rvalid & (rku == sent))
        c2 = c2 - jnp.where(has_invalid & ~has_real_max, 1, 0)
        send_counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(
            1, mode="drop")
        st = stats_lib.shard_stats(
            send_counts, c2, ccap, ndev, axis_name,
            bytes_per_row=4 + values.dtype.itemsize)
        return g2k.reshape(1, -1), g2v.reshape(1, -1), c2.reshape(1, 1), st

    gk, gv, cnt, st = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name),
                   stats_lib.stats_out_specs(axis_name)),
        check_vma=False,
    )(keys, values)
    return gk.reshape(-1), gv.reshape(-1), cnt.reshape(-1), st


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "agg", "config")
)
def groupby_exchange_cap(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    agg: str = "sum",
    config: config_lib.SortConfig | None = None,
) -> jnp.ndarray:
    """Phase one of the sized groupby exchange: exact max number of partial
    rows any device sends to any other (see dsort.sort_distributed_sized for
    the protocol rationale)."""
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    if n == 0:
        raise ValueError("groupby_exchange_cap needs at least one row")
    if agg == "count":
        values = jnp.ones((n,), jnp.int32)
        agg = "sum"
    s = -(-n // ndev)
    pad = s * ndev - n
    if pad:  # mirror groupby_distributed's padding so the cap is exact
        keys = jnp.concatenate([keys, jnp.broadcast_to(keys[:1], (pad,))])
        values = jnp.concatenate(
            [values, jnp.full((pad,), _agg_identity(agg, values.dtype),
                              values.dtype)])

    def shard_fn(k, v):
        k, v = k.reshape(-1), v.reshape(-1)
        gk, _, cnt = local_groupby(k, v, agg=agg, config=config)
        valid0 = jnp.arange(gk.shape[0]) < cnt
        dest = jnp.where(valid0, _owner_of_keys(gk, ndev), ndev)
        counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(1, mode="drop")
        return jax.lax.pmax(jnp.max(counts), axis_name)

    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(),
        check_vma=False,
    )(keys, values)


def groupby_distributed_sized(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    agg: str = "sum",
    config: config_lib.SortConfig | None = None,
):
    """Two-phase sized distributed groupby: measure the partials exchange,
    then run groupby_distributed with the tight static cap (rounded to a
    power of two — bounded compile variants). Host-level wrapper; returns
    (group_keys, aggregates, counts, cap, stats)."""
    from cuda.radixsort_tpu.parallel.dsort import round_cap

    cap = round_cap(int(groupby_exchange_cap(
        keys, values, mesh=mesh, axis_name=axis_name, agg=agg, config=config)))
    gk, gv, cnt, st = groupby_distributed(
        keys, values, mesh=mesh, axis_name=axis_name, agg=agg, cap=cap,
        config=config)
    return gk, gv, cnt, cap, st


def _pad_to(x, size, fill=0):
    pad = size - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])


def _shard_valid(n: int, s: int, axis_name: str) -> jnp.ndarray:
    d = jax.lax.axis_index(axis_name)
    return d.astype(jnp.int32) * s + jnp.arange(s, dtype=jnp.int32) < n


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "config")
)
def join_distributed_broadcast(
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    config: config_lib.SortConfig | None = None,
):
    """FK inner join with a broadcast build side: all_gather the (small)
    build table, join locally against the resident probe shard. Probe-side
    skew is irrelevant (no probe movement); scaling is limited only by the
    build broadcast (all_gather).

    Returns per-shard (keys, vals, probe_idx (GLOBAL probe row), count,
    stats) concatenated over the mesh axis. Row counts need not divide the
    mesh.
    """
    ndev = axis_size(mesh, axis_name)
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    sb, sp = -(-nb // ndev), -(-npr // ndev)
    build_keys = _pad_to(build_keys, sb * ndev)
    build_vals = _pad_to(build_vals, sb * ndev)
    probe_keys = _pad_to(probe_keys, sp * ndev)

    def shard_fn(bk, bv, pk):
        bvalid = _shard_valid(nb, sb, axis_name)
        bk_full = jax.lax.all_gather(bk.reshape(-1), axis_name, tiled=True)
        bv_full = jax.lax.all_gather(bv.reshape(-1), axis_name, tiled=True)
        bvalid_full = jax.lax.all_gather(bvalid, axis_name, tiled=True)
        pvalid = _shard_valid(npr, sp, axis_name)
        ok, ov, oi, cnt = local_join(
            bk_full, bv_full, pk.reshape(-1), how="inner",
            build_valid=bvalid_full, probe_valid=pvalid, config=config
        )
        d = jax.lax.axis_index(axis_name).astype(jnp.int32)
        og = d * sp + oi  # local -> global probe row
        # broadcast wire cost: this shard's build slice goes to every peer
        st = stats_lib.shard_stats(
            None, cnt, sb, ndev, axis_name,
            bytes_per_row=4 + build_vals.dtype.itemsize)
        return (
            ok.reshape(1, -1),
            ov.reshape(1, -1),
            og.reshape(1, -1),
            cnt.reshape(1, 1),
            st,
        )

    ok, ov, oi, cnt, st = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name),) * 4 + (stats_lib.stats_out_specs(axis_name),),
        check_vma=False,
    )(build_keys, build_vals, probe_keys)
    return ok.reshape(-1), ov.reshape(-1), oi.reshape(-1), cnt.reshape(-1), st


# ---------------------------------------------------------------------------
# hash-exchange join: BOTH sides partitioned by key hash (BASELINE.json:9).
# The broadcast variant all_gathers the build table per chip — fine for the
# FK shape (100M build / pod would still be ~400MB/chip), dead for large
# builds. Here each side's rows are routed to owner = hash(key) % ndev with
# ONE padded all_to_all per column; each shard then runs the local
# sort-coalesce join over only its key partition. Probe skew: a heavy probe
# key hashes to one device, but its matched rows are 1:1 with probe rows, so
# the output stays proportional to the received probe rows (cap-bounded);
# build-side uniqueness keeps the build exchange balanced under Zipf probes.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "config")
)
def join_exchange_caps(
    build_keys: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    config: config_lib.SortConfig | None = None,
):
    """Phase one of the sized hash join: exact max (src,dst) lane occupancy
    for the build and probe exchanges (two tiny collectives, no data moved)."""
    ndev = axis_size(mesh, axis_name)
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    sb, sp = -(-nb // ndev), -(-npr // ndev)
    build_keys = _pad_to(build_keys, sb * ndev)
    probe_keys = _pad_to(probe_keys, sp * ndev)

    def shard_fn(bk, pk):
        caps = []
        for keys, n, s in ((bk, nb, sb), (pk, npr, sp)):
            valid = _shard_valid(n, s, axis_name)
            dest = jnp.where(
                valid, _owner_of_keys(keys.reshape(-1), ndev), ndev)
            counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(
                1, mode="drop")
            caps.append(jax.lax.pmax(jnp.max(counts), axis_name))
        return caps[0], caps[1]

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)), out_specs=(P(), P()),
        check_vma=False,
    )(build_keys, probe_keys)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "build_cap", "probe_cap", "config"),
)
def join_distributed_hash(
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    build_cap: int | None = None,
    probe_cap: int | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Inner FK join with BOTH sides hash-exchanged over the mesh.

    Returns per-shard (keys, vals, probe_idx (GLOBAL probe row), count,
    stats) concatenated over the mesh axis; device d emits the matches of
    the keys hashing to d. Caps default to the full shard size (always
    correct); use join_distributed_sized for measured tight caps.
    """
    ndev = axis_size(mesh, axis_name)
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    sb, sp = -(-nb // ndev), -(-npr // ndev)
    build_keys = _pad_to(build_keys, sb * ndev)
    build_vals = _pad_to(build_vals, sb * ndev)
    probe_keys = _pad_to(probe_keys, sp * ndev)
    bcap = build_cap or sb
    pcap = probe_cap or sp

    def shard_fn(bk, bv, pk):
        bk, bv, pk = bk.reshape(-1), bv.reshape(-1), pk.reshape(-1)
        d = jax.lax.axis_index(axis_name).astype(jnp.int32)
        bvalid = _shard_valid(nb, sb, axis_name)
        pvalid = _shard_valid(npr, sp, axis_name)
        destb = jnp.where(bvalid, _owner_of_keys(bk, ndev), ndev)
        destp = jnp.where(pvalid, _owner_of_keys(pk, ndev), ndev)
        (rbk, rbv), rbvalid = exchange_rows(
            [bk, bv], destb, ndev, axis_name, bcap)
        gpidx = d * sp + jnp.arange(sp, dtype=jnp.int32)
        (rpk, rpi), rpvalid = exchange_rows(
            [pk, gpidx], destp, ndev, axis_name, pcap)
        ok, ov, oi, cnt = local_join(
            rbk, rbv, rpk, how="inner",
            build_valid=rbvalid, probe_valid=rpvalid, config=config)
        og = jnp.take(rpi, oi, axis=0)  # received-row -> global probe row
        send_counts = (
            jnp.zeros((ndev,), jnp.int32).at[destb].add(1, mode="drop")
            + jnp.zeros((ndev,), jnp.int32).at[destp].add(1, mode="drop"))
        # both exchanges move (key + 4-byte companion) columns; caps differ,
        # report the padded wire total via the combined row budget
        st = stats_lib.shard_stats(
            send_counts, cnt, bcap + pcap, ndev, axis_name, bytes_per_row=8)
        return (
            ok.reshape(1, -1), ov.reshape(1, -1),
            og.reshape(1, -1), cnt.reshape(1, 1), st,
        )

    ok, ov, oi, cnt, st = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name),) * 4 + (stats_lib.stats_out_specs(axis_name),),
        check_vma=False,
    )(build_keys, build_vals, probe_keys)
    return ok.reshape(-1), ov.reshape(-1), oi.reshape(-1), cnt.reshape(-1), st


def join_distributed_sized(
    build_keys, build_vals, probe_keys, *,
    mesh: Mesh, axis_name: str = "x",
    config: config_lib.SortConfig | None = None,
):
    """Two-phase sized hash-exchange join (host-level wrapper): measure both
    exchanges, round caps to powers of two, run join_distributed_hash.
    Returns (keys, vals, probe_idx, counts, (build_cap, probe_cap), stats)."""
    from cuda.radixsort_tpu.parallel.dsort import round_cap

    bcap, pcap = join_exchange_caps(
        build_keys, probe_keys, mesh=mesh, axis_name=axis_name, config=config)
    bcap, pcap = round_cap(int(bcap)), round_cap(int(pcap))
    ok, ov, oi, cnt, st = join_distributed_hash(
        build_keys, build_vals, probe_keys, mesh=mesh, axis_name=axis_name,
        build_cap=bcap, probe_cap=pcap, config=config)
    return ok, ov, oi, cnt, (bcap, pcap), st


def join_distributed(
    build_keys, build_vals, probe_keys, *,
    mesh: Mesh, axis_name: str = "x",
    config: config_lib.SortConfig | None = None,
    broadcast_threshold: int | None = None,
):
    """Route a distributed inner join by build-side size: small builds are
    broadcast (no probe movement — probe skew immaterial), large builds are
    hash-exchanged (both sides partitioned; the 1B x 100M contract shape).
    The threshold is the per-chip row count a build broadcast would resident
    (default 2^20 rows — ~8 MB of key+value columns per chip)."""
    thresh = broadcast_threshold if broadcast_threshold is not None else 1 << 20
    if build_keys.shape[0] <= thresh:
        return join_distributed_broadcast(
            build_keys, build_vals, probe_keys,
            mesh=mesh, axis_name=axis_name, config=config)
    ok, ov, oi, cnt, _, st = join_distributed_sized(
        build_keys, build_vals, probe_keys,
        mesh=mesh, axis_name=axis_name, config=config)
    return ok, ov, oi, cnt, st
