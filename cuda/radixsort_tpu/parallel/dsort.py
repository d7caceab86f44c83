"""Distributed radix sort / shuffle over a device mesh.

Multi-device redesign of the reference's single-GPU pipeline: the reference
(CUB dispatch_radix_sort.cuh) never leaves one device — its "exchange"
between histogram and scatter phases is the striped spine in device memory
(kernels/radix_sort.cuh:58-60). Here the same idea becomes a key-range
exchange between devices: a global histogram (psum) picks balanced
splitters, an all_to_all moves each key to its owner, and each owner sorts
its range locally. Output = globally sorted keys, range-partitioned across devices.

This is simultaneously the generic hash/range SHUFFLE operator demanded by
BASELINE.json:5 (distributed all-to-all shuffle with histogram-driven
partitioning); the join/aggregate operators reuse `exchange_by_bucket`.

Sizing note: the exchange pads each (src,dst) lane to `cap` elements. The
default cap is the full local shard (always correct, memory-hungry).
`sort_distributed_sized` is the two-phase sized exchange: a histogram-only
jitted sizing pass computes the true max (src,dst) lane occupancy, the cap
is rounded up to a power of two (bounding compile variants) and the main
exchange runs with that static cap — recv buffers shrink from ndev*S to
ndev*cap (~ndev x smaller when balanced). This is the distributed analogue
of the reference's two-phase temp-storage query (size call with
d_temp_storage==nullptr, then run — CUB device_radix_sort.cuh:339).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.parallel import stats as stats_lib


def axis_size(mesh: Mesh, axis_name) -> int:
    """Devices along `axis_name`, which may be one mesh axis ("x") or a
    tuple of axes (("host", "chip")). Tuple axes flatten host-major —
    matching lax collectives' linearization — so every distributed op here
    runs unchanged over a multi-axis (e.g. host x chip) mesh."""
    if isinstance(axis_name, (tuple, list)):
        size = 1
        for a in axis_name:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis_name]


def _local_sort_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """Ascending unsigned sort of twiddled bits (device-local, collective-free)."""
    return jax.lax.sort([bits], num_keys=1, is_stable=True, dimension=0)[0]


def _splitter_owner(gh: jnp.ndarray, ndev: int) -> jnp.ndarray:
    """Assign each of the B histogram buckets an owner device, balancing counts.

    gh: (B,) global bucket counts. Returns (B,) int32 owner ids, non-decreasing
    (range partitioning keeps output globally ordered). Balanced by cumulative
    mass — the heavy-hitter-aware analogue of even key-range splitting.
    """
    total = jnp.maximum(jnp.sum(gh), 1)
    # owner of bucket i = device owning the bucket's mass midpoint
    cum = jnp.cumsum(gh) - gh // 2
    return _dev_of(cum, _dev_boundaries(total, ndev))


def _dev_boundaries(total, ndev: int) -> jnp.ndarray:
    """Sorted-position boundaries of the device ranges: device k owns
    positions [ceil(k*total/ndev), ceil((k+1)*total/ndev)). Computed without
    the k*total product so int32 cannot overflow at large row counts."""
    k = jnp.arange(1, ndev, dtype=jnp.int32)
    q, r = total // ndev, total % ndev
    return k * q + (k * r + ndev - 1) // ndev


def _dev_of(pos, bounds: jnp.ndarray) -> jnp.ndarray:
    """Device owning sorted position pos = #boundaries <= pos (== the
    overflow-free floor(pos*ndev/total), clipped to ndev-1)."""
    d = jnp.zeros(pos.shape, jnp.int32)
    for k in range(bounds.shape[0]):
        d = d + (pos >= bounds[k]).astype(jnp.int32)
    return d


def _make_padded_send(bits, dest, ndev: int, cap: int, sentinel):
    """Group local elements by destination into a dense (ndev, cap) buffer.

    Elements are stably grouped by sorting on (dest, position) so the
    per-destination segments preserve bucket order; segment d occupies
    rows [seg_start[d], seg_start[d]+counts[d]). Rows with dest >= ndev
    (invalid/padding) sort last and are never picked up.
    """
    s = bits.shape[0]
    pos = jnp.arange(s, dtype=jnp.uint32)
    order = jax.lax.sort(
        [dest, pos] + [bits], num_keys=2, is_stable=False, dimension=0
    )
    dsorted, _, bsorted = order
    counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(1, mode="drop")
    seg_start = jnp.cumsum(counts) - counts
    idx = seg_start[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
    gathered = jnp.take(bsorted, jnp.clip(idx, 0, s - 1).reshape(-1), axis=0)
    send = jnp.where(valid.reshape(-1), gathered, sentinel).reshape(ndev, cap)
    return send, counts


# Heavy-hitter handling (BASELINE.json:5,10): a single key whose mass exceeds
# ~total/ndev cannot be balanced at bucket granularity — every row of the key
# lands on the bucket's owner. Since equal keys are interchangeable in a
# keys-only sort, their rows CAN be split across the contiguous device span
# the cumulative mass assigns them without breaking the global order.
#
# Detection is sample-based (identical on every device): each device
# contributes a strided sample of its keys, the all_gathered sample's top
# _HEAVY_SLOTS modes become candidate keys, and candidates are then counted
# EXACTLY with masked reductions (+ their global sorted position p0 = psum of
# #keys < candidate). A candidate above total/(2*ndev) mass is spread: its
# rows go to the device owning their own sorted slot (intra-key rank), and
# the other rows of its splitter bucket are routed by the midpoint of their
# own gap interval so the bucket's internal order stays device-monotone.
_HEAVY_SLOTS = 4
_SAMPLE_PER_DEV = 256


def _route_plan(bits, valid, axis_name: str, ndev: int, sb: int,
                spread_heavy: bool = True):
    """Shared routing math: splitter histogram -> owner -> per-key dest.

    bits: (S,) twiddled key bits; valid: (S,) bool (False rows are global
    padding — routed to dest == ndev and dropped by the exchange).
    Returns dest (S,) uint32 in [0, ndev] (ndev == drop)."""
    nb = 1 << sb
    s = bits.shape[0]
    top = (bits >> jnp.uint32(32 - sb)).astype(jnp.int32)
    top_m = jnp.where(valid, top, nb)
    lh = jnp.zeros((nb,), jnp.int32).at[top_m].add(1, mode="drop")
    gh = jax.lax.psum(lh, axis_name)
    owner = _splitter_owner(gh, ndev)
    dest = owner[top].astype(jnp.uint32)

    if spread_heavy and ndev > 1:
        total = jnp.maximum(jnp.sum(gh), 1)
        bounds = _dev_boundaries(total, ndev)
        cumb = jnp.cumsum(gh) - gh

        # --- candidate discovery: identical global sample on every device ---
        ks = min(_SAMPLE_PER_DEV, s)
        stride_idx = (jnp.arange(ks, dtype=jnp.int32) * s) // ks
        # invalid rows sample as 0 — harmless (candidates are re-counted)
        samp = jnp.where(
            jnp.take(valid, stride_idx), jnp.take(bits, stride_idx), 0
        )
        gsamp = jax.lax.all_gather(samp, axis_name, tiled=True)  # (ndev*ks,)
        ssamp = jax.lax.sort([gsamp], num_keys=1, dimension=0)[0]
        run_start = jnp.concatenate(
            [jnp.ones((1,), bool), ssamp[1:] != ssamp[:-1]]
        )
        pos = jnp.arange(ssamp.shape[0], dtype=jnp.int32)
        # run length at each start = next run start - own position; the next
        # start is an exclusive suffix-min of start positions
        rev = jnp.where(run_start, pos, ssamp.shape[0])[::-1]
        nxt = jax.lax.cummin(jnp.concatenate(
            [jnp.array([ssamp.shape[0]], jnp.int32), rev[:-1]]))[::-1]
        runlen = jnp.where(run_start, nxt - pos, 0)
        _, cand_pos = jax.lax.top_k(runlen, _HEAVY_SLOTS)
        cands = jnp.take(ssamp, cand_pos)  # (H,) candidate keys

        # --- exact global count + sorted position of each candidate ---
        eq = [valid & (bits == cands[i]) for i in range(_HEAVY_SLOTS)]
        lt = [valid & (bits < cands[i]) for i in range(_HEAVY_SLOTS)]
        lstats = jnp.stack(
            [jnp.sum(m.astype(jnp.int32)) for m in eq]
            + [jnp.sum(m.astype(jnp.int32)) for m in lt]
        )
        # gather spans every device on the axis (or tuple of axes): its row
        # count can exceed ndev when routing at coarser granularity (the
        # hierarchical sort routes to nh hosts while gathering over the whole
        # host x chip mesh), so size the offset mask from the gather itself
        allc = jax.lax.all_gather(lstats, axis_name)  # (n_gathered, 2H)
        my = jax.lax.axis_index(axis_name)
        before = jnp.arange(allc.shape[0], dtype=jnp.int32)[:, None] < my
        myoff = jnp.sum(jnp.where(before, allc, 0), axis=0)[:_HEAVY_SLOTS]
        gstat = jnp.sum(allc, axis=0)
        gcnt = gstat[:_HEAVY_SLOTS]          # global count of candidate
        gp0 = gstat[_HEAVY_SLOTS:]           # global sorted position
        heavy = gcnt > (total // (2 * ndev))
        # dedupe: a key sampled into two slots spreads twice (idempotent),
        # but only count it once for the gap routing below.
        for i in range(_HEAVY_SLOTS):
            for j in range(i):
                heavy = heavy.at[i].set(
                    heavy[i] & (cands[i] != cands[j])
                )

        cbkt = (cands >> jnp.uint32(32 - sb)).astype(jnp.int32)
        # gap interval of every row in a heavy bucket: start from the whole
        # bucket, shrink past each heavy candidate in the same bucket
        in_heavy_bkt = jnp.zeros((s,), bool)
        lo = jnp.take(cumb, top)
        hi = lo + jnp.take(gh, top)
        for i in range(_HEAVY_SLOTS):
            inb = heavy[i] & (top == cbkt[i])
            in_heavy_bkt = in_heavy_bkt | inb
            lo = jnp.where(inb & (bits > cands[i]),
                           jnp.maximum(lo, gp0[i] + gcnt[i]), lo)
            hi = jnp.where(inb & (bits < cands[i]),
                           jnp.minimum(hi, gp0[i]), hi)
        # rows of one gap share (lo, hi) -> one device; gaps are ordered ->
        # devices monotone; candidates' own rows are overwritten below
        gap_dev = _dev_of(lo + (hi - lo) // 2, bounds).astype(dest.dtype)
        dest = jnp.where(in_heavy_bkt, gap_dev, dest)
        for i in range(_HEAVY_SLOTS):
            rank = jnp.cumsum(eq[i].astype(jnp.int32)) - 1 + myoff[i]
            d = _dev_of(gp0[i] + rank, bounds).astype(dest.dtype)
            dest = jnp.where(heavy[i] & eq[i], d, dest)

    return jnp.where(valid, dest, jnp.uint32(ndev))


def _default_splitter_bits(ndev: int) -> int:
    return min(16, max(8, (ndev - 1).bit_length() + 6))


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis_name", "descending", "splitter_bits")
)
def exchange_cap_for_sort(keys: jnp.ndarray, *, mesh: Mesh, axis_name: str = "x",
                          descending: bool = False,
                          splitter_bits: int | None = None) -> jnp.ndarray:
    """Phase one of the sized exchange: exact max (src,dst) lane occupancy
    for a sort_distributed of these keys. Histogram-only — no sort, no data
    movement beyond two tiny collectives."""
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys, descending=descending).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate([bits, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
    sb = splitter_bits or _default_splitter_bits(ndev)

    def shard_fn(b):
        b = b.reshape(-1)
        valid = _shard_valid(n, s, axis_name)
        dest = _route_plan(b, valid, axis_name, ndev, sb)
        counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(1, mode="drop")
        return jax.lax.pmax(jnp.max(counts), axis_name)

    return shard_map(
        shard_fn, mesh=mesh, in_specs=P(axis_name), out_specs=P()
    )(bits)


def round_cap(c: int, quantum: int = 128) -> int:
    """Round a measured cap up to a power of two (>= quantum) so repeated
    sized exchanges hit a bounded set of compiled variants."""
    c = max(int(c), quantum)
    return 1 << (c - 1).bit_length()


def sort_distributed_sized(keys: jnp.ndarray, *, mesh: Mesh,
                           axis_name: str = "x", descending: bool = False):
    """Two-phase sized distributed sort: measure the exchange (jitted sizing
    pass), then run sort_distributed with the tight static cap.

    Host-level wrapper (two jit calls by design — XLA shapes are static).
    Returns (padded_sorted, valid_counts, cap, stats)."""
    cap = round_cap(int(exchange_cap_for_sort(
        keys, mesh=mesh, axis_name=axis_name, descending=descending)))
    out, counts, st = sort_distributed(
        keys, mesh=mesh, axis_name=axis_name, cap=cap, descending=descending)
    return out, counts, cap, st


def _shard_valid(n: int, s: int, axis_name: str) -> jnp.ndarray:
    """Positional validity of this device's rows: the padded global array has
    real rows [0, n); shard d holds rows [d*s, (d+1)*s)."""
    d = jax.lax.axis_index(axis_name)
    gidx = d.astype(jnp.int32) * s + jnp.arange(s, dtype=jnp.int32)
    return gidx < n


def _sort_chunk_bits(chunk: jnp.ndarray, desc_block: bool) -> jnp.ndarray:
    """Sort one received round-chunk, ascending or descending (alternating
    blocks, so the concatenation is a sequence of sorted runs)."""
    s = jax.lax.sort([chunk], num_keys=1, dimension=0)[0]
    return s[::-1] if desc_block else s


def _merge_round_chunks(chunks: list[jnp.ndarray]) -> jnp.ndarray:
    """Merge alternating-direction sorted chunks into one ascending array."""
    return jax.lax.sort([jnp.concatenate(chunks)], num_keys=1, dimension=0)[0]


def resolve_rounds(cap_rows: int, bytes_per_row: int = 4) -> int:
    """Default exchange round count: 2 (double-buffered — round k+1's
    all_to_all overlaps round k's chunk sort) once a per-destination send
    lane exceeds ~4 MB, else 1 (small lanes are latency-bound; splitting
    them only doubles the latency term). BASELINE.json:5/11 names the
    double-buffered exchange explicitly, so it engages by default.
    RS_EXCHANGE_ROUNDS forces a value;
    RS_EXCHANGE_ROUNDS_LANE_BYTES moves the threshold (tests use a tiny one
    to land CPU-sized sorts on the rounds>1 path)."""
    import os

    ov = os.environ.get("RS_EXCHANGE_ROUNDS")
    if ov:
        return int(ov)
    threshold = int(os.environ.get("RS_EXCHANGE_ROUNDS_LANE_BYTES",
                                   4 * 1024 * 1024))
    return 2 if cap_rows * bytes_per_row > threshold else 1


def sort_sharded_bits(bits, axis_name: str, ndev: int, cap: int | None = None,
                      splitter_bits: int | None = None, valid=None,
                      rounds: int | None = None):
    """Distributed ascending sort of twiddled key bits. Runs inside shard_map.

    bits: (S,) uint32 local shard of twiddled bits; valid: optional (S,) bool
    marking real rows (padding rows are dropped from the exchange — validity
    is EXPLICIT, never inferred from key values, so keys equal to 0xFFFFFFFF
    survive).
    Returns (out_padded (ndev*cap,), valid_count ()) per device: device d
    holds the d-th globally-sorted key range, pad-filled at the tail (trim
    with the count — pad fills are the max key, and real max-key rows tie
    with them, so count-trimming is bit-exact for a keys-only sort). The
    third return is this shard's (ndev,) send counts (stats plumbing).

    rounds > 1 (power of two) splits the exchange into that many sub-lane
    rounds: round k+1's all_to_all is issued BEFORE round k's chunk sort in
    the graph, so XLA's async collectives overlap transfer with local sort
    compute (BASELINE.json:5,11 double-buffered exchange); one final sort
    merges the pre-sorted alternating-direction chunks.
    """
    s = bits.shape[0]
    cap = s if cap is None else cap
    if rounds is None:
        rounds = resolve_rounds(cap)
    sb = splitter_bits or _default_splitter_bits(ndev)
    sentinel = jnp.uint32(0xFFFFFFFF)
    if valid is None:
        valid = jnp.ones((s,), jnp.bool_)

    dest = _route_plan(bits, valid, axis_name, ndev, sb)

    if rounds > 1:
        assert rounds & (rounds - 1) == 0, "rounds must be a power of two"
        cap_r = -(-cap // rounds)
        cap = cap_r * rounds
    send, counts = _make_padded_send(bits, dest, ndev, cap, sentinel)
    # explicit counts ride a tiny all_to_all: recv_counts[d] = rows source d
    # actually sent to me
    recv_counts = jax.lax.all_to_all(
        counts.reshape(ndev, 1), axis_name, split_axis=0, concat_axis=0
    ).reshape(-1)
    valid_count = jnp.sum(recv_counts)

    if rounds == 1:
        recv = jax.lax.all_to_all(
            send, axis_name, split_axis=0, concat_axis=0, tiled=False
        )
        out = _local_sort_bits(recv.reshape(-1))
        return out, valid_count, counts

    # round-based double-buffered exchange: chunk length padded to a power
    # of two (bounds the compiled variants)
    cl = 1 << max((ndev * cap_r - 1).bit_length(), 10)

    def exchange_round(r):
        sub = jax.lax.slice_in_dim(send, r * cap_r, (r + 1) * cap_r, axis=1)
        recv = jax.lax.all_to_all(
            sub, axis_name, split_axis=0, concat_axis=0, tiled=False
        ).reshape(-1)
        if cl != recv.shape[0]:
            recv = jnp.concatenate(
                [recv, jnp.full((cl - recv.shape[0],), sentinel, jnp.uint32)]
            )
        return recv

    chunks = []
    prev = exchange_round(0)
    for r in range(1, rounds):
        nxt = exchange_round(r)  # issued before prev's sort consumes data
        chunks.append(_sort_chunk_bits(prev, desc_block=bool((r - 1) & 1)))
        prev = nxt
    chunks.append(_sort_chunk_bits(prev, desc_block=bool((rounds - 1) & 1)))
    out = _merge_round_chunks(chunks)
    return out, valid_count, counts


def make_mesh(n: int | None = None, axis: str = "x") -> Mesh:
    n = n or len(jax.devices())
    return jax.make_mesh((n,), (axis,))


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "cap",
                                             "descending", "rounds"))
def sort_distributed(keys: jnp.ndarray, *, mesh: Mesh, axis_name: str = "x",
                     cap: int | None = None, descending: bool = False,
                     rounds: int | None = None):
    """Globally sort a sharded key array.
    Returns (padded_sorted, valid_counts, exchange_stats).

    padded_sorted: (ndev * percap * ndev,) sharded on the mesh axis — device d
    holds the d-th key range (ascending), sentinel-padded. valid_counts: (ndev,)
    number of real keys per device. `jnp.concatenate` of the trimmed shards is
    the fully sorted array (see tests/test_dsort.py for the reconstruction).
    """
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys, descending=descending).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate([bits, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
    ccap = cap or s

    def shard_fn(b):
        out, valid, send_counts = sort_sharded_bits(
            b.reshape(-1), axis_name, ndev, cap=ccap,
            valid=_shard_valid(n, s, axis_name), rounds=rounds)
        st = stats_lib.shard_stats(
            send_counts, valid, ccap, ndev, axis_name, bytes_per_row=4)
        return out, valid.reshape(1), st

    out, counts, st = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=(P(axis_name), P(axis_name),
                   stats_lib.stats_out_specs(axis_name)),
        check_vma=False,
    )(bits)
    return out, counts, st


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "cap",
                                             "descending"))
def sort_pairs_distributed(keys: jnp.ndarray, values: jnp.ndarray, *,
                           mesh: Mesh, axis_name: str = "x",
                           cap: int | None = None,
                           descending: bool = False):
    """Globally STABLE key-value sort over the mesh (parity: distributed
    DeviceRadixSort::SortPairs). Returns (keys_padded, values_padded,
    valid_counts, stats): device d holds the d-th key range; rows beyond
    counts[d] in its slice are padding.

    Stability across devices: the exchange preserves (source device,
    original position) order per destination, heavy-key spreading assigns
    ascending global rank to ascending devices, and the local sort orders
    by (validity, key) with the received order as tiebreak — so equal keys
    keep their original global order end to end.
    """
    from cuda.radixsort_tpu.ops.sort import sort_struct
    from cuda.radixsort_tpu.parallel.shuffle import (
        exchange_rows as _exchange_rows,
    )

    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys, descending=descending).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
        values = jnp.concatenate(
            [values, jnp.zeros((pad,), values.dtype)])
    ccap = cap or s
    sb = _default_splitter_bits(ndev)

    def shard_fn(b, v):
        b, v = b.reshape(-1), v.reshape(-1)
        valid = _shard_valid(n, s, axis_name)
        dest = _route_plan(b, valid, axis_name, ndev, sb)
        (rb, rv), rvalid = _exchange_rows(
            [b, v], dest, ndev, axis_name, ccap)
        counts = jnp.zeros((ndev,), jnp.int32).at[dest].add(1, mode="drop")
        recv_counts = jax.lax.all_to_all(
            counts.reshape(ndev, 1), axis_name, split_axis=0, concat_axis=0
        ).reshape(-1)
        valid_count = jnp.sum(recv_counts)
        # stable local sort: invalid rows sort last via a leading 0/1 limb;
        # sort_struct is stable, so received (src, pos) order breaks ties
        inv = jnp.where(rvalid, jnp.uint32(0), jnp.uint32(1))
        (_, sbits), sv = sort_struct((inv, rb), rv)
        st = stats_lib.shard_stats(
            counts, valid_count, ccap, ndev, axis_name,
            bytes_per_row=4 + values.dtype.itemsize)
        return (sbits.reshape(1, -1), sv.reshape(1, -1),
                valid_count.reshape(1), st)

    out_b, out_v, counts, st = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name),
                   stats_lib.stats_out_specs(axis_name)),
        check_vma=False,
    )(bits, values)
    out_keys = twiddle.twiddle_out(
        out_b.reshape(-1).astype(jnp.uint32), keys.dtype,
        descending=descending)
    return out_keys, out_v.reshape(-1), counts, st


def make_mesh_2d(hosts: int, chips: int, host_axis: str = "host",
                 chip_axis: str = "chip") -> Mesh:
    """(hosts x chips) mesh: outer axis = inter-host links (slower), inner
    = intra-host links."""
    return jax.make_mesh((hosts, chips), (host_axis, chip_axis))


@functools.partial(jax.jit, static_argnames=("mesh", "host_axis", "chip_axis",
                                             "host_cap", "chip_cap",
                                             "descending"))
def sort_distributed_hier(keys: jnp.ndarray, *, mesh: Mesh,
                          host_axis: str = "host", chip_axis: str = "chip",
                          host_cap: int | None = None,
                          chip_cap: int | None = None,
                          descending: bool = False):
    """Hierarchical distributed sort over a (host x chip) mesh: keys cross
    the slow inter-host links ONCE, in host-aggregated lanes, then the fast
    intra-host links once.

    Stage 1 routes every key to its owner HOST: splitters are computed from
    the global histogram (psum over both axes) at host granularity, and the
    all_to_all runs over `host_axis` only — each chip exchanges with its
    same-position peers on other hosts, so the inter-host network sees H
    lanes of large messages instead of the flattened exchange's H*C small
    ones (it is latency/message-rate bound; intra-host links are not). Stage 2 is the standard chip-axis sort of the host's
    key range (`sort_sharded_bits` — splitters from the host-local psum).

    Output: device (h, c) holds the c-th chip range of the h-th host range —
    globally sorted in linearized (host-major) device order, the same layout
    as `sort_distributed` over the flattened tuple axis. Returns
    (padded_sorted, valid_counts, (host_stats, chip_stats)).
    """
    both = (host_axis, chip_axis)
    nh = mesh.shape[host_axis]
    nc = mesh.shape[chip_axis]
    ndev = nh * nc
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys, descending=descending).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate([bits, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
    hcap = host_cap or s
    sentinel = jnp.uint32(0xFFFFFFFF)
    sb_host = _default_splitter_bits(nh)

    def shard_fn(b):
        b = b.reshape(-1)
        valid = _shard_valid(n, s, both)
        # ---- stage 1: to the owner host, over the host axis only ----
        dest_h = _route_plan(b, valid, both, nh, sb_host)
        send, counts_h = _make_padded_send(b, dest_h, nh, hcap, sentinel)
        recv_counts = jax.lax.all_to_all(
            counts_h.reshape(nh, 1), host_axis, split_axis=0, concat_axis=0
        ).reshape(-1)
        recv = jax.lax.all_to_all(
            send, host_axis, split_axis=0, concat_axis=0
        ).reshape(-1)
        rvalid = (jnp.arange(hcap, dtype=jnp.int32)[None, :]
                  < recv_counts[:, None]).reshape(-1)
        st1 = stats_lib.shard_stats(
            counts_h, jnp.sum(recv_counts), hcap, nh, both, bytes_per_row=4,
            skew_ndev=ndev)
        # ---- stage 2: chip-axis sort of the host's range ----
        out, valid_count, counts_c = sort_sharded_bits(
            recv, chip_axis, nc, cap=chip_cap, valid=rvalid)
        st2 = stats_lib.shard_stats(
            counts_c, valid_count, chip_cap or nh * hcap, nc, both,
            bytes_per_row=4, skew_ndev=ndev)
        return out, valid_count.reshape(1), st1, st2

    out, counts, st1, st2 = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(both),
        out_specs=(P(both), P(both), stats_lib.stats_out_specs(both),
                   stats_lib.stats_out_specs(both)),
        check_vma=False,
    )(bits)
    return out, counts, (st1, st2)


def reconstruct_sorted(out, counts, dtype, n, descending: bool = False):
    """Host-side helper: trim per-device pads and undo the twiddle (tests)."""
    import numpy as np

    ndev = counts.shape[0]
    per = out.shape[0] // ndev
    o = np.asarray(out).reshape(ndev, per)
    c = np.asarray(counts)
    bits = np.concatenate([o[d, : c[d]] for d in range(ndev)])[:n]
    return np.asarray(
        twiddle.twiddle_out(jnp.asarray(bits), dtype, descending=descending)
    )
