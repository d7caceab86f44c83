"""Distributed selection: k-th value, top-k, distinct over a device mesh.

Reference scope: the single-GPU reference has no multi-device form of these;
they are the mesh-scale generalization the BASELINE contract demands of every
operator (BASELINE.json:5), built from the same primitives as the distributed
sort (parallel/dsort.py).

Designs:

* `kth_value_distributed` — the radix-select refinement loop of
  `ops/select.py` with ONE change: each 16-bin candidate histogram is a
  `psum` over the mesh axis. 8 tiny collectives (u32) resolve the global
  k-th element with ZERO data movement — no key ever leaves its device.
* `top_k_distributed` — local `top_k` per shard (the global top-k is a
  subset of the union of local top-k's), `all_gather` of the k*ndev
  candidates, exact final selection by one u64 (value, index) sort — the
  index limb reproduces the single-chip tie rule (smallest original
  position wins among threshold ties). Replicated output.
* `distinct_distributed` — `sort_distributed` then per-shard consecutive
  dedup; cross-shard duplicate runs are cut with one `all_gather` of each
  shard's last valid key (runs are contiguous across the sorted shard
  concatenation, so comparing against the nearest non-empty predecessor's
  tail is sufficient).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.parallel.dsort import (
    _shard_valid,
    axis_size,
    sort_distributed,
)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "axis_name", "largest"))
def kth_value_distributed(keys: jnp.ndarray, k, *, mesh: Mesh,
                          axis_name="x", largest: bool = False):
    """Global k-th smallest (0-based; largest=True for k-th largest) of a
    sharded array. Histogram-refinement only — 8 psum'd 16-bin histograms,
    no exchange. Returns a replicated scalar of keys.dtype."""
    if twiddle.bit_width(keys.dtype) > 32:
        raise NotImplementedError(
            "kth_value_distributed: <=32-bit keys (use sort_distributed + "
            "reconstruct for 64-bit selection)")
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys, descending=largest).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate([bits, jnp.zeros((pad,), jnp.uint32)])

    def shard_fn(b):
        b = b.reshape(-1)
        valid = _shard_valid(n, s, axis_name)
        prefix = jnp.zeros((), jnp.uint32)
        kk = jnp.asarray(k, jnp.int32)
        for level in range(28, -1, -4):
            shift = jnp.uint32(level)
            himask = jnp.uint32((0xFFFFFFFF << (level + 4)) & 0xFFFFFFFF
                                if level + 4 < 32 else 0)
            cand = valid & ((b & himask) == prefix)
            digit = (b >> shift) & jnp.uint32(15)
            hist = jnp.stack(
                [jnp.sum(jnp.where(cand & (digit == jnp.uint32(d)), 1, 0)
                         .astype(jnp.int32)) for d in range(16)])
            hist = jax.lax.psum(hist, axis_name)
            cum = jnp.cumsum(hist) - hist
            bucket = jnp.sum((cum <= kk).astype(jnp.int32)) - 1
            kk = kk - cum[bucket]
            prefix = prefix | (bucket.astype(jnp.uint32) << shift)
        return prefix.reshape(1)

    out = shard_map(shard_fn, mesh=mesh, in_specs=P(axis_name),
                    out_specs=P(), check_vma=False)(bits)
    return twiddle.twiddle_out(out[0], keys.dtype, descending=largest)


@functools.partial(jax.jit,
                   static_argnames=("k", "mesh", "axis_name", "largest"))
def top_k_distributed(keys: jnp.ndarray, k: int, *, mesh: Mesh,
                      axis_name="x", largest: bool = True):
    """Global top-k (values, original indices) of a sharded array.

    Exchange volume: k rows per device (the local candidates), gathered once;
    the final exact selection is a lexicographic (twiddled value, original
    index) sort of the k*ndev candidates, so ties break to the smallest
    global position — bit-identical to single-chip `ops.select.top_k`.
    (Two-operand `lax.sort`, NOT a u64 pack — u64 silently truncates with
    x64 disabled.) Output is replicated.
    """
    from cuda.radixsort_tpu.ops.select import top_k as _local_topk

    if twiddle.bit_width(keys.dtype) > 32:
        raise NotImplementedError("top_k_distributed: <=32-bit keys")
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    bits = twiddle.twiddle_in(keys, descending=largest).astype(jnp.uint32)
    if pad:
        # pads are the WORST key in twiddle-descending-of-interest space:
        # twiddled order is ascending and local top-k selects smallest
        # twiddled bits, so 0xFFFFFFFF pads never displace a real candidate
        # unless the shard has fewer than k real rows (handled by validity
        # masking below).
        bits = jnp.concatenate([bits, jnp.full((pad,), 0xFFFFFFFF,
                                               jnp.uint32)])
    kloc = min(k, s)

    def shard_fn(b):
        b = b.reshape(-1)
        d = jax.lax.axis_index(axis_name).astype(jnp.uint32)
        valid = _shard_valid(n, s, axis_name)
        # local candidates on twiddled bits: smallest kloc (twiddle space is
        # ascending; `largest` was already folded into the twiddle)
        vals, idx = _local_topk(b, kloc, largest=False, sorted_result=False)
        gidx = d * jnp.uint32(s) + idx.astype(jnp.uint32)
        # invalid rows (pads) -> push to the very end of the order
        isvalid = jnp.take(valid, idx)
        cv = jnp.where(isvalid, vals, jnp.uint32(0xFFFFFFFF))
        ci = jnp.where(isvalid, gidx, jnp.uint32(0xFFFFFFFF))
        av = jax.lax.all_gather(cv, axis_name).reshape(-1)
        ai = jax.lax.all_gather(ci, axis_name).reshape(-1)
        bv, bi = jax.lax.sort((av, ai), num_keys=2)
        return bv[:k].reshape(1, k), bi[:k].astype(jnp.int32).reshape(1, k)

    tv, ti = shard_map(shard_fn, mesh=mesh, in_specs=P(axis_name),
                       out_specs=(P(), P()), check_vma=False)(bits)
    return (twiddle.twiddle_out(tv[0], keys.dtype, descending=largest),
            ti[0])


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name", "cap"))
def distinct_distributed(keys: jnp.ndarray, *, mesh: Mesh, axis_name="x",
                         cap: int | None = None):
    """Sorted distinct values of a sharded array.

    Returns (padded (ndev*s,) array, per-device counts (ndev,)): device d's
    distinct values are out[d*s : d*s + counts[d]]; the concatenation of the
    valid prefixes is the ascending duplicate-free value set.
    """
    from cuda.radixsort_tpu.ops.unique import _run_starts

    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    out, counts, _st = sort_distributed(keys, mesh=mesh,
                                        axis_name=axis_name, cap=cap)
    rows = out.shape[0] // ndev

    def shard_fn(b, cnts):
        b = b.reshape(-1)
        c = cnts.reshape(-1)[0]  # in_spec sharded counts: my own entry
        valid = jnp.arange(rows, dtype=jnp.int32) < c
        starts = _run_starts(b) & valid
        # cross-shard runs: my first valid key duplicates the tail of the
        # nearest NON-EMPTY predecessor shard
        me = jax.lax.axis_index(axis_name).astype(jnp.int32)
        last = b[jnp.maximum(c - 1, 0)]
        lasts = jax.lax.all_gather(last, axis_name)          # (ndev,)
        allc = jax.lax.all_gather(c, axis_name)              # (ndev,)
        devs = jnp.arange(lasts.shape[0], dtype=jnp.int32)
        has = (devs < me) & (allc > 0)
        prev_i = jnp.where(jnp.any(has), jnp.argmax(
            jnp.where(has, devs, -1)), jnp.int32(0))
        dup_first = jnp.any(has) & (b[0] == lasts[prev_i]) & (c > 0)
        starts = starts.at[0].set(starts[0] & jnp.logical_not(dup_first))
        # stable compaction of the kept rows (sort of 1-bit partition ids:
        # drop=False rows first, input order preserved)
        drop = jnp.logical_not(starts)
        order = jnp.argsort(drop, stable=True)
        kept = jnp.take(b, order)
        ucnt = jnp.sum(starts.astype(jnp.int32))
        return kept.reshape(1, -1), ucnt.reshape(1)

    uk, ucounts = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name)), check_vma=False,
    )(out, counts)
    return (twiddle.twiddle_out(uk.reshape(-1), keys.dtype),
            ucounts.reshape(-1))


def groupby_quantile_distributed(keys, values, qs=(0.5,), *, mesh: Mesh,
                                 axis_name="x", max_groups: int = 64):
    """Per-group quantiles over a sharded table — histogram refinement,
    ZERO value movement.

    The plan layer's `_dist_quantiles` hash-exchanges whole (key, value)
    rows so each group's value set lands on one device — correct at any
    group count, but it moves the entire table. For few-group workloads
    (dashboards: percentiles per status code / per shard / per tenant
    bucket) this variant generalizes `kth_value_distributed` per group: a
    quantile is a k-th smallest within the group, and linear interpolation
    needs the floor- and ceil-rank elements, so each (group, q) becomes two
    independent radix-select targets refined together. Per 4-bit level the
    only collective is one `psum` of a (targets, 16) i32 histogram — 8 tiny
    collectives total; no key or value ever leaves its device.

    The per-level masked counting is one matmul: rows match target t iff
    (group_id, value_high_bits) == (g_t, prefix_t), so the (chunk, targets)
    match matrix x (chunk, 16) digit one-hot matmul yields every target's
    histogram in one contraction (f32 accumulate is exact: counts per chunk
    <= chunk size < 2^24).

    Requires: total distinct groups <= max_groups (each shard's local
    distinct set is a subset, so one padded all_gather of G keys suffices);
    <=32-bit key and value dtypes. Returns replicated
    (group_keys (G,), quantile_cols tuple of (G,) mean-dtype arrays,
    n_groups) — valid groups are the first min(n_groups, max_groups)
    entries, key-ascending. `n_groups > max_groups` RELIABLY signals
    truncation (any shard whose local distinct count exceeds max_groups
    raises the reported count past max_groups); the kept slots are the
    max_groups key-smallest groups and their quantiles are exact — rows of
    dropped groups are masked out of every count and histogram.
    """
    if isinstance(qs, (int, float)):
        qs = (float(qs),)
    return _groupby_quantile_distributed(keys, values, tuple(qs), mesh=mesh,
                                         axis_name=axis_name,
                                         max_groups=max_groups)


def _distinct_padded(bits, invalid, G):
    """First G distinct values of `bits` (rows with invalid=True excluded),
    ascending, plus per-slot validity and the true (uncapped) local
    distinct count. Invalidity rides a separate sort limb — no sentinel
    bit pattern is reserved. Shared by quantile_refine_shard and the
    plan's quantile auto-router (distinct_count_capped)."""
    from cuda.radixsort_tpu.ops.unique import _run_starts

    flag = invalid.astype(jnp.uint32)
    sf, sb = jax.lax.sort((flag, bits), num_keys=2)
    starts = _run_starts(sb) & (sf == 0)
    # first occurrence of a run may be an invalid row shadowing a real
    # equal key later: runs are (flag-major) sorted, so a run that has
    # any valid row starts with one — starts & valid is exact.
    order = jnp.argsort(jnp.logical_not(starts), stable=True)
    kept = jnp.take(sb, order)
    cnt = jnp.sum(starts.astype(jnp.int32))
    slot = jnp.arange(G, dtype=jnp.int32)
    slotvalid = slot < jnp.minimum(cnt, G)
    # compaction's tail holds non-start rows (duplicate SMALL keys
    # first) — force pads to the max bit pattern so the slot array
    # stays ascending for searchsorted; 'left' still resolves a real
    # 0xFFFFFFFF group to its (earlier) valid slot.
    padded = jnp.where(slotvalid, kept[:G], jnp.uint32(0xFFFFFFFF))
    return padded, slotvalid, cnt


@functools.partial(jax.jit, static_argnames=("cap", "mesh", "axis_name"))
def distinct_count_capped(keys: jnp.ndarray, *, cap: int, mesh: Mesh,
                          axis_name="x"):
    """Distinct-value count of a sharded array, EXACT while <= cap;
    any value > cap means "more than cap" (replicated scalar).

    Cost: one local (flag, bits) sort per shard + one (cap,) all_gather —
    the cheap pre-pass the declarative plan uses to auto-route group-by
    quantiles onto the zero-row-movement refinement path without a
    user-supplied max_groups hint."""
    if twiddle.bit_width(keys.dtype) > 32:
        raise NotImplementedError("distinct_count_capped: <=32-bit keys")
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    s = -(-n // ndev)
    pad = s * ndev - n
    bits = twiddle.twiddle_in(keys).astype(jnp.uint32)
    if pad:
        bits = jnp.concatenate([bits, jnp.zeros((pad,), jnp.uint32)])

    def shard_fn(b):
        b = b.reshape(-1)
        valid = _shard_valid(n, s, axis_name)
        lk, lval, lcnt = _distinct_padded(b, jnp.logical_not(valid), cap)
        ak = jax.lax.all_gather(lk, axis_name, tiled=True)
        av = jax.lax.all_gather(lval, axis_name, tiled=True)
        _, _, gcnt = _distinct_padded(ak, jnp.logical_not(av), cap)
        over = jax.lax.psum((lcnt > cap).astype(jnp.int32), axis_name) > 0
        return jnp.where(over | (gcnt > cap),
                         jnp.int32(cap + 1), gcnt).reshape(1)

    out = shard_map(shard_fn, mesh=mesh, in_specs=P(axis_name),
                    out_specs=P(), check_vma=False)(bits)
    return out[0]


def quantile_refine_shard(kb, vb, valid, qs, max_groups, value_dtype,
                          axis_name):
    """Per-shard histogram-refinement group-by quantiles — the core of
    `groupby_quantile_distributed`, factored out so OTHER shard_map bodies
    (the declarative plan's quantiles stage) can run it in place of a
    raw-row hash exchange: per 4-bit level the only collective is one psum
    of a (targets, 16) histogram; no key or value leaves its device.

    Must be called INSIDE shard_map over `axis_name`. kb, vb: (s,) uint32
    TWIDDLED key/value bit columns (twiddle.twiddle_in); valid: (s,) bool.
    Returns (group-key BITS (G,) u32, ascending over the valid prefix;
    qstack (Q, G) in _mean_dtype(value_dtype); n_groups () int32 —
    n_groups > G RELIABLY signals that groups beyond the G key-smallest
    were dropped; the kept slots' quantiles stay exact).
    """
    from cuda.radixsort_tpu.ops.aggregate import _mean_dtype

    G, Q = max_groups, len(qs)
    T = G * Q * 2
    s = kb.shape[0]
    md = _mean_dtype(value_dtype)
    # row chunks for the match-matrix matmul: (C, T) + (C, 16) live at once
    C = min(s, 32768)
    nc = -(-s // C)
    spad = nc * C - s

    # --- replicated global group-key set (<= G per the contract) ---
    lk, lval, lcnt = _distinct_padded(kb, jnp.logical_not(valid), G)
    ak = jax.lax.all_gather(lk, axis_name, tiled=True)
    av = jax.lax.all_gather(lval, axis_name, tiled=True)
    gk, gvalid, gcnt = _distinct_padded(ak, jnp.logical_not(av), G)
    # overflow detection: any shard whose LOCAL distinct count exceeds
    # G truncated candidates before the gather, so groups beyond the G
    # key-smallest may be missing or partial (every one of the G
    # globally-smallest keys survives local truncation: on any shard
    # holding it, fewer than G local keys precede it). Report
    # n_groups > G reliably in that case.
    over = jax.lax.psum((lcnt > G).astype(jnp.int32), axis_name) > 0
    n_groups = jnp.where(over, jnp.maximum(gcnt, G + 1), gcnt)
    # gk is ascending over its valid prefix; pads sort after every real
    # key (flag-major), so searchsorted('left') lands on the real slot
    # even for a key equal to a pad's bit pattern.
    gid = jnp.searchsorted(gk, kb, side="left").astype(jnp.int32)
    gid = jnp.clip(gid, 0, G - 1)
    # rows whose key is NOT in the kept slot set (dropped beyond-G
    # groups) must not be counted into the slot searchsorted clips
    # them to, or they would corrupt the kept groups' counts.
    valid = valid & (jnp.take(gk, gid, axis=0) == kb)
    cnt = jnp.zeros((G,), jnp.int32).at[gid].add(
        valid.astype(jnp.int32), mode="drop")
    cnt = jax.lax.psum(cnt, axis_name)

    # --- targets: for each q, each group, the floor and ceil ranks ---
    cntf = jnp.maximum(cnt - 1, 0).astype(jnp.float32)
    klo, khi, fracs = [], [], []
    for q in qs:
        idx_f = cntf * jnp.float32(q)
        lo = jnp.floor(idx_f).astype(jnp.int32)
        klo.append(lo)
        khi.append(jnp.ceil(idx_f).astype(jnp.int32))
        fracs.append(idx_f - lo.astype(jnp.float32))
    kk = jnp.concatenate(klo + khi)              # (T,) = (Q*G + Q*G,)
    g_t = jnp.tile(jnp.arange(G, dtype=jnp.int32), 2 * Q)

    # --- chunked rows for the per-level matmul counting ---
    # (skip zero-length pads: a (0,)-shaped jnp.zeros trips an XLA sharding
    # assertion when traced inside an EAGER shard_map over an explicit-axes
    # mesh — the plan layer's calling convention)
    if spad:
        vb_c = jnp.concatenate([vb, jnp.zeros((spad,), jnp.uint32)])
        gid_c = jnp.concatenate([gid, jnp.zeros((spad,), jnp.int32)])
        val_c = jnp.concatenate([valid, jnp.zeros((spad,), bool)])
    else:
        vb_c, gid_c, val_c = vb, gid, valid
    vb_c = vb_c.reshape(nc, C)
    gid_c = gid_c.reshape(nc, C)
    val_c = val_c.reshape(nc, C)
    digits16 = jnp.arange(16, dtype=jnp.uint32)

    prefix = jnp.zeros((T,), jnp.uint32)
    for level in range(28, -1, -4):
        shift = jnp.uint32(level)
        himask = jnp.uint32((0xFFFFFFFF << (level + 4)) & 0xFFFFFFFF
                            if level + 4 < 32 else 0)

        def body(hist, chunk):
            cv, cg, cval = chunk
            hi = cv & himask
            digit = (cv >> shift) & jnp.uint32(15)
            match = ((cg[:, None] == g_t[None, :])
                     & (hi[:, None] == prefix[None, :])
                     & cval[:, None])                      # (C, T)
            onehot = (digit[:, None] == digits16[None, :])  # (C, 16)
            # 0/1 operands with fp32 accumulation are exact below 2^24 per
            # entry; HIGHEST keeps a TF32 default from rounding them
            hist = hist + jnp.dot(
                match.astype(jnp.float32).T,
                onehot.astype(jnp.float32),
                precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
            return hist, None

        hist, _ = jax.lax.scan(body, jnp.zeros((T, 16), jnp.int32),
                               (vb_c, gid_c, val_c))
        hist = jax.lax.psum(hist, axis_name)
        cum = jnp.cumsum(hist, axis=1) - hist
        bucket = jnp.sum((cum <= kk[:, None]).astype(jnp.int32),
                         axis=1) - 1
        bucket = jnp.clip(bucket, 0, 15)
        kk = kk - jnp.take_along_axis(cum, bucket[:, None],
                                      axis=1)[:, 0]
        prefix = prefix | (bucket.astype(jnp.uint32) << shift)

    # --- assemble: lerp the floor/ceil selections per (q, group) ---
    sel = prefix.reshape(2, Q, G)                # [lo/hi][q][g]
    qcols = []
    for qi in range(Q):
        vlo = twiddle.twiddle_out(sel[0, qi], value_dtype).astype(md)
        vhi = twiddle.twiddle_out(sel[1, qi], value_dtype).astype(md)
        f = fracs[qi].astype(md)
        col = vlo * (1 - f) + vhi * f
        qcols.append(jnp.where(gvalid & (cnt > 0), col,
                               jnp.zeros((), md)))
    return gk, jnp.stack(qcols, 0), n_groups


@functools.partial(jax.jit, static_argnames=("qs", "mesh", "axis_name",
                                             "max_groups"))
def _groupby_quantile_distributed(keys, values, qs, *, mesh, axis_name,
                                  max_groups):
    from cuda.radixsort_tpu.ops.aggregate import _mean_dtype

    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
    if twiddle.bit_width(keys.dtype) > 32 or twiddle.bit_width(
            values.dtype) > 32:
        raise NotImplementedError(
            "groupby_quantile_distributed: <=32-bit keys and values")
    G = max_groups
    ndev = axis_size(mesh, axis_name)
    n = keys.shape[0]
    md0 = _mean_dtype(values.dtype)
    if n == 0:
        return (jnp.zeros((G,), keys.dtype),
                tuple(jnp.zeros((G,), md0) for _ in qs),
                jnp.zeros((), jnp.int32))
    s = -(-n // ndev)
    pad = s * ndev - n
    kbits = twiddle.twiddle_in(keys).astype(jnp.uint32)
    vbits = twiddle.twiddle_in(values).astype(jnp.uint32)
    if pad:
        kbits = jnp.concatenate([kbits, jnp.zeros((pad,), jnp.uint32)])
        vbits = jnp.concatenate([vbits, jnp.zeros((pad,), jnp.uint32)])

    def shard_fn(kb, vb):
        kb, vb = kb.reshape(-1), vb.reshape(-1)
        valid = _shard_valid(n, s, axis_name)
        gk, qstack, n_groups = quantile_refine_shard(
            kb, vb, valid, qs, max_groups, values.dtype, axis_name)
        return (gk.reshape(1, G), qstack[:, None, :], n_groups.reshape(1))

    gk, qstack, gcnt = shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()), check_vma=False)(kbits, vbits)
    gkeys = twiddle.twiddle_out(gk[0], keys.dtype)
    return gkeys, tuple(qstack[q, 0] for q in range(len(qs))), gcnt[0]
