"""Radix select: k-th smallest / top-k without a full sort.

Classic radix-select: walk the key bits 8 at a time; at each level a digit
histogram of the still-candidate range pinpoints the bucket containing the
k-th element; 4 levels resolve a 32-bit key. Each level is one masked
histogram pass (reductions only — no data movement at all), so selection
costs ~4 reads of the data versus a full sort's 8 read+write passes.

The histogram-refinement loop is the upsweep kernel's math reused as a
search; this is the standard companion algorithm of radix sort (same
family as cub::DeviceSelect / radix top-k literature).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.ops.filter import filter_columns


@functools.partial(jax.jit, static_argnames=("largest",))
def kth_value(keys: jnp.ndarray, k, *, largest: bool = False):
    """Value of the k-th smallest (0-based; largest=True for k-th largest).

    Runs ceil(bits/8) histogram passes over the data; supports every key
    dtype the sort supports (twiddle space).
    """
    bits = twiddle.twiddle_in(keys, descending=largest)
    width = twiddle.bit_width(keys.dtype)
    u = bits.dtype
    bw = bits

    prefix = jnp.zeros((), u)  # resolved high bits so far
    kk = jnp.asarray(k, jnp.int64 if width > 32 else jnp.int32)
    for level in range(width - 4, -1, -4):
        shift = jnp.asarray(level, u)
        # candidates: keys matching the resolved bits above this nibble
        himask = jnp.asarray(
            (~0 << (level + 4)) & ((1 << width) - 1)
            if level + 4 < width else 0, u
        )
        cand = (bw & himask) == prefix
        digit = (bw >> shift) & jnp.asarray(15, u)
        # 16 fused masked reductions — no N x bins materialization, scales
        # to billions of rows
        hist = jnp.stack(
            [jnp.sum(jnp.where(cand & (digit == jnp.asarray(b, u)),
                               1, 0).astype(kk.dtype)) for b in range(16)]
        )
        cum = jnp.cumsum(hist) - hist
        b = jnp.sum((cum <= kk).astype(jnp.int32)) - 1
        kk = kk - cum[b]
        prefix = prefix | (b.astype(u) << shift)
    return twiddle.twiddle_out(prefix, keys.dtype, descending=largest)


@functools.partial(jax.jit, static_argnames=("k", "largest", "sorted_result", "config"))
def top_k(keys: jnp.ndarray, k: int, *, largest: bool = True,
          sorted_result: bool = True,
          config: config_lib.SortConfig | None = None):
    """Top-k values (and their indices). Selection via radix kth_value +
    one filter pass; only the k survivors are sorted.

    Returns (values (k,), indices (k,)).
    """
    from cuda.radixsort_tpu.ops.sort import sort_pairs

    n = keys.shape[0]
    thresh = kth_value(keys, k - 1, largest=largest)
    tb = twiddle.twiddle_in(keys, descending=largest)
    tt = twiddle.twiddle_in(jnp.broadcast_to(thresh, (1,)), descending=largest)[0]
    strictly = tb < tt           # definitely in top-k
    ties = tb == tt              # threshold ties: take enough to fill k
    n_strict = jnp.sum(strictly.astype(jnp.int32))
    # rank ties by position: tie i kept iff (# ties before i) < k - n_strict
    from cuda.radixsort_tpu.ops.scan import cumulative

    tie_rank = cumulative(ties.astype(jnp.int32), "sum") - 1
    keep = strictly | (ties & (tie_rank < (k - n_strict)))
    idx = jnp.arange(n, dtype=jnp.int32)
    (fk, fi), _ = filter_columns(keep, (keys, idx), config=config)
    vals, inds = fk[:k], fi[:k]
    if sorted_result:
        cfg = config_lib.resolve(config)
        vals, inds = sort_pairs(vals, inds, descending=largest, config=cfg)
    return vals, inds
