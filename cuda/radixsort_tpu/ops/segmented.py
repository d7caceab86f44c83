"""Segmented radix sort — independent stable sort per segment.

Parity: cub::DeviceSegmentedRadixSort (device_segmented_radix_sort.cuh;
one block per segment, kernels/radix_sort.cuh:504-672). Design:
a segment id becomes the MOST-SIGNIFICANT limb of a composite key, so the
whole batch sorts in ONE fused LSD pipeline — no per-segment launches, no
load imbalance from ragged segments (a 1-element and a 1M-element segment
cost the same per-row work).

Segment ids are derived from offsets with a cumsum over a sparse indicator
(the only scatter is nseg elements — tiny), never a per-row searchsorted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.sort import _key_to_limbs, _limbs_to_key, _sort_limbs


def _segment_ids(offsets: jnp.ndarray, n: int) -> jnp.ndarray:
    ind = jnp.zeros((n + 1,), jnp.uint32).at[offsets[1:-1]].add(
        1, mode="drop"
    )[:n]
    from cuda.radixsort_tpu.ops.scan import cumulative

    return cumulative(ind.astype(jnp.int32), "sum").astype(jnp.uint32)


@functools.partial(
    jax.jit, static_argnames=("descending", "num_segments_bound",
                              "begin_bit", "end_bit", "config")
)
def segmented_sort(
    keys: jnp.ndarray,
    offsets: jnp.ndarray,
    values=None,
    *,
    descending: bool = False,
    num_segments_bound: int | None = None,
    begin_bit: int | None = None,
    end_bit: int | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Stable sort within each segment. offsets: (num_segments+1,) int32 row
    boundaries (segment s = rows [offsets[s], offsets[s+1])). Returns sorted
    keys (and values if given) with segment boundaries unchanged.

    num_segments_bound caps the segment-limb bit width (default: enough for
    len(offsets)-1 segments) — fewer bits = fewer radix passes.
    begin_bit/end_bit restrict ordering to a key bit subrange, exactly
    cub::DeviceSegmentedRadixSort's digit-range arguments (the segment limb
    always participates fully).
    """
    cfg = config_lib.resolve(config)
    n = keys.shape[0]
    if n == 0:
        return keys if values is None else (keys, values)
    nseg = num_segments_bound or (offsets.shape[0] - 1)
    seg_bits = max(1, (max(nseg - 1, 1)).bit_length())
    seg = _segment_ids(offsets, n)

    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)

    # full range = the caller gave no bit restriction (compare against the
    # key dtype's own width, NOT 32 — u8/u16 keys yield (0, width) limbs)
    from cuda.radixsort_tpu import twiddle as _twiddle

    kw = _twiddle.bit_width(keys.dtype)
    full_range = ((begin_bit is None or begin_bit == 0)
                  and (end_bit is None or end_bit == kw))
    limbs = [seg] + limbs
    # lax.sort gains nothing from a narrow segment range — declaring it
    # full-width (high bits are zero) skips the masked copies; the
    # reference radix engine keeps the tight width (fewer digit passes).
    if cfg.engine == "xla" and full_range:
        limb_bits = [(0, 32)] + limb_bits
    else:
        limb_bits = [(0, seg_bits)] + limb_bits

    leaves, treedef = jax.tree_util.tree_flatten(values) if values is not None else ([], None)
    limbs, leaves = _sort_limbs(limbs, limb_bits, list(leaves), cfg)
    out = _limbs_to_key(limbs[1:], keys.dtype, descending)
    if values is None:
        return out
    return out, jax.tree_util.tree_unflatten(treedef, leaves)
