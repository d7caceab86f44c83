"""Merge of pre-sorted sequences.

Reference parity: cub::DeviceMerge::{MergeKeys, MergePairs} (CUB
device/device_merge.cuh) — the companion of DeviceRadixSort for combining
sorted runs (external sorts, incremental batches, distributed round tails).
Semantics: stable two-way merge — equal keys keep input order, and ties
across inputs keep all of `a`'s before `b`'s (MergePairs observably so).

Design — rank-scatter: each element's output position is
`own_rank + searchsorted(other)` (left for `a`, right for `b` — the stable
tie order); the resulting bijection is applied with the same
`apply_permutation` scatter the reference sort engine uses. O(n log n)
binary-search compares, one permutation write — no full sort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.ops.sort import apply_permutation


def _merge_ranks(abits: jnp.ndarray, bbits: jnp.ndarray):
    """Output positions of a's and b's elements in the merged order
    (twiddle-space ascending; stable: a's elements precede equal b's)."""
    na = abits.shape[0]
    nb = bbits.shape[0]
    ra = jnp.arange(na, dtype=jnp.int32) + jnp.searchsorted(
        bbits, abits, side="left"
    ).astype(jnp.int32)
    rb = jnp.arange(nb, dtype=jnp.int32) + jnp.searchsorted(
        abits, bbits, side="right"
    ).astype(jnp.int32)
    return ra, rb


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def merge_sorted(
    a: jnp.ndarray,
    b: jnp.ndarray,
    *,
    descending: bool = False,
    config: config_lib.SortConfig | None = None,
) -> jnp.ndarray:
    """Merge two sorted 1-D arrays into one sorted array.

    Both inputs must be sorted in the same direction as ``descending``.
    Parity: cub::DeviceMerge::MergeKeys (operator< / operator> semantics).
    """
    if a.dtype != b.dtype:
        raise TypeError(f"key dtypes differ: {a.dtype} vs {b.dtype}")
    na, nb = a.shape[0], b.shape[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    abits = twiddle.twiddle_in(a, descending=descending)
    bbits = twiddle.twiddle_in(b, descending=descending)
    ra, rb = _merge_ranks(abits, bbits)
    dest = jnp.concatenate([ra, rb])
    (mbits,) = apply_permutation(dest, [jnp.concatenate([abits, bbits])])
    return twiddle.twiddle_out(mbits, a.dtype, descending=descending)


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def merge_sorted_pairs(
    a_keys: jnp.ndarray,
    a_values,
    b_keys: jnp.ndarray,
    b_values,
    *,
    descending: bool = False,
    config: config_lib.SortConfig | None = None,
):
    """Stable merge of two sorted key-value sequences (values are pytrees
    with matching leaf structure). Equal keys keep a-before-b order.
    Parity: cub::DeviceMerge::MergePairs.
    """
    if a_keys.dtype != b_keys.dtype:
        raise TypeError(f"key dtypes differ: {a_keys.dtype} vs {b_keys.dtype}")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    a_leaves, tdef = jax.tree_util.tree_flatten(a_values)
    b_leaves, tdef_b = jax.tree_util.tree_flatten(b_values)
    if tdef != tdef_b:
        raise TypeError("value pytrees differ between a and b")
    if na == 0:
        return b_keys, b_values
    if nb == 0:
        return a_keys, a_values

    abits = twiddle.twiddle_in(a_keys, descending=descending)
    bbits = twiddle.twiddle_in(b_keys, descending=descending)
    ra, rb = _merge_ranks(abits, bbits)
    dest = jnp.concatenate([ra, rb])
    cols = [jnp.concatenate([abits, bbits])] + [
        jnp.concatenate([pa, pb]) for pa, pb in zip(a_leaves, b_leaves)
    ]
    out = apply_permutation(dest, cols)
    keys = twiddle.twiddle_out(out[0], a_keys.dtype, descending=descending)
    return keys, jax.tree_util.tree_unflatten(tdef, out[1:])
