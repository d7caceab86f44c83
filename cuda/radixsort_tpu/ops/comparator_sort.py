"""Comparator-based stable sort — the merge-sort class of the reference.

Reference parity: cub::DeviceMergeSort::{SortKeys, SortPairs, StableSortKeys,
StableSortPairs} (CUB device/device_merge_sort.cuh) and thrust smart_sort's
merge-sort fallback (THRUST system/cuda/detail/sort.h:333-337): keys that are
NOT radix-sortable — struct keys, user comparators — take a comparison sort.

Design. `lax.sort` exposes only the platform's fixed total order, so the
general-comparator path is a *normalized bitonic network in pure jnp*: log2(p)*(log2(p)+1)/2 compare-exchange stages,
each one vectorized as an index-XOR partner gather plus elementwise selects
(XLA fuses a stage into one kernel; there is no data-dependent control flow,
so the whole network jits on any backend). Sorting networks order correctly
under any strict weak order; *stability* is restored by widening the user's
comparator with an original-index tiebreak, which also makes the order total
so every compare-exchange decision is consistent on both lanes of a pair.

This is a capability/parity path with O(n log^2 n) gathers — for arithmetic
keys under plain less/greater the engine router (thrust_compat.sort,
cub_compat.DeviceMergeSort) sends callers to the radix-sort fast path
instead, exactly as thrust's `can_use_primitive_sort` does (sort.h:310-326).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp


class Less:
    """std::less / thrust::less marker. Traceable as a comparator, and
    recognized by the compat routers as "primitive sort OK" — the same
    test thrust's smart_sort applies (`can_use_primitive_sort`,
    THRUST system/cuda/detail/sort.h:310-326)."""

    def __call__(self, a, b):
        return a < b


class Greater:
    """std::greater / thrust::greater marker (primitive descending sort)."""

    def __call__(self, a, b):
        return a > b


less = Less()
greater = Greater()


def primitive_comparator(comp) -> tuple[bool, bool]:
    """(is_primitive, descending) — whether `comp` is a less/greater marker
    so callers can take the sort engine instead of the network."""
    if isinstance(comp, Less) or comp is Less:
        return True, False
    if isinstance(comp, Greater) or comp is Greater:
        return True, True
    return False, False


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _pad_axis0(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, mode="edge")


def comparator_sort(
    keys: Any,
    comp: Callable[[Any, Any], jnp.ndarray],
    *,
    values: Any = None,
    stable: bool = True,
):
    """Sort by an arbitrary traceable strict-weak-order comparator.

    Args:
      keys: a 1-D array or a pytree of equal-length arrays (a "struct key");
        leaves may carry trailing dims (compared/moved as rows).
      comp: traceable elementwise ``comp(a, b) -> bool array`` over pytrees
        shaped like ``keys`` — True where ``a`` orders strictly before ``b``
        (a strict weak order, like a C++ comparator; NOT <=).
      values: optional pytree of payload arrays moved with the keys.
      stable: keep input order among comparator-equal keys (CUB
        StableSortKeys/StableSortPairs semantics). ``False`` skips the
        second comparator evaluation per stage (CUB SortKeys: equal keys in
        unspecified order).

    Returns:
      sorted keys, or ``(sorted_keys, permuted_values)`` when ``values`` is
      given. Pure function — the platform analogue of CUB's in-place sort.
    """
    key_leaves, key_tdef = jax.tree_util.tree_flatten(keys)
    if not key_leaves:
        raise TypeError("keys pytree has no array leaves")
    n = key_leaves[0].shape[0]
    for leaf in key_leaves:
        if leaf.shape[0] != n:
            raise ValueError("key leaves disagree on leading length")
    val_leaves, val_tdef = jax.tree_util.tree_flatten(values)
    for leaf in val_leaves:
        if leaf.shape[0] != n:
            raise ValueError("value leaves disagree with keys on length")

    if n <= 1:
        return keys if values is None else (keys, values)

    logp = _ceil_log2(n)
    p = 1 << logp
    pad = p - n
    nk = len(key_leaves)

    cols = [_pad_axis0(x, pad) for x in key_leaves + val_leaves]
    lane = jnp.arange(p, dtype=jnp.int32)
    # Index column: original position for the stability tiebreak AND the
    # validity order — pads got index >= n, and the tiebreak sends larger
    # indices later, so pad rows sink to the tail without a separate flag.
    idx = lane

    def pair_lt(a_cols, a_idx, b_cols, b_idx):
        """Total strict order: comp, then (stable/validity) index."""
        a_keys = jax.tree_util.tree_unflatten(key_tdef, a_cols[:nk])
        b_keys = jax.tree_util.tree_unflatten(key_tdef, b_cols[:nk])
        a_first = comp(a_keys, b_keys)
        a_real = a_idx < n
        b_real = b_idx < n
        if stable:
            b_first = comp(b_keys, a_keys)
            tie = jnp.logical_not(a_first | b_first)
            a_first = a_first | (tie & (a_idx < b_idx))
        # pads order after every real row (their key bytes are edge copies,
        # so comp may claim otherwise — validity overrides)
        return (a_real & jnp.logical_not(b_real)) | (a_real & b_real & a_first)

    for k in range(1, logp + 1):
        block = 1 << k
        asc = (lane & block) == 0
        for jbit in range(k - 1, -1, -1):
            partner = lane ^ (1 << jbit)
            low = lane < partner
            p_cols = [jnp.take(c, partner, axis=0) for c in cols]
            p_idx = jnp.take(idx, partner)
            # value at the LOW lane of the pair (same on both lanes)
            a_cols = [jnp.where(_bshape(low, c), c, pc)
                      for c, pc in zip(cols, p_cols)]
            a_idx = jnp.where(low, idx, p_idx)
            b_cols = [jnp.where(_bshape(low, c), pc, c)
                      for c, pc in zip(cols, p_cols)]
            b_idx = jnp.where(low, p_idx, idx)
            # strictly out of order for this direction -> swap (symmetric
            # on both lanes, so the pair always agrees)
            swap = jnp.where(asc,
                             pair_lt(b_cols, b_idx, a_cols, a_idx),
                             pair_lt(a_cols, a_idx, b_cols, b_idx))
            cols = [jnp.where(_bshape(swap, c), pc, c)
                    for c, pc in zip(cols, p_cols)]
            idx = jnp.where(swap, p_idx, idx)

    cols = [c[:n] for c in cols]
    out_keys = jax.tree_util.tree_unflatten(key_tdef, cols[:nk])
    if values is None:
        return out_keys
    out_vals = jax.tree_util.tree_unflatten(val_tdef, cols[nk:])
    return out_keys, out_vals


def _bshape(mask: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a (p,) bool mask against a (p, ...) column."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def comparator_argsort(
    keys: Any,
    comp: Callable[[Any, Any], jnp.ndarray],
    *,
    stable: bool = True,
) -> jnp.ndarray:
    """Permutation that sorts ``keys`` under ``comp`` (stable by default)."""
    leaves, _ = jax.tree_util.tree_flatten(keys)
    n = leaves[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _, perm = comparator_sort(keys, comp, values=iota, stable=stable)
    return perm
