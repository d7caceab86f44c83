"""Predicate filter with selection vectors (BASELINE.json:5).

Compaction is a STABLE 1-BIT PARTITION by the negated predicate (kept rows
first) — the same sort machinery as everything else (a 1-bit key). Output
is fixed-shape (XLA requires static shapes): compacted columns padded at
the tail plus the valid-row count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs


@functools.partial(jax.jit, static_argnames=("config",))
def selection_vector(mask: jnp.ndarray,
                     config: config_lib.SortConfig | None = None):
    """mask (N,) bool -> (sel (N,) int32, count). sel[:count] are the indices
    of rows where mask is True, in order; sel[count:] are the dropped rows'
    indices (a permutation — usable to invert the filter)."""
    n = mask.shape[0]
    key = jnp.where(mask, jnp.uint32(0), jnp.uint32(1))
    idx = jnp.arange(n, dtype=jnp.int32)
    _, sel = _sort_pairs(key, idx, config=config)
    count = jnp.sum(mask.astype(jnp.int32))
    return sel, count


@functools.partial(jax.jit, static_argnames=("config",))
def filter_columns(mask: jnp.ndarray, columns,
                   config: config_lib.SortConfig | None = None):
    """Compact a pytree of equal-length columns by a boolean predicate.

    Returns (filtered_columns, count): rows [0, count) of every output column
    are the rows where mask was True, in their original order; tail rows are
    the dropped rows (NOT zeroed — slice or mask with count).
    """
    key = jnp.where(mask, jnp.uint32(0), jnp.uint32(1))
    _, out = _sort_pairs(key, columns, config=config)
    count = jnp.sum(mask.astype(jnp.int32))
    return out, count
