"""Unique / run-length encoding over sorted or run-structured keys.

Reference parity: cub::DeviceSelect::Unique, cub::DeviceRunLengthEncode::
{Encode, NonTrivialRuns} (CUB device/device_select.cuh, device_run_length_
encode.cuh) — the standard companions of DeviceRadixSort (sort -> dedup /
histogram of runs). CUB's semantics are *consecutive* dedup: only adjacent
equal keys collapse, so `unique(sort(x))` is the distinct-value set.

Design: run boundaries are a vectorized neighbor compare (one elementwise
pass), and compaction rides the same stable 1-bit-partition engine as the
predicate filter (`ops/filter.py`), so "select" is a partition keyed on the
boundary mask. Outputs are
fixed-shape (XLA static shapes): padded arrays plus a valid count, the same
contract as `filter_columns`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.filter import filter_columns, selection_vector


def _run_starts(keys: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask: True where a run of equal keys begins."""
    n = keys.shape[0]
    if n == 0:
        return jnp.zeros((0,), jnp.bool_)
    neq = keys[1:] != keys[:-1]
    return jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])


@functools.partial(jax.jit, static_argnames=("config",))
def unique(keys: jnp.ndarray,
           config: config_lib.SortConfig | None = None):
    """Collapse consecutive equal keys (cub::DeviceSelect::Unique).

    Returns (unique_keys, count): unique_keys[:count] are the first elements
    of each run in order; the tail is padding (the dropped duplicates).
    Apply to sorted input for a distinct-value set (see `distinct`).
    """
    starts = _run_starts(keys)
    (uk,), count = filter_columns(starts, (keys,), config=config)
    return uk, count


@functools.partial(jax.jit, static_argnames=("config",))
def run_length_encode(keys: jnp.ndarray,
                      config: config_lib.SortConfig | None = None):
    """Run-length encode (cub::DeviceRunLengthEncode::Encode).

    Returns (unique_keys, run_lengths, num_runs): for i < num_runs,
    run i is `run_lengths[i]` copies of `unique_keys[i]`, in input order.
    Tail entries (i >= num_runs) are zero-length padding.
    """
    n = keys.shape[0]
    starts = _run_starts(keys)
    # sel[:count] = start index of each run, in order (selection_vector keeps
    # kept-row indices stably); run length = next start - this start.
    sel, count = selection_vector(starts, config=config)
    (uk,), _ = filter_columns(starts, (keys,), config=config)
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.roll(sel, -1)  # sel[i+1] except at the wraparound / run tail
    last = count - 1
    ends = jnp.where(idx == last, jnp.int32(n), nxt)
    lengths = jnp.where(idx < count, ends - sel, jnp.int32(0))
    return uk, lengths, count


@functools.partial(jax.jit, static_argnames=("config",))
def non_trivial_runs(keys: jnp.ndarray,
                     config: config_lib.SortConfig | None = None):
    """Offsets/lengths of runs longer than one element
    (cub::DeviceRunLengthEncode::NonTrivialRuns).

    Returns (run_offsets, run_lengths, num_runs) for runs with length >= 2.
    """
    n = keys.shape[0]
    starts = _run_starts(keys)
    sel, count = selection_vector(starts, config=config)
    idx = jnp.arange(n, dtype=jnp.int32)
    nxt = jnp.roll(sel, -1)
    ends = jnp.where(idx == count - 1, jnp.int32(n), nxt)
    lengths = jnp.where(idx < count, ends - sel, jnp.int32(0))
    keep = lengths >= 2
    (offs, lens), nruns = filter_columns(keep, (sel, lengths), config=config)
    lens = jnp.where(idx < nruns, lens, jnp.int32(0))
    return offs, lens, nruns


@functools.partial(jax.jit, static_argnames=("config",))
def distinct(keys: jnp.ndarray,
             config: config_lib.SortConfig | None = None):
    """Sorted distinct values of an arbitrary array: radix sort + unique.

    Returns (values, count) — values[:count] ascending and duplicate-free.
    """
    from cuda.radixsort_tpu.ops.sort import sort as _sort

    return unique(_sort(keys, config=config), config=config)
