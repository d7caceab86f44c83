"""Sorted-set algebra over ascending ranges — thrust's set operations.

Reference parity: thrust::set_intersection / set_union / set_difference /
set_symmetric_difference (thrust/set_operations.h), with thrust's multiset
semantics: if a value appears m times in `a` and n times in `b`, the
intersection keeps min(m, n) copies, the union max(m, n), the difference
max(m - n, 0) — and the copies kept are the FIRST occurrences from `a`
(union takes a's copies first, then b's surplus).

Design: these are sequential two-cursor algorithms on a CPU; here
every element's fate is decided independently from two `searchsorted` ranks
(occurrence index within its own equal-run vs the other side's run length),
then kept rows are compacted with the stable filter engine and combined with
the rank merge — no sequential state anywhere, everything jits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.ops.filter import filter_columns


def _occ_and_other(x_bits: jnp.ndarray, y_bits: jnp.ndarray):
    """For each row of sorted x: (occurrence index within its equal-run,
    number of equal rows in sorted y). Pure searchsorted — O(n log n)."""
    n = x_bits.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.searchsorted(x_bits, x_bits, side="left").astype(jnp.int32)
    occ = pos - run_start
    y_lo = jnp.searchsorted(y_bits, x_bits, side="left").astype(jnp.int32)
    y_hi = jnp.searchsorted(y_bits, x_bits, side="right").astype(jnp.int32)
    return occ, y_hi - y_lo


def _twiddled(a, b, descending):
    if a.dtype != b.dtype:
        raise TypeError(f"dtypes differ: {a.dtype} vs {b.dtype}")
    ab = twiddle.twiddle_in(a, descending=descending)
    bb = twiddle.twiddle_in(b, descending=descending)
    return ab, bb


def _out(bits, dtype, descending):
    return twiddle.twiddle_out(bits, dtype, descending=descending)


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def set_intersection(a, b, *, descending: bool = False,
                     config: config_lib.SortConfig | None = None):
    """min(m, n) copies of each common value, taken from `a`.
    Returns (padded, count). Parity: thrust::set_intersection."""
    ab, bb = _twiddled(a, b, descending)
    occ, in_b = _occ_and_other(ab, bb)
    (out,), cnt = filter_columns(occ < in_b, (ab,), config=config)
    return _out(out, a.dtype, descending), cnt


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def set_difference(a, b, *, descending: bool = False,
                   config: config_lib.SortConfig | None = None):
    """max(m - n, 0) copies: a's rows beyond b's count of that value.
    Returns (padded, count). Parity: thrust::set_difference."""
    ab, bb = _twiddled(a, b, descending)
    occ, in_b = _occ_and_other(ab, bb)
    (out,), cnt = filter_columns(occ >= in_b, (ab,), config=config)
    return _out(out, a.dtype, descending), cnt


def _merge_keep_compact(ab, keep_a, bb, keep_b, config):
    """Merge the two (fully sorted) inputs with their keep-masks riding as a
    payload plane, then compact kept rows to a prefix. NO sentinel keys — a
    dropped row may legitimately hold the maximum key value, so the mask travels as data and one stable compaction
    finishes the job. One merge + one compaction total."""
    from cuda.radixsort_tpu.ops.merge import merge_sorted_pairs

    mk, mv = merge_sorted_pairs(ab, keep_a.astype(jnp.uint32),
                                bb, keep_b.astype(jnp.uint32), config=config)
    (out,), cnt = filter_columns(mv != 0, (mk,), config=config)
    return out, cnt


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def set_union(a, b, *, descending: bool = False,
              config: config_lib.SortConfig | None = None):
    """max(m, n) copies: all of a, plus b's surplus beyond a's count (equal
    values keep a's copies first — thrust's order).
    Returns (padded (len(a)+len(b),), count). Parity: thrust::set_union."""
    ab, bb = _twiddled(a, b, descending)
    occ_b, in_a = _occ_and_other(bb, ab)
    out, cnt = _merge_keep_compact(ab, jnp.ones(ab.shape, bool),
                                   bb, occ_b >= in_a, config)
    return _out(out, a.dtype, descending), cnt


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def set_symmetric_difference(a, b, *, descending: bool = False,
                             config: config_lib.SortConfig | None = None):
    """|m - n| copies of each value (a's surplus plus b's surplus).
    Returns (padded, count). Parity: thrust::set_symmetric_difference."""
    ab, bb = _twiddled(a, b, descending)
    occ_a, in_b = _occ_and_other(ab, bb)
    occ_b, in_a = _occ_and_other(bb, ab)
    out, cnt = _merge_keep_compact(ab, occ_a >= in_b,
                                   bb, occ_b >= in_a, config)
    return _out(out, a.dtype, descending), cnt
