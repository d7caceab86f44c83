"""Radix partition — the core query-execution primitive.

Stable k-bit bucket partition of rows by key (or key hash), returning the
reordered columns plus bucket offsets. This is the reference's per-digit
counting pass (histogram -> scan -> scatter) promoted to a public operator:
it is what the distributed shuffle, hash join and aggregate build on
(BASELINE.json:5,9,10). The bucket id is the sort key, restricted to its
low `bits` bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs

HASH_MUL = jnp.uint32(0x9E3779B1)  # Fibonacci hashing constant


def hash32(keys: jnp.ndarray) -> jnp.ndarray:
    """Cheap vectorized u32 mix for hash partitioning (elementwise, fuses)."""
    x = keys.astype(jnp.uint32) if keys.dtype != jnp.uint32 else keys
    x = x * HASH_MUL
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x85EBCA77)
    x = x ^ (x >> jnp.uint32(13))
    return x


@functools.partial(
    jax.jit, static_argnames=("bits", "by_hash", "config")
)
def partition(
    keys: jnp.ndarray,
    values=None,
    *,
    bits: int,
    by_hash: bool = False,
    config: config_lib.SortConfig | None = None,
):
    """Stable partition into 2**bits buckets by the TOP `bits` of the
    twiddled key (range partition) or of its hash (hash partition).

    Returns (keys_out, values_out, offsets) where offsets is (2**bits + 1,)
    int32 bucket boundaries: bucket b = rows [offsets[b], offsets[b+1]).
    values may be None or a pytree of equal-length arrays.
    """
    n = keys.shape[0]
    bkt = bucket_ids(keys, bits=bits, by_hash=by_hash)

    # bucket ids occupy the LOW `bits` of bkt; sort by just those bits.
    payload = (keys, values) if values is not None else (keys,)
    skeys, pay = _sort_pairs(
        bkt, payload, begin_bit=0, end_bit=bits, config=config
    )
    # offsets via binary search over the sorted ids: 2**bits+1 queries
    queries = jnp.arange(1 << bits, dtype=skeys.dtype)
    offsets = jnp.concatenate(
        [
            jnp.searchsorted(skeys, queries, side="left").astype(jnp.int32),
            jnp.asarray([n], jnp.int32),
        ]
    )
    if values is not None:
        keys_out, values_out = pay
        return keys_out, values_out, offsets
    return pay[0], None, offsets


def bucket_ids(keys: jnp.ndarray, *, bits: int, by_hash: bool = False):
    """Bucket id (uint32, in [0, 2**bits)) of each key."""
    if by_hash:
        h = hash32(keys.view(jnp.uint32) if keys.dtype.itemsize == 4
                   else keys.astype(jnp.uint32))
        return h >> jnp.uint32(32 - bits)
    bitsarr = twiddle.twiddle_in(keys)
    width = twiddle.bit_width(keys.dtype)
    return (bitsarr >> jnp.asarray(width - bits, bitsarr.dtype)).astype(jnp.uint32)
