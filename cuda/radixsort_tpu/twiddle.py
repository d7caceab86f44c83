"""Key-ordering traits: order-preserving bijections into unsigned bit space.

Re-design of the reference stack's radix-sort key "twiddling"
(reference semantics: CUB ``util_type.cuh:839-942`` — unsigned = identity,
signed = XOR sign bit, float = XOR sign bit if positive / full complement if
negative — and ``radix_rank_sort_operations.cuh:575-618`` for the extra full
complement applied for descending order; -0.0 is canonicalized to +0.0 as in
``radix_rank_sort_operations.cuh:79-104``).

All functions are pure jnp, jit-safe, and shape-preserving: they map an array
of sortable keys to an array of uint bits such that ``a < b`` (in the sort
order) iff ``twiddle(a) < twiddle(b)`` as unsigned integers. NaNs follow the
IEEE bit-pattern order this induces: positive NaNs sort above +inf, negative
NaNs below -inf (same as the reference semantics).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# dtypes the sort accepts as keys, and the unsigned bit-space they map into.
_UNSIGNED_OF = {
    jnp.dtype(jnp.uint8): jnp.uint8,
    jnp.dtype(jnp.uint16): jnp.uint16,
    jnp.dtype(jnp.uint32): jnp.uint32,
    jnp.dtype(jnp.uint64): jnp.uint64,
    jnp.dtype(jnp.int8): jnp.uint8,
    jnp.dtype(jnp.int16): jnp.uint16,
    jnp.dtype(jnp.int32): jnp.uint32,
    jnp.dtype(jnp.int64): jnp.uint64,
    jnp.dtype(jnp.float16): jnp.uint16,
    jnp.dtype(jnp.bfloat16): jnp.uint16,
    jnp.dtype(jnp.float32): jnp.uint32,
    jnp.dtype(jnp.float64): jnp.uint64,
}


def bit_width(dtype) -> int:
    """Number of key bits for a supported key dtype."""
    return jnp.dtype(dtype).itemsize * 8


def unsigned_dtype(dtype):
    """The unsigned bit-space dtype a key dtype twiddles into."""
    d = jnp.dtype(dtype)
    if d not in _UNSIGNED_OF:
        raise TypeError(f"unsupported radix-sort key dtype: {d}")
    return jnp.dtype(_UNSIGNED_OF[d])


def is_supported(dtype) -> bool:
    return jnp.dtype(dtype) in _UNSIGNED_OF


def _sign_bit(udtype) -> int:
    return 1 << (jnp.dtype(udtype).itemsize * 8 - 1)


def twiddle_in(keys: jnp.ndarray, descending: bool = False) -> jnp.ndarray:
    """Map keys to unsigned bits whose unsigned order equals the sort order.

    Semantics match the reference's twiddle-in (CUB util_type.cuh:839-942;
    descending complement per radix_rank_sort_operations.cuh:575-618).
    """
    d = jnp.dtype(keys.dtype)
    u = unsigned_dtype(d)
    sign = np.array(_sign_bit(u), dtype=u)
    if jnp.issubdtype(d, jnp.unsignedinteger):
        bits = keys.astype(u)
    elif jnp.issubdtype(d, jnp.signedinteger):
        # XOR the sign bit, expressed without bitcast-convert (arithmetic XOR
        # + same-width convert are bit-preserving two's-complement ops).
        bits = (keys ^ jnp.array(jnp.iinfo(d).min, d)).astype(u)
    else:  # floating
        raw = keys.view(u)
        # canonicalize -0.0 -> +0.0 so the two zeros tie (stable order keeps
        # their relative input order), matching the reference digit extractors.
        # Done on raw bits (not a float compare) so FTZ platforms don't flush
        # denormals into the zero bucket.
        raw = jnp.where(raw == sign, jnp.zeros_like(raw), raw)
        neg = (raw & sign) != 0
        bits = jnp.where(neg, ~raw, raw | sign)
    if descending:
        bits = ~bits
    return bits


def twiddle_out(bits: jnp.ndarray, dtype, descending: bool = False) -> jnp.ndarray:
    """Inverse of :func:`twiddle_in` (modulo -0.0 canonicalization)."""
    d = jnp.dtype(dtype)
    u = unsigned_dtype(d)
    sign = np.array(_sign_bit(u), dtype=u)
    bits = bits.astype(u)
    if descending:
        bits = ~bits
    if jnp.issubdtype(d, jnp.unsignedinteger):
        return bits.astype(d)
    if jnp.issubdtype(d, jnp.signedinteger):
        return bits.astype(d) ^ jnp.array(jnp.iinfo(d).min, d)
    neg = (bits & sign) == 0  # sign bit clear in twiddled space = negative float
    raw = jnp.where(neg, ~bits, bits & ~sign)
    return raw.view(d)
