"""Device-wide histograms.

Reference parity: cub::DeviceHistogram::{HistogramEven, HistogramRange}
(CUB device/device_histogram.cuh) plus the radix pipeline's own digit
histogram (the upsweep/onesweep-histogram product, agent_radix_sort_
histogram.cuh) exposed as a public operator.

Every histogram computes a bin index per sample and counts with
`_bincount`: a one-hot reduction for small bin counts, XLA's scatter-add
(atomics on the GPU) for large ones. Out-of-range samples are dropped,
matching CUB's semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import twiddle

# above this many bins the (N, bins) one-hot product stops fitting the
# fusion budget and scatter-add wins
_ONEHOT_MAX_BINS = 512


def _bincount(idx: jnp.ndarray, valid: jnp.ndarray, nbins: int) -> jnp.ndarray:
    """Count idx values in [0, nbins) where valid; returns (nbins,) int32."""
    idx = jnp.where(valid, idx, nbins)  # park invalid rows out of range
    if nbins <= _ONEHOT_MAX_BINS:
        # one-hot bincount: XLA fuses the (N, bins) indicator into the
        # column reduction
        oh = (idx[:, None] == jnp.arange(nbins, dtype=idx.dtype)[None, :])
        return jnp.sum(oh, axis=0, dtype=jnp.int32)
    return jnp.zeros((nbins,), jnp.int32).at[idx].add(
        jnp.int32(1), mode="drop"
    )


@functools.partial(jax.jit, static_argnames=("begin_bit", "bits"))
def digit_histogram(
    keys: jnp.ndarray,
    *,
    begin_bit: int = 0,
    bits: int = 8,
) -> jnp.ndarray:
    """Counts of each ``bits``-wide digit at ``begin_bit`` in twiddle space
    (the order-preserving unsigned bit space the sort runs in) — the public
    form of the pipeline's histogram stage. Returns (2^bits,) int32.
    """
    width = twiddle.bit_width(keys.dtype)
    if not (0 <= begin_bit < width and begin_bit + bits <= width):
        raise ValueError(f"bad digit range [{begin_bit}, {begin_bit + bits}) "
                         f"for {keys.dtype}")
    b = twiddle.twiddle_in(keys)
    digits = (b >> jnp.asarray(begin_bit, b.dtype)) & jnp.asarray(
        (1 << bits) - 1, b.dtype
    )
    n = keys.shape[0]
    return _bincount(digits.astype(jnp.int32),
                     jnp.ones((n,), jnp.bool_), 1 << bits)


@functools.partial(jax.jit, static_argnames=("num_bins",))
def histogram_even(
    samples: jnp.ndarray,
    num_bins: int,
    lower,
    upper,
) -> jnp.ndarray:
    """Histogram over ``num_bins`` evenly-spaced bins covering [lower, upper).

    Samples outside the range are dropped. Parity:
    cub::DeviceHistogram::HistogramEven (num_levels = num_bins + 1).
    """
    s = samples.astype(jnp.float32)
    lo = jnp.asarray(lower, jnp.float32)
    hi = jnp.asarray(upper, jnp.float32)
    scale = num_bins / (hi - lo)
    idx = jnp.floor((s - lo) * scale).astype(jnp.int32)
    valid = (s >= lo) & (s < hi)
    idx = jnp.clip(idx, 0, num_bins - 1)  # guard float-edge rounding
    return _bincount(idx, valid, num_bins)


@jax.jit
def histogram_range(samples: jnp.ndarray, levels: jnp.ndarray) -> jnp.ndarray:
    """Histogram over bins [levels[i], levels[i+1]); samples outside
    [levels[0], levels[-1]) are dropped. Parity:
    cub::DeviceHistogram::HistogramRange."""
    nbins = levels.shape[0] - 1
    s = samples.astype(levels.dtype)
    idx = jnp.searchsorted(levels, s, side="right").astype(jnp.int32) - 1
    valid = (s >= levels[0]) & (s < levels[-1])
    idx = jnp.clip(idx, 0, nbins - 1)
    return _bincount(idx, valid, nbins)
