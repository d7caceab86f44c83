"""LSD radix sort — the core pipeline of the framework.

Reference semantics: the per-digit CUDA pipeline (per-block digit histogram ->
exclusive prefix-scan over the striped spine -> stable scatter), as in the
reference repo and its canonical form `CUB/device/dispatch/dispatch_radix_sort.cuh`
(`InvokePasses` :822-988 pass planning, `InvokePass` :362-488 upsweep/scan/downsweep)
with the striped spine layout of `CUB/device/dispatch/kernels/radix_sort.cuh:58-60`
(digit-major, tile-minor: spine[digit * num_tiles + tile]).

Design:
  * keys are twiddled into order-preserving unsigned bits
    (`twiddle.py`) and split into u32 limb columns, most significant first
    (the decomposer protocol analogue of CUB `util_type.cuh:528-567`);
  * two engines share that layout: 'xla' (one stable `jax.lax.sort` over
    the limbs plus payloads — XLA:GPU hands single-key sorts to CUB's
    radix sort) and 'reference' (pure-jnp LSD oracle: per-tile digit
    histogram, striped spine scan, stable scatter, ``tile_rows x 128``-key
    tiles);
  * one jit-compiled graph contains every digit pass (no host loop).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle

# ---------------------------------------------------------------------------
# pass planning (reference: dispatch_radix_sort.cuh:915-936 — alt smaller-radix
# passes run first so every pass is radix_bits or radix_bits-1 wide)
# ---------------------------------------------------------------------------


def plan_passes(begin_bit: int, end_bit: int, radix_bits: int) -> list[tuple[int, int]]:
    """Return [(shift, width), ...] LSD pass plan covering [begin_bit, end_bit)."""
    num_bits = end_bit - begin_bit
    if num_bits <= 0:
        return []
    num_passes = -(-num_bits // radix_bits)
    alt_bits = radix_bits - 1
    num_alt = num_passes * radix_bits - num_bits
    if alt_bits == 0 or num_alt > num_passes:
        # degenerate radix; fall back to uneven last pass
        plan, shift = [], begin_bit
        while shift < end_bit:
            w = min(radix_bits, end_bit - shift)
            plan.append((shift, w))
            shift += w
        return plan
    plan, shift = [], begin_bit
    for p in range(num_passes):
        w = alt_bits if p < num_alt else radix_bits
        plan.append((shift, w))
        shift += w
    assert shift == end_bit
    return plan


# ---------------------------------------------------------------------------
# padding to whole tiles
# ---------------------------------------------------------------------------


# Device paths index rows with int32 (iota payloads, spine bases); past
# 2^31 rows that arithmetic would wrap silently.
# CUB widens to u64 offsets instead (choose_offset_t,
# device_radix_sort.cuh:353) and portions the input
# (dispatch_radix_sort.cuh:570-576); here >2^31 is the out-of-core domain.
_DEVICE_MAX_N = 1 << 31


def _check_device_n(n: int) -> None:
    if n > _DEVICE_MAX_N:
        raise ValueError(
            f"device sort paths are int32-indexed (max {_DEVICE_MAX_N} "
            f"rows); got {n}. Use cuda.radixsort_tpu.ops.external."
            "sort_external / sort_external_pairs for out-of-core sizes "
            "(CUB handles this with u64 offsets + 2^30-item portions, "
            "device_radix_sort.cuh:353, dispatch_radix_sort.cuh:570-576).")


def _pad_amount(n: int, tile_elems: int) -> int:
    full = -(-max(n, 1) // tile_elems) * tile_elems
    return full - n


def _pad_bits(bits: jnp.ndarray, pad: int) -> jnp.ndarray:
    if pad == 0:
        return bits
    # all-ones pads sort to the very end of every ascending digit pass and stay
    # there (stability), so a final [:n] slice recovers the result.
    fill = jnp.full((pad,), jnp.iinfo(bits.dtype).max, dtype=bits.dtype)
    return jnp.concatenate([bits, fill])


def _pad_zeros(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], dtype=x.dtype)])


# ---------------------------------------------------------------------------
# one counting pass — pure-jnp reference engine
# ---------------------------------------------------------------------------


def _tile_histogram(digit_tiles: jnp.ndarray, num_bins: int) -> jnp.ndarray:
    """Per-tile digit histogram: (T, n) int digits -> (T, B) counts.

    Reference role: the upsweep agent (CUB agent_radix_sort_upsweep.cuh:382-422).
    """
    t = digit_tiles.shape[0]
    rows = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], digit_tiles.shape)
    return (
        jnp.zeros((t, num_bins), jnp.int32)
        .at[rows, digit_tiles]
        .add(1, mode="drop", unique_indices=False)
    )


def spine_scan(hist: jnp.ndarray) -> jnp.ndarray:
    """Exclusive scan over the striped spine.

    hist: (T, B). Returns base: (B, T) where base[d, t] is the global output
    offset of (digit d, tile t) — digit-major, tile-minor, exactly the striped
    spine of the reference (kernels/radix_sort.cuh:58-60, scan kernel :146-178).
    """
    spine = hist.T.reshape(-1)
    base = jnp.cumsum(spine) - spine  # exclusive
    return base.reshape(hist.shape[1], hist.shape[0]).astype(jnp.int32)


def _tile_rank(digit_tiles: jnp.ndarray) -> jnp.ndarray:
    """Stable rank of each element among equal digits within its tile.

    Reference role: BlockRadixRank (CUB block_radix_rank.cuh:438-495). Here
    computed with a stable per-tile argsort + run-position recovery.
    """
    t, n = digit_tiles.shape
    order = jnp.argsort(digit_tiles, axis=1, stable=True)
    sd = jnp.take_along_axis(digit_tiles, order, axis=1)
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (t, n))
    is_start = jnp.concatenate(
        [jnp.ones((t, 1), bool), sd[:, 1:] != sd[:, :-1]], axis=1
    )
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0), axis=1)
    rank_sorted = pos - run_start
    rows = jnp.arange(t, dtype=jnp.int32)[:, None]
    return jnp.zeros_like(digit_tiles, dtype=jnp.int32).at[rows, order].set(rank_sorted)


def counting_pass_reference(
    digits: jnp.ndarray, num_bins: int, tile_elems: int
) -> jnp.ndarray:
    """One stable counting pass: digits (N,) -> destination permutation (N,).

    dest[i] = spine_base[digit[i], tile[i]] + within-tile stable rank — the
    exact downsweep math (agent_radix_sort_downsweep.cuh:502-591) in jnp.
    """
    n = digits.shape[0]
    t = n // tile_elems
    dt = digits.reshape(t, tile_elems)
    hist = _tile_histogram(dt, num_bins)
    base = spine_scan(hist)  # (B, T)
    rank = _tile_rank(dt)
    tile_idx = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], dt.shape)
    dest = base[dt, tile_idx] + rank
    return dest.reshape(-1)


def apply_permutation(dest: jnp.ndarray, arrays: Sequence[jnp.ndarray]):
    """Scatter each array by out[dest[i]] = a[i] (dest is a bijection)."""
    return [
        jnp.zeros_like(a).at[dest].set(a, mode="drop", unique_indices=True)
        for a in arrays
    ]


# ---------------------------------------------------------------------------
# the LSD driver over limb columns
# ---------------------------------------------------------------------------


def _sort_limbs(
    limbs: list[jnp.ndarray],
    limb_bits: list[tuple[int, int]],
    payloads: list[jnp.ndarray],
    cfg: config_lib.SortConfig,
):
    """Stable LSD sort of uint32 limb columns (most significant column
    first).

    limbs[k] is a (N,) uint32 column; limb_bits[k] = (begin_bit, end_bit) of
    that column that participate in ordering. Unsigned ascending. Returns
    (limbs, payloads) permuted into sorted order.
    """
    if cfg.engine == "xla":
        # sort keys = limbs masked to the participating bit range (most
        # significant limb first = primary key); original limbs ride along as
        # payload so out-of-range bits survive untouched. When every limb
        # participates fully the masked copies are skipped.
        k = len(limbs)
        if all(b == 0 and e == 32 for (b, e) in limb_bits):
            out = jax.lax.sort(list(limbs) + list(payloads), num_keys=k,
                               is_stable=True, dimension=0)
            return list(out[:k]), list(out[k:])
        masked = [
            c & jnp.uint32(((1 << e) - 1) & ~((1 << b) - 1) & 0xFFFFFFFF)
            for c, (b, e) in zip(limbs, limb_bits)
        ]
        out = jax.lax.sort(masked + list(limbs) + list(payloads), num_keys=k,
                           is_stable=True, dimension=0)
        return list(out[k : 2 * k]), list(out[2 * k :])

    # reference engine: explicit histogram -> spine scan -> scatter passes
    n = limbs[0].shape[0]
    pad = _pad_amount(n, cfg.tile_elems)
    limbs = [_pad_bits(c, pad) for c in limbs]
    payloads = [_pad_zeros(p, pad) for p in payloads]
    for k in range(len(limbs) - 1, -1, -1):  # least-significant column first
        begin, end = limb_bits[k]
        for shift, width in plan_passes(begin, end, cfg.radix_bits):
            digits = (
                (limbs[k] >> jnp.uint32(shift)) & jnp.uint32((1 << width) - 1)
            ).astype(jnp.int32)
            dest = counting_pass_reference(digits, 1 << width, cfg.tile_elems)
            limbs = apply_permutation(dest, limbs)
            payloads = apply_permutation(dest, payloads)
    if pad:
        limbs = [c[:n] for c in limbs]
        payloads = [p[:n] for p in payloads]
    return limbs, payloads


# ---------------------------------------------------------------------------
# key <-> limb-column adapters (the decomposer protocol analogue)
# ---------------------------------------------------------------------------


def _key_to_limbs(keys: jnp.ndarray, descending: bool, begin_bit, end_bit):
    """Twiddle keys and decompose into uint32 limb columns, most-significant
    limb first. Returns (limbs, limb_bits)."""
    width = twiddle.bit_width(keys.dtype)
    begin = 0 if begin_bit is None else begin_bit
    end = width if end_bit is None else end_bit
    if not (0 <= begin <= end <= width):
        raise ValueError(f"bad bit range [{begin}, {end}) for {keys.dtype}")
    bits = twiddle.twiddle_in(keys, descending=descending)
    if width <= 32:
        limbs = [bits.astype(jnp.uint32)]
        limb_bits = [(begin, end)]
    else:  # 64-bit keys: two u32 limb columns (hi, lo).
        hi = (bits >> jnp.uint64(32)).astype(jnp.uint32)
        lo = (bits & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
        limbs = [hi, lo]
        lo_range = (min(begin, 32), min(end, 32))
        hi_range = (max(begin, 32) - 32, max(end, 32) - 32)
        limb_bits = [hi_range, lo_range]
    return limbs, limb_bits


def _limbs_to_key(limbs: list[jnp.ndarray], dtype, descending: bool):
    width = twiddle.bit_width(dtype)
    if width <= 32:
        bits = limbs[0].astype(twiddle.unsigned_dtype(dtype))
        if width < 32:
            bits = bits & jnp.array((1 << width) - 1, bits.dtype)
    else:
        bits = (limbs[0].astype(jnp.uint64) << jnp.uint64(32)) | limbs[1].astype(
            jnp.uint64
        )
    return twiddle.twiddle_out(bits, dtype, descending=descending)


# ---------------------------------------------------------------------------
# public API — reference parity: CUB DeviceRadixSort::{SortKeys, SortPairs,
# SortKeysDescending, SortPairsDescending} (device_radix_sort.cuh:339-3152)
# with begin_bit/end_bit digit-range restriction.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("descending", "begin_bit", "end_bit", "config")
)
def sort(
    keys: jnp.ndarray,
    *,
    descending: bool = False,
    begin_bit: int | None = None,
    end_bit: int | None = None,
    config: config_lib.SortConfig | None = None,
) -> jnp.ndarray:
    """Stable radix sort of a 1-D key array. Parity: DeviceRadixSort::SortKeys."""
    cfg = config_lib.resolve(config)
    _check_device_n(keys.shape[0])
    if keys.shape[0] == 0:
        return keys
    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    limbs, _ = _sort_limbs(limbs, limb_bits, [], cfg)
    return _limbs_to_key(limbs, keys.dtype, descending)


@functools.partial(
    jax.jit,
    static_argnames=("descending", "begin_bit", "end_bit", "config"),
)
def sort_pairs(
    keys: jnp.ndarray,
    values,
    *,
    descending: bool = False,
    begin_bit: int | None = None,
    end_bit: int | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Stable key-value radix sort. ``values`` may be any pytree of arrays
    with leading dim == len(keys). Parity: DeviceRadixSort::SortPairs."""
    cfg = config_lib.resolve(config)
    _check_device_n(keys.shape[0])
    leaves, treedef = jax.tree_util.tree_flatten(values)
    if keys.shape[0] == 0:
        return keys, values
    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    limbs, leaves = _sort_limbs(limbs, limb_bits, list(leaves), cfg)
    out_keys = _limbs_to_key(limbs, keys.dtype, descending)
    return out_keys, jax.tree_util.tree_unflatten(treedef, leaves)


@functools.partial(jax.jit, static_argnames=("descending", "config"))
def sort_struct(
    key_columns,
    values=None,
    *,
    descending: bool = False,
    config: config_lib.SortConfig | None = None,
):
    """Stable lexicographic sort by a sequence of key columns,
    most significant first — the decomposer protocol for user-defined struct
    keys (reference: CUB ``util_type.cuh:528-567`` ``traits_t<T,false>`` /
    ``custom_digit_extractor_t``, where a custom type sorts by a tuple of
    its arithmetic members).

    key_columns: sequence of equal-length 1-D arrays, any supported key
    dtype each (mixed dtypes fine — each column twiddles independently).
    values: optional pytree of payload columns. Returns (sorted key columns
    as a tuple, sorted values) or just the tuple when values is None.
    This is the u64 pairs route when x64 is off (np.uint64 would truncate).
    """
    cols = list(key_columns)
    if not cols:
        raise ValueError("need at least one key column")
    _check_device_n(cols[0].shape[0])
    cfg = config_lib.resolve(config)
    limbs, limb_bits, spans = [], [], []
    for col in cols:
        l, b = _key_to_limbs(col, descending, None, None)
        spans.append(len(l))
        limbs += l
        limb_bits += b
    leaves, treedef = jax.tree_util.tree_flatten(values)
    limbs, leaves = _sort_limbs(limbs, limb_bits, list(leaves), cfg)
    out_cols, i = [], 0
    for col, span in zip(cols, spans):
        out_cols.append(_limbs_to_key(limbs[i:i + span], col.dtype, descending))
        i += span
    if values is None:
        return tuple(out_cols)
    return tuple(out_cols), jax.tree_util.tree_unflatten(treedef, leaves)


@functools.partial(
    jax.jit, static_argnames=("descending", "begin_bit", "end_bit", "config")
)
def argsort(
    keys: jnp.ndarray,
    *,
    descending: bool = False,
    begin_bit: int | None = None,
    end_bit: int | None = None,
    config: config_lib.SortConfig | None = None,
) -> jnp.ndarray:
    """Stable argsort via an index payload trucked through the permutation
    (the reference's values-follow-keys scheme, downsweep :470-485)."""
    _check_device_n(keys.shape[0])
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    _, perm = sort_pairs(
        keys,
        idx,
        descending=descending,
        begin_bit=begin_bit,
        end_bit=end_bit,
        config=config,
    )
    return perm
