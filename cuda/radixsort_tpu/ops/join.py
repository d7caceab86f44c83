"""Equality join — sort-coalesce formulation (BASELINE.json:9).

Sort-merge design: the join is expressed through the machinery the rest of
the engine is built on — stable sort + segmented scans:

  1. concatenate build rows then probe rows (build first);
  2. stable radix sort by key: equal keys group together with build rows
     FIRST (stability replaces a composite (key, side) sort key);
  3. a "last build row so far" associative scan carries each build row's
     payload forward; a probe row matches iff the carried key equals its own;
  4. probe rows are compacted out with the filter operator.

`join` supports inner and left joins with unique build keys (the FK-join
shape of the benchmark: 1B probe x 100M build); duplicate build keys resolve
to the LAST duplicate. `join_expand` supports full 1:N row expansion with
duplicate build keys via the two-phase (count -> materialize-into-capacity)
protocol — the XLA static-shape analogue of the reference's two-phase
temp-storage query (call with d_temp_storage==nullptr to size, then run;
CUB device_radix_sort.cuh:339). `join_count` is phase one.

The distributed variant partitions both sides by key hash over the mesh
(parallel/shuffle.py) and runs this local join per shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu import twiddle
from cuda.radixsort_tpu.ops.filter import filter_columns as _filter_columns
from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs


# The forward "last value at a marked row" fill is
# scan-max(where(marked, x, -1)) — valid whenever x is non-decreasing at the
# marked rows (positions and exclusive counts are).


def _scan1(x, op):
    from cuda.radixsort_tpu.ops.scan import cumulative

    return cumulative(x, op)


def _fill_from_marks(marked, x, fill=-1):
    """Forward-fill x's value at marked rows to all following rows.
    Requires x non-decreasing at marked rows. Rows before the first mark get
    `fill`."""
    return _scan1(jnp.where(marked, x, fill), "max")


def _fill_value_from_marks(marked, values):
    """Forward-fill ARBITRARY values from marked rows (rows before the
    first mark get the dtype minimum): a segmented max scan seeded with the
    marked values, restarting at each mark."""
    from cuda.radixsort_tpu.ops.scan import segmented_scan

    if jnp.issubdtype(values.dtype, jnp.floating):
        ident = jnp.asarray(-jnp.inf, values.dtype)
    else:
        ident = jnp.asarray(jnp.iinfo(values.dtype).min, values.dtype)
    seeded = jnp.where(marked, values, ident)
    return segmented_scan(seeded, marked, "max")


def _monotone_at_group_end(is_end, x, big):
    """x's value at the LAST row of each group, broadcast over the group.
    Requires x NON-DECREASING (prefix counts) — backward-fill from end
    marks is then one reversed cummin; no gather."""
    filled_r = _scan1(jnp.where(is_end[::-1], x[::-1], big), "min")
    return filled_r[::-1]


@functools.partial(jax.jit, static_argnames=("how", "config"))
def join(
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    how: str = "inner",
    build_valid: jnp.ndarray | None = None,
    probe_valid: jnp.ndarray | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Join probe rows against (unique-key) build rows.

    build_keys / probe_keys may each be ONE array or a TUPLE of key
    columns (composite equality key): the concatenated sides then ride a
    lexicographic struct sort (the decomposer protocol) and group
    boundaries compare every column. Outputs return the key columns in the
    same single/tuple shape.

    Returns (keys, vals, probe_idx, count):
      keys[:count]      — probe keys that matched (key-sorted order)
      vals[:count]      — the matched build value per probe row
      probe_idx[:count] — original probe row index (gather other probe
                          columns with it — values-follow-keys)
    For how="left", count == len(probe_keys) and unmatched rows carry
    matched-mask False in vals' companion mask (returned as 5th element).
    how="semi"/"anti" are existence joins — probe rows WITH / WITHOUT a
    build match; they return (keys, probe_idx, count) only (no build value
    travels; build_vals is still required for the shared sort plumbing but
    unused in the output).

    build_valid / probe_valid: optional bool masks; False rows take part in
    neither side (they ride the sort as side==2 and never match or emit) —
    the hook the distributed hash-exchange join uses for its padding rows.

    how="right" emits inner matches PLUS build rows whose key matched no
    probe row; how="full" emits the left join PLUS those unmatched build
    rows. Both return (keys, vals, probe_idx, count, matched): build-only
    rows carry probe_idx == -1, their own build value in vals, and
    matched == False (with duplicate build keys every unmatched duplicate
    emits — multiset outer-join semantics).
    """
    if how not in ("inner", "left", "semi", "anti", "right", "full"):
        raise ValueError(how)
    cfg = config_lib.resolve(config)
    multi = isinstance(build_keys, (tuple, list))
    bcols = tuple(build_keys) if multi else (build_keys,)
    pcols = (tuple(probe_keys) if isinstance(probe_keys, (tuple, list))
             else (probe_keys,))
    if len(bcols) != len(pcols):
        raise ValueError("build/probe key column counts differ")
    nb, np_ = bcols[0].shape[0], pcols[0].shape[0]

    key_cols = tuple(jnp.concatenate([b, p])
                     for b, p in zip(bcols, pcols))
    vals = jnp.concatenate([build_vals, jnp.zeros((np_,), build_vals.dtype)])
    # ONE companion column instead of (side, vals, orig): the concat
    # position encodes side (pos < nb == build) and probe row (pos - nb);
    # bit 31 flags invalid rows.
    ntot = nb + np_
    posflag = jnp.arange(ntot, dtype=jnp.uint32)
    if build_valid is not None or probe_valid is not None:
        bvalid = (jnp.ones((nb,), bool) if build_valid is None
                  else build_valid)
        pvalid = (jnp.ones((np_,), bool) if probe_valid is None
                  else probe_valid)
        invalid = ~jnp.concatenate([bvalid, pvalid])
        posflag = posflag | jnp.where(invalid, jnp.uint32(1 << 31),
                                      jnp.uint32(0))

    if multi:
        from cuda.radixsort_tpu.ops.sort import sort_struct as _sort_struct

        skey_cols, (sposflag, svals) = _sort_struct(
            key_cols, (posflag, vals), config=cfg)
        skey_cols = tuple(skey_cols)
    else:
        # the stable sort keeps builds (lower positions) before probes
        # inside every key group
        sk0, (sposflag, svals) = _sort_pairs(key_cols[0], (posflag, vals),
                                             config=cfg)
        skey_cols = (sk0,)
    skeys = skey_cols if multi else skey_cols[0]
    spos = (sposflag & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    sinvalid = sposflag >= jnp.uint32(1 << 31)
    sside = jnp.where(sinvalid, 2, jnp.where(spos < nb, 0, 1))
    sorig = jnp.maximum(spos - nb, 0)

    is_build = sside == 0
    pos = jnp.arange(ntot, dtype=jnp.int32)
    # matched iff MY key group contains a build row (builds sort first in
    # each group): group build-count from cumsums — no gathers. Group
    # boundaries compare TWIDDLED bits per column (equality-preserving
    # bijection — keeps same-bit-pattern NaNs in one group)
    is_start = jnp.zeros((ntot,), bool).at[0].set(True)
    for col in skey_cols:
        cbits = twiddle.twiddle_in(col)
        is_start = is_start | jnp.concatenate(
            [jnp.zeros((1,), bool), cbits[1:] != cbits[:-1]])
    cb_incl = _scan1(is_build.astype(jnp.int32), "sum")
    cb_excl = cb_incl - is_build.astype(jnp.int32)
    cb_at_start = _fill_from_marks(is_start, cb_excl)
    matched = (cb_incl - cb_at_start) > 0
    # carried value = svals at the last build row so far (inside my group
    # whenever matched) — gather-free seeded segmented-max fill
    cv = _fill_value_from_marks(is_build, svals)
    is_probe = sside == 1

    if how == "inner":
        keep = is_probe & matched
        (ok, ov, oi), count = _filter_columns(
            keep, (skeys, cv, sorig), config=cfg
        )
        return ok, ov, oi, count
    if how in ("semi", "anti"):
        # existence joins: probe rows with (semi) / without (anti) a build
        # match; no build value travels
        keep = is_probe & (matched if how == "semi"
                           else jnp.logical_not(matched))
        (ok, oi), count = _filter_columns(keep, (skeys, sorig), config=cfg)
        return ok, oi, count
    if how in ("right", "full"):
        # a build row is unmatched iff its key group holds no VALID probe
        # row: compare the group's inclusive probe count at its end vs at
        # its start. Prefix counts are monotone, so the end fill is one
        # reversed cummin.
        is_end = jnp.concatenate([is_start[1:], jnp.ones((1,), bool)])
        cp_incl = _scan1(is_probe.astype(jnp.int32), "sum")
        cp_excl = cp_incl - is_probe.astype(jnp.int32)
        cp_at_start = _fill_from_marks(is_start, cp_excl)
        cp_at_end = _monotone_at_group_end(is_end, cp_incl,
                                           jnp.int32(ntot + 1))
        has_probe = (cp_at_end - cp_at_start) > 0
        build_only = is_build & jnp.logical_not(has_probe)
        if how == "right":
            keep = (is_probe & matched) | build_only
        else:
            keep = is_probe | build_only
        # unmatched probe rows zero-fill their build value (cv would carry
        # the last build row of an unrelated smaller key) — symmetric with
        # the zero-filled probe columns of build-only rows
        out_v = jnp.where(is_probe,
                          jnp.where(matched, cv,
                                    jnp.zeros((), svals.dtype)),
                          svals)
        out_i = jnp.where(is_probe, sorig, -1)
        out_m = is_probe & matched
        (ok, ov, oi, om), count = _filter_columns(
            keep, (skeys, out_v, out_i, out_m), config=cfg
        )
        return ok, ov, oi, count, om
    # left join: all probe rows, plus matched mask
    (ok, ov, oi, om), count = _filter_columns(
        is_probe, (skeys, cv, sorig, matched), config=cfg
    )
    return ok, ov, oi, count, om


# ---------------------------------------------------------------------------
# 1:N expanding join — two-phase protocol
# ---------------------------------------------------------------------------


def _sorted_merge_state(build_keys, build_vals, probe_keys, cfg):
    """Shared phase: one stable sort of (build ++ probe), then pure scans.

    Returns per-sorted-row state: for every probe row p, the run of build
    rows with its key sits at sorted positions [grp_start[p], grp_start[p] +
    n_build[p]). Computed entirely with prefix scans (no gathers): stability
    places build rows FIRST inside every equal-key group.
    """
    nb, np_ = build_keys.shape[0], probe_keys.shape[0]
    keys = jnp.concatenate([build_keys, probe_keys])
    vals = jnp.concatenate([build_vals, jnp.zeros((np_,), build_vals.dtype)])
    # position companion instead of (side, orig) — see join() above
    n = nb + np_
    posc = jnp.arange(n, dtype=jnp.uint32)
    skeys, (sposc, svals) = _sort_pairs(keys, (posc, vals), config=cfg)
    spos = sposc.astype(jnp.int32)
    sorig = jnp.maximum(spos - nb, 0)
    sbits = twiddle.twiddle_in(skeys)
    pos = jnp.arange(n, dtype=jnp.int32)
    is_build = spos < nb
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sbits[1:] != sbits[:-1]]
    )
    cb_incl = _scan1(is_build.astype(jnp.int32), "sum")
    cb_excl = cb_incl - is_build.astype(jnp.int32)
    # forward-fill (group start position, build-count before group) from each
    # group's first row to every row of the group — position 0 is always a
    # start, so no row keeps the -1 fill
    grp_start = _fill_from_marks(is_start, pos)
    cb_at_start = _fill_from_marks(is_start, cb_excl)
    n_build = cb_incl - cb_at_start  # at probe rows: builds in my key group
    return skeys, svals, sorig, ~is_build, grp_start, n_build


@functools.partial(jax.jit, static_argnames=("config",))
def join_count(
    build_keys: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    config: config_lib.SortConfig | None = None,
) -> jnp.ndarray:
    """Phase one of the expanding join: total number of inner-join output
    rows (sum over probe rows of the matching build-row count). Use it to
    pick `capacity` for join_expand."""
    cfg = config_lib.resolve(config)
    vals = jnp.zeros_like(build_keys, dtype=jnp.int32)
    _, _, _, is_probe, _, n_build = _sorted_merge_state(
        build_keys, vals, probe_keys, cfg
    )
    return jnp.sum(jnp.where(is_probe, n_build, 0))


@functools.partial(jax.jit, static_argnames=("capacity", "how", "config"))
def join_expand(
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    probe_keys: jnp.ndarray,
    *,
    capacity: int,
    how: str = "inner",
    config: config_lib.SortConfig | None = None,
):
    """1:N equality join: every probe row emits one output row per matching
    build row (duplicate build keys fan out).

    `capacity` is the static output size (two-phase: size with join_count).
    Returns (keys, vals, probe_idx, matched, count):
      keys/vals/probe_idx/matched[:count] — output rows in (key, build-run
        offset) order; rows beyond `count` are padding. If count > capacity
        the output is TRUNCATED to the first `capacity` rows (count still
        reports the true total — re-invoke with a larger capacity).
      matched — all True for inner; for how="left" unmatched probe rows emit
        one row with matched=False and vals=0.
    """
    if how not in ("inner", "left"):
        raise ValueError(how)
    cfg = config_lib.resolve(config)
    skeys, svals, sorig, is_probe, grp_start, n_build = _sorted_merge_state(
        build_keys, build_vals, probe_keys, cfg
    )
    n = skeys.shape[0]
    if how == "inner":
        lens = jnp.where(is_probe, n_build, 0)
    else:
        lens = jnp.where(is_probe, jnp.maximum(n_build, 1), 0)
    total = jnp.sum(lens)
    starts = _scan1(lens, "sum") - lens  # exclusive; nondecreasing over rows

    # Scatter each emitting probe row's sorted position into its first
    # output slot, cummax-forward-fill (positions are increasing with
    # slots), then gather the per-row state at the filled positions.
    c = capacity
    slot = jnp.where(lens > 0, starts, c)  # len==0 rows dropped (mode=drop)
    rowpos = jnp.arange(n, dtype=jnp.int32)
    f_pos = _scan1(
        jnp.full((c,), -1, jnp.int32).at[slot].set(rowpos, mode="drop"),
        "max")
    safe = jnp.clip(f_pos, 0, n - 1)
    f_start = jnp.take(starts, safe, axis=0)
    f_grp = jnp.take(grp_start, safe, axis=0)
    f_key = jnp.take(skeys, safe, axis=0)
    f_orig = jnp.take(sorig, safe, axis=0)
    f_nb = jnp.take(n_build, safe, axis=0)

    out_pos = jnp.arange(c, dtype=jnp.int32)
    offset = out_pos - f_start
    matched = f_nb > 0
    build_pos = jnp.clip(f_grp + offset, 0, n - 1)
    out_val = jnp.where(matched, jnp.take(svals, build_pos, axis=0),
                        jnp.zeros((), svals.dtype))
    valid = out_pos < jnp.minimum(total, c)
    out_key = jnp.where(valid, f_key, jnp.zeros((), f_key.dtype))
    out_val = jnp.where(valid, out_val, jnp.zeros((), out_val.dtype))
    out_idx = jnp.where(valid, f_orig, -1)
    matched = matched & valid
    return out_key, out_val, out_idx, matched, total
