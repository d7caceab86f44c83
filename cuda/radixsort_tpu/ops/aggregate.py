"""Group-by aggregation (count/sum/min/max) — sort + segmented scan.

Sort-based design (BASELINE.json:10): rows are sorted by group key and
per-group reductions are SEGMENTED SCANS (associative, log-step, no
gathers):

  sorted keys -> segment starts (neighbor compare) -> reversed segmented
  inclusive scan puts each segment's TOTAL at its START row -> compact the
  start rows with the filter operator.

Skew (Zipf keys) costs nothing here beyond the sort itself — a heavy group
is just a long segment; the distributed variant (parallel/shuffle.py)
handles cross-device skew by partial-aggregating locally before exchange.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.filter import filter_columns as _filter_columns
from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs

_AGGS = ("sum", "count", "min", "max", "mean", "var", "std")


def _mean_dtype(dtype):
    return dtype if jnp.issubdtype(dtype, jnp.floating) else jnp.float32


def _moments_to_var(sums, sumsqs, cnts, agg, dtype):
    """Population variance/std (ddof=0) from the decomposed moments —
    var = E[x^2] - E[x]^2, computed in the mean dtype (f32 for ints; large
    magnitudes lose precision like any single-pass moments method)."""
    md = _mean_dtype(dtype)
    m = sums.astype(md) / cnts.astype(md)
    v = jnp.maximum(sumsqs.astype(md) / cnts.astype(md) - m * m, 0)
    return jnp.sqrt(v) if agg == "std" else v


def _group_starts(key_cols, valid_sorted):
    """True at each group-start row of the SORTED key columns: a new group
    begins where ANY key column changes (or at the valid/invalid boundary,
    so invalid rows never chain onto a real group). The single shared
    definition — groupby_multi and the quantile path must produce the SAME
    group set for _groupby_agg_cols's positional median alignment."""
    n = key_cols[0].shape[0]
    is_start = jnp.zeros((n,), bool).at[0].set(True)
    for col in key_cols:
        is_start = is_start | jnp.concatenate(
            [jnp.zeros((1,), bool), col[1:] != col[:-1]])
    if valid_sorted is not None:
        is_start = is_start | jnp.concatenate(
            [jnp.zeros((1,), bool), valid_sorted[1:] != valid_sorted[:-1]])
    return is_start


def _segment_end_pos(is_start):
    """end_pos[i] = last row of i's segment: forward-fill of end positions
    on the reversed axis (reversed positions increase toward earlier
    rows) — two elementwise passes, no gather."""
    n = is_start.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    is_end = jnp.concatenate([is_start[1:], jnp.ones((1,), bool)])
    from cuda.radixsort_tpu.ops.scan import cumulative

    filled_rev = cumulative(
        jnp.where(is_end[::-1], pos, -1), "max")  # pos is the REVERSED index
    return (n - 1) - filled_rev[::-1]


def _segmented_total_at_start(values, is_start, agg):
    """out[i] = reduce of i's segment, valid at segment-start rows.

    Gather-free: count is pure position arithmetic (end_pos - pos + 1 at
    start rows);
    sum/min/max ride a REVERSED segmented scan — an inclusive scan of the
    flipped array restarting at flipped segment ENDS accumulates each
    segment back-to-front, so the original start row holds the full
    total."""
    from cuda.radixsort_tpu.ops.scan import segmented_scan

    if agg == "count":
        n = is_start.shape[0]
        pos = jnp.arange(n, dtype=jnp.int32)
        return _segment_end_pos(is_start) - pos + 1
    op = "sum" if agg == "sum" else agg
    is_end = jnp.concatenate([is_start[1:], jnp.ones((1,), bool)])
    rev = segmented_scan(values[::-1], is_end[::-1], op)
    return rev[::-1]


@functools.partial(jax.jit, static_argnames=("agg", "config"))
def groupby(
    keys: jnp.ndarray,
    values: jnp.ndarray | None = None,
    *,
    agg: str = "sum",
    valid: jnp.ndarray | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Group rows by key and reduce values per group.

    Returns (group_keys, aggregates, count): rows [0, count) hold one row per
    distinct key (key-ascending). agg="count" ignores `values`. `valid`
    optionally masks rows out (the selection-vector protocol: compacted
    tables carry real-but-dropped rows in the tail — no sentinel keys):
    invalid rows sort into their own trailing segments via a validity limb
    and are dropped by the final compaction.

    agg="median" routes to `groupby_quantile` (q=0.5, interpolated) — the
    value column joins the sort key there.
    """
    if agg == "median":
        if values is None:
            raise ValueError("median needs a value column")
        gk, (gv,), count = groupby_quantile(keys, values, (0.5,),
                                            valid=valid, config=config)
        return gk, gv, count
    if agg not in _AGGS:
        raise ValueError(agg)
    cfg = config_lib.resolve(config)
    n = keys.shape[0]
    if agg == "count" or values is None:
        values = jnp.ones((n,), jnp.int32)
    if n == 0:  # empty-input shortcut (CUB dispatch_radix_sort.cuh:1055)
        return keys, values, jnp.zeros((), jnp.int32)
    if valid is None:
        skeys, svals = _sort_pairs(keys, values, config=cfg)
        valid_sorted = None
    else:
        from cuda.radixsort_tpu.ops.sort import sort_struct as _sort_struct

        flag = jnp.logical_not(valid).astype(jnp.uint8)  # invalid sinks last
        (sflag, skeys), svals = _sort_struct((flag, keys), values,
                                             config=cfg)
        valid_sorted = sflag == 0
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]]
    )
    if valid_sorted is not None:
        # a key run may straddle the valid/invalid boundary: cut it there so
        # invalid rows never contribute to a valid group's total
        is_start = is_start | jnp.concatenate(
            [jnp.zeros((1,), bool), valid_sorted[1:] != valid_sorted[:-1]]
        )
    if agg in ("mean", "var", "std"):
        md = _mean_dtype(svals.dtype)
        sums = _segmented_total_at_start(svals, is_start, "sum")
        cnts = _segmented_total_at_start(None, is_start, "count")
        if agg == "mean":
            totals = sums.astype(md) / cnts.astype(md)
        else:
            sq = svals.astype(md) * svals.astype(md)
            sumsqs = _segmented_total_at_start(sq, is_start, "sum")
            totals = _moments_to_var(sums, sumsqs, cnts, agg, svals.dtype)
    else:
        totals = _segmented_total_at_start(svals, is_start, agg)
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    (gk, gv), count = _filter_columns(
        keep, (skeys, totals), config=cfg
    )
    return gk, gv, count


@functools.partial(jax.jit, static_argnames=("agg_ops", "config"))
def groupby_multi(
    key_columns,
    value_columns,
    agg_ops,
    *,
    valid: jnp.ndarray | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Multi-key, multi-aggregate group-by: ONE struct sort, one segmented
    reduction per aggregate, one compaction.

    Args:
      key_columns: sequence of equal-length key arrays (lexicographic group
        key — the decomposer protocol, like `sort_struct`).
      value_columns: sequence of value arrays, one per aggregate.
      agg_ops: tuple of "sum"/"count"/"min"/"max", one per value column
        (static). "count" ignores its value column (pass any column).
      valid: optional bool mask (the selection-vector protocol).

    Returns (key_columns_out, value_columns_out, count): rows [0, count)
    hold one row per distinct key tuple, key-ascending; aggregates align.
    """
    from cuda.radixsort_tpu.ops.sort import sort_struct as _sort_struct

    key_columns = tuple(key_columns)
    value_columns = tuple(value_columns)
    agg_ops = tuple(agg_ops)
    if len(agg_ops) != len(value_columns):
        raise ValueError("one agg per value column")
    for a in agg_ops:
        if a not in _AGGS:
            raise ValueError(a)
    cfg = config_lib.resolve(config)
    n = key_columns[0].shape[0]
    vals = tuple(jnp.ones((n,), jnp.int32) if a == "count" else v
                 for v, a in zip(value_columns, agg_ops))
    if n == 0:
        return key_columns, vals, jnp.zeros((), jnp.int32)
    if valid is None:
        skeys = _sort_struct(key_columns, vals, config=cfg)
        skeys, svals = skeys
        valid_sorted = None
    else:
        flag = jnp.logical_not(valid).astype(jnp.uint8)
        (sflag, *sk), svals = _sort_struct((flag,) + key_columns, vals,
                                           config=cfg)
        skeys = tuple(sk)
        valid_sorted = sflag == 0
    is_start = _group_starts(skeys, valid_sorted)
    seg_counts = (_segmented_total_at_start(None, is_start, "count")
                  if any(a in ("mean", "var", "std") for a in agg_ops)
                  else None)

    def _total(sv, a):
        if a in ("mean", "var", "std"):
            md = _mean_dtype(sv.dtype)
            s = _segmented_total_at_start(sv, is_start, "sum")
            if a == "mean":
                return s.astype(md) / seg_counts.astype(md)
            sq = sv.astype(md) * sv.astype(md)
            ssq = _segmented_total_at_start(sq, is_start, "sum")
            return _moments_to_var(s, ssq, seg_counts, a, sv.dtype)
        return _segmented_total_at_start(sv, is_start, a)

    totals = tuple(_total(sv, a) for sv, a in zip(svals, agg_ops))
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    cols, count = _filter_columns(keep, skeys + totals, config=cfg)
    nk = len(skeys)
    return cols[:nk], cols[nk:], count


def groupby_quantile(keys, values, qs=(0.5,), *, valid=None, config=None):
    """Public wrapper: normalizes `qs` (float | list | tuple) to the
    hashable static tuple the jitted implementation needs. `keys` may be
    one array or a tuple of key columns (composite group key): the return
    is then (key_columns_tuple, quantile_columns, count)."""
    if isinstance(qs, (int, float)):
        qs = (float(qs),)
    multi = isinstance(keys, (tuple, list))
    kc, qc, cnt = _groupby_quantile(
        tuple(keys) if multi else (keys,), values, tuple(qs), valid=valid,
        config=config)
    return (kc if multi else kc[0]), qc, cnt


@functools.partial(jax.jit, static_argnames=("qs", "config"))
def _groupby_quantile(
    key_columns,
    values: jnp.ndarray,
    qs: tuple = (0.5,),
    *,
    valid: jnp.ndarray | None = None,
    config: config_lib.SortConfig | None = None,
):
    """Per-group quantiles (linear interpolation, numpy's default) — the
    non-decomposable aggregate class: medians/percentiles need the group's
    sorted values, so the value column joins the SORT KEY ((validity, key,
    value) struct sort) and each quantile is two gathers + a lerp against
    the group's start position and size. All requested qs share the one
    sort.

    Returns (group_keys, quantile_columns: tuple aligned with qs, count);
    quantile columns are in the mean dtype (f32 for integer values).
    Distributed form: plan.py hash-exchanges whole rows (quantiles cannot
    travel as partials the way sum/mean moments do).
    """
    from cuda.radixsort_tpu.ops.sort import sort_struct as _sort_struct

    cfg = config_lib.resolve(config)
    key_columns = tuple(key_columns)
    n = key_columns[0].shape[0]
    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
    if n == 0:
        md = _mean_dtype(values.dtype)
        return (key_columns, tuple(jnp.zeros((0,), md) for _ in qs),
                jnp.zeros((), jnp.int32))
    if valid is None:
        sorted_cols = _sort_struct(key_columns + (values,), config=cfg)
        skeys, svals = tuple(sorted_cols[:-1]), sorted_cols[-1]
        valid_sorted = None
    else:
        flag = jnp.logical_not(valid).astype(jnp.uint8)
        sorted_cols = _sort_struct((flag,) + key_columns + (values,),
                                   config=cfg)
        skeys, svals = tuple(sorted_cols[1:-1]), sorted_cols[-1]
        valid_sorted = sorted_cols[0] == 0
    is_start = _group_starts(skeys, valid_sorted)
    pos = jnp.arange(n, dtype=jnp.int32)
    from cuda.radixsort_tpu.ops.scan import cumulative

    start = cumulative(jnp.where(is_start, pos, -1), "max")
    # gather-free selection (r3): rank-in-segment and segment size are
    # pure position arithmetic, valid at EVERY row; the quantile's floor/
    # ceil-rank rows are marked in place and their values transported back
    # to the segment-start row by a reversed segmented max (exactly one
    # marked row per segment).
    r = pos - start
    cnt_row = _segment_end_pos(is_start) - start + 1
    md = _mean_dtype(values.dtype)
    sv = svals.astype(md)
    if jnp.issubdtype(md, jnp.floating):
        miss = jnp.asarray(-jnp.inf, md)
    else:
        miss = jnp.asarray(jnp.iinfo(md).min, md)
    qcols = []
    for q in qs:
        # index math ALWAYS in f32: a low-precision value dtype (bf16/f16
        # mean dtype) would round (cnt-1)*q to the wrong element for large
        # groups; only the final lerp runs in the value's mean dtype
        idx_f = (cnt_row - 1).astype(jnp.float32) * jnp.float32(q)
        lo = jnp.floor(idx_f).astype(jnp.int32)
        hi = jnp.ceil(idx_f).astype(jnp.int32)
        frac = (idx_f - lo.astype(jnp.float32)).astype(md)
        vlo = _segmented_total_at_start(
            jnp.where(r == lo, sv, miss), is_start, "max")
        vhi = _segmented_total_at_start(
            jnp.where(r == hi, sv, miss), is_start, "max")
        qcols.append(vlo * (1 - frac) + vhi * frac)
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    cols, count = _filter_columns(keep, skeys + tuple(qcols),
                                  config=cfg)
    nk = len(skeys)
    return cols[:nk], cols[nk:], count
