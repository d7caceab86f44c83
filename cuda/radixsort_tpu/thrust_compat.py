"""Thrust-shaped container API — the reference stack's L5 layer.

Reference parity: `thrust::sort` / `sort_by_key` / `stable_sort*` and their
companion algorithms, as dispatched by thrust's CUDA backend (THRUST
system/cuda/detail/sort.h). The routing rule is transplanted verbatim in
spirit: `can_use_primitive_sort` (sort.h:310-326) — an arithmetic key under
`less`/`greater` — takes the sort engine; any other comparator
takes the comparison-sort path (here the comparator network of
`ops/comparator_sort.py`, thrust's merge sort, sort.h:333-337).

Platform differences, stated not hidden:
  * functional: every algorithm returns its result instead of mutating a
    `device_vector` in place;
  * compacting algorithms (`copy_if`, `unique`, `partition`, ...) return
    ``(padded_output, count)`` — XLA shapes are static, so the valid prefix
    plus a count plays the role of thrust's returned end-iterator;
  * execution policies/streams are unnecessary (XLA schedules) and omitted.

Usage:

    from cuda.radixsort_tpu import thrust_compat as thrust

    s = thrust.sort(keys)
    k, v = thrust.sort_by_key(keys, values)
    s = thrust.sort(recs, comp=lambda a, b: a["score"] > b["score"])
    kept, n = thrust.copy_if(x, lambda v: v % 3 == 0)
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu.ops.comparator_sort import (  # noqa: F401
    Greater,
    Less,
    comparator_sort,
    greater,
    less,
    primitive_comparator,
)


# ---------------------------------------------------------------------------
# sort family (THRUST sort.h smart_sort)
# ---------------------------------------------------------------------------


def sort(keys, comp: Callable = less, *, config=None):
    """thrust::sort. Stable on the primitive path (the sort engines are
    stable); comparator path leaves equal keys in unspecified order, exactly
    thrust's contract for plain `sort`."""
    prim, desc = primitive_comparator(comp)
    if prim and hasattr(keys, "dtype"):
        from cuda.radixsort_tpu.ops.sort import sort as _sort

        return _sort(keys, descending=desc, config=config)
    return comparator_sort(keys, comp, stable=False)


def stable_sort(keys, comp: Callable = less, *, config=None):
    """thrust::stable_sort."""
    prim, desc = primitive_comparator(comp)
    if prim and hasattr(keys, "dtype"):
        from cuda.radixsort_tpu.ops.sort import sort as _sort

        return _sort(keys, descending=desc, config=config)
    return comparator_sort(keys, comp, stable=True)


def sort_by_key(keys, values, comp: Callable = less, *, config=None):
    """thrust::sort_by_key → (sorted_keys, permuted_values). `values` may be
    a pytree of equal-length arrays (a zip_iterator of columns)."""
    return _sort_by_key(keys, values, comp, stable=False, config=config)


def stable_sort_by_key(keys, values, comp: Callable = less, *, config=None):
    """thrust::stable_sort_by_key."""
    return _sort_by_key(keys, values, comp, stable=True, config=config)


def _sort_by_key(keys, values, comp, *, stable, config):
    prim, desc = primitive_comparator(comp)
    if prim and hasattr(keys, "dtype"):
        from cuda.radixsort_tpu.ops.sort import argsort, sort_pairs

        # sort_pairs rides flat u32 planes through the engines, so every
        # flattened value leaf must be rank-1. 2-D leaves with few narrow
        # columns (an (N, 3) point column) split into per-column planes and
        # ride the same sort; anything wider/deeper falls back to the
        # permutation route.
        leaves = jax.tree_util.tree_leaves(values)
        splittable = all(
            getattr(v, "ndim", 1) == 1
            or (v.ndim == 2 and v.shape[1] <= 8
                and jnp.dtype(v.dtype).itemsize <= 4)
            for v in leaves)
        if splittable and any(getattr(v, "ndim", 1) != 1 for v in leaves):
            def split(v):
                return tuple(v[:, j] for j in range(v.shape[1])) \
                    if v.ndim == 2 else v

            cols = jax.tree_util.tree_map(split, values)
            ok, ocols = sort_pairs(keys, cols, descending=desc,
                                   config=config)
            outer = jax.tree_util.tree_structure(
                values, is_leaf=lambda x: hasattr(x, "ndim"))
            ocols_by_leaf = outer.flatten_up_to(ocols)
            out = outer.unflatten([
                jnp.stack(o, axis=1) if isinstance(o, tuple) else o
                for o in ocols_by_leaf])
            return ok, out
        if any(getattr(v, "ndim", 1) != 1 for v in leaves):
            perm = argsort(keys, descending=desc, config=config)
            return keys[perm], jax.tree_util.tree_map(
                lambda v: jnp.take(v, perm, axis=0), values)
        # thrust::sort_by_key does not promise equal-key payload order
        # (THRUST sort.h smart_sort radix path); the stable order is one
        # valid answer. Pytree values (zip_iterator analogue) ride the same
        # multi-operand sort.
        return sort_pairs(keys, values, descending=desc, config=config)
    return comparator_sort(keys, comp, values=values, stable=stable)


def is_sorted(keys, comp: Callable = less) -> jnp.ndarray:
    """thrust::is_sorted — no adjacent pair strictly out of order."""
    if hasattr(keys, "dtype"):
        a, b = keys[:-1], keys[1:]
    else:
        a = jax.tree_util.tree_map(lambda x: x[:-1], keys)
        b = jax.tree_util.tree_map(lambda x: x[1:], keys)
    return jnp.logical_not(jnp.any(comp(b, a)))


def is_sorted_until(keys, comp: Callable = less) -> jnp.ndarray:
    """thrust::is_sorted_until — length of the sorted prefix."""
    if hasattr(keys, "dtype"):
        a, b = keys[:-1], keys[1:]
    else:
        a = jax.tree_util.tree_map(lambda x: x[:-1], keys)
        b = jax.tree_util.tree_map(lambda x: x[1:], keys)
    bad = comp(b, a)
    n = bad.shape[0] + 1
    first_bad = jnp.argmax(bad)  # 0 if none — disambiguate with any()
    return jnp.where(jnp.any(bad), first_bad + 1, n).astype(jnp.int32)


# ---------------------------------------------------------------------------
# merge / set-style companions
# ---------------------------------------------------------------------------


def merge(a, b, comp: Callable = less, *, config=None):
    """thrust::merge of two sorted ranges (primitive comparators)."""
    from cuda.radixsort_tpu.ops.merge import merge_sorted

    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError(
            "thrust_compat.merge supports less/greater; for custom "
            "comparators sort the concatenation with stable_sort")
    return merge_sorted(a, b, descending=desc, config=config)


def merge_by_key(a_keys, a_values, b_keys, b_values, comp: Callable = less,
                 *, config=None):
    """thrust::merge_by_key (stable: ties keep a-before-b)."""
    from cuda.radixsort_tpu.ops.merge import merge_sorted_pairs

    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError(
            "thrust_compat.merge_by_key supports less/greater")
    return merge_sorted_pairs(a_keys, a_values, b_keys, b_values,
                              descending=desc, config=config)


def set_intersection(a, b, *, config=None):
    """thrust::set_intersection (sorted multiset semantics) → (padded,
    count)."""
    from cuda.radixsort_tpu.ops.setops import set_intersection as _f

    return _f(a, b, config=config)


def set_union(a, b, *, config=None):
    """thrust::set_union → (padded, count)."""
    from cuda.radixsort_tpu.ops.setops import set_union as _f

    return _f(a, b, config=config)


def set_difference(a, b, *, config=None):
    """thrust::set_difference → (padded, count)."""
    from cuda.radixsort_tpu.ops.setops import set_difference as _f

    return _f(a, b, config=config)


def set_symmetric_difference(a, b, *, config=None):
    """thrust::set_symmetric_difference → (padded, count)."""
    from cuda.radixsort_tpu.ops.setops import set_symmetric_difference as _f

    return _f(a, b, config=config)


def unique(keys, *, config=None):
    """thrust::unique (consecutive dedup) → (padded_keys, count)."""
    from cuda.radixsort_tpu.ops.unique import unique as _unique

    return _unique(keys, config=config)


def unique_by_key(keys, values, *, config=None):
    """thrust::unique_by_key → (keys, values, count)."""
    from cuda.radixsort_tpu.cub_compat import DeviceSelect

    return DeviceSelect.UniqueByKey(keys, values, config=config)


def unique_count(keys) -> jnp.ndarray:
    """thrust::unique_count — number of consecutive-equal runs."""
    from cuda.radixsort_tpu.ops.unique import _run_starts

    return jnp.sum(_run_starts(keys).astype(jnp.int32))


# ---------------------------------------------------------------------------
# partition / selection
# ---------------------------------------------------------------------------


def copy_if(x, pred: Callable, *, config=None):
    """thrust::copy_if → (padded_kept_rows, count)."""
    from cuda.radixsort_tpu.ops.filter import filter_columns

    (out,), count = filter_columns(pred(x), (x,), config=config)
    return out, count


def remove_if(x, pred: Callable, *, config=None):
    """thrust::remove_if → (padded_kept_rows, count) of rows NOT matching."""
    from cuda.radixsort_tpu.ops.filter import filter_columns

    (out,), count = filter_columns(jnp.logical_not(pred(x)), (x,),
                                   config=config)
    return out, count


def stable_partition(x, pred: Callable, *, config=None):
    """thrust::stable_partition → (reordered, num_true): rows [0, num_true)
    satisfy pred, rows [num_true, n) do not; BOTH halves keep input order
    (stronger than thrust, which only guarantees it for stable_partition)."""
    from cuda.radixsort_tpu.ops.filter import filter_columns

    m = pred(x)
    (head,), count = filter_columns(m, (x,), config=config)
    (tail,), _ = filter_columns(jnp.logical_not(m), (x,), config=config)
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(idx < count, head, jnp.take(tail, idx - count)), count


partition = stable_partition  # our partition is always the stable one


def partition_copy(x, pred: Callable, *, config=None):
    """thrust::partition_copy → (true_rows, false_rows, num_true)."""
    from cuda.radixsort_tpu.ops.filter import filter_columns

    m = pred(x)
    (head,), count = filter_columns(m, (x,), config=config)
    (tail,), _ = filter_columns(jnp.logical_not(m), (x,), config=config)
    return head, tail, count


def partition_point(x, pred: Callable) -> jnp.ndarray:
    """thrust::partition_point on an already-partitioned range."""
    m = pred(x).astype(jnp.int32)
    return jnp.sum(m)


# ---------------------------------------------------------------------------
# reductions / scans / misc (the container-API staples around the sorts)
# ---------------------------------------------------------------------------


def reduce(x, init=None, binary_op: Callable | None = None):
    """thrust::reduce (associative binary_op; defaults to plus/0)."""
    if binary_op is None:
        total = jnp.sum(x)
        return total if init is None else total + jnp.asarray(init, x.dtype)
    from cuda.radixsort_tpu.ops.scan import reduce_with

    return reduce_with(x, binary_op, init)


def reduce_by_key(keys, values, binary_op: str = "sum", *, config=None):
    """thrust::reduce_by_key — reduce runs of CONSECUTIVE equal keys
    (run-based, not a global group-by; sort first for that, or use
    `ops.aggregate.groupby`). binary_op: "sum" | "min" | "max" | "prod".

    Returns (unique_keys, reduced_values, num_runs), padded past num_runs.
    """
    from cuda.radixsort_tpu.ops.unique import _run_starts, unique as _unique

    seg_reduce = {
        "sum": jax.ops.segment_sum,
        "min": jax.ops.segment_min,
        "max": jax.ops.segment_max,
        "prod": jax.ops.segment_prod,
    }[binary_op]
    starts = _run_starts(keys)
    run_id = jnp.cumsum(starts.astype(jnp.int32)) - 1
    uk, count = _unique(keys, config=config)
    red = seg_reduce(values, run_id, num_segments=keys.shape[0])
    return uk, red, count


def inclusive_scan(x, binary_op: Callable | None = None):
    """thrust::inclusive_scan."""
    if binary_op is None:
        return jnp.cumsum(x, dtype=x.dtype)
    from cuda.radixsort_tpu.ops.scan import plain_scan

    return plain_scan(x, binary_op)


def exclusive_scan(x, init=0, binary_op: Callable | None = None):
    """thrust::exclusive_scan."""
    if binary_op is None:
        return jnp.cumsum(x, dtype=x.dtype) - x + jnp.asarray(init, x.dtype)
    from cuda.radixsort_tpu.ops.scan import plain_scan

    init = jnp.asarray(init, x.dtype)
    inc = plain_scan(x, binary_op)
    return jnp.concatenate([init[None], binary_op(init, inc[:-1])])


def count(x, value) -> jnp.ndarray:
    """thrust::count."""
    return jnp.sum((x == value).astype(jnp.int32))


def count_if(x, pred: Callable) -> jnp.ndarray:
    """thrust::count_if."""
    return jnp.sum(pred(x).astype(jnp.int32))


def gather(index_map, src):
    """thrust::gather — out[i] = src[map[i]]."""
    return jnp.take(src, index_map, axis=0)


def scatter(src, index_map, out_len: int):
    """thrust::scatter — out[map[i]] = src[i] (map must be a permutation
    into [0, out_len); XLA lowers this to its native scatter)."""
    out = jnp.zeros((out_len,) + src.shape[1:], src.dtype)
    return out.at[index_map].set(src)


def sequence(n: int, init=0, step=1, dtype=jnp.int32):
    """thrust::sequence."""
    return jnp.asarray(init, dtype) + jnp.arange(n, dtype=dtype) * \
        jnp.asarray(step, dtype)


def min_element(x, comp: Callable = less) -> jnp.ndarray:
    """thrust::min_element → index of the first minimum."""
    prim, desc = primitive_comparator(comp)
    if prim:
        return (jnp.argmax(x) if desc else jnp.argmin(x)).astype(jnp.int32)
    from cuda.radixsort_tpu.ops.comparator_sort import comparator_argsort

    return comparator_argsort(x, comp, stable=True)[0]


def max_element(x, comp: Callable = less) -> jnp.ndarray:
    """thrust::max_element → index of the first maximum."""
    prim, desc = primitive_comparator(comp)
    if prim:
        return (jnp.argmin(x) if desc else jnp.argmax(x)).astype(jnp.int32)
    from cuda.radixsort_tpu.ops.comparator_sort import comparator_argsort

    # stable sort under the REVERSED order puts the first maximum at 0
    return comparator_argsort(x, lambda a, b: comp(b, a), stable=True)[0]


def lower_bound(sorted_x, queries, comp: Callable = less) -> jnp.ndarray:
    """thrust::lower_bound (vectorized searchsorted, primitive orders)."""
    return _bound(sorted_x, queries, comp, "left")


def upper_bound(sorted_x, queries, comp: Callable = less) -> jnp.ndarray:
    """thrust::upper_bound."""
    return _bound(sorted_x, queries, comp, "right")


def binary_search(sorted_x, queries, comp: Callable = less) -> jnp.ndarray:
    """thrust::binary_search — membership flags."""
    lo = _bound(sorted_x, queries, comp, "left")
    hi = _bound(sorted_x, queries, comp, "right")
    return hi > lo


def _bound(sorted_x, queries, comp, side):
    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError("bounds support less/greater comparators")
    if desc:
        flip = {"left": "right", "right": "left"}[side]
        rev = sorted_x[::-1]
        pos = jnp.searchsorted(rev, queries, side=flip)
        return (sorted_x.shape[0] - pos).astype(jnp.int32)
    return jnp.searchsorted(sorted_x, queries, side=side).astype(jnp.int32)


# ---------------------------------------------------------------------------
# scans by key (thrust::inclusive_scan_by_key / exclusive_scan_by_key) —
# run-based segments (consecutive equal keys), ops/scan.py monoid
# ---------------------------------------------------------------------------


def inclusive_scan_by_key(keys, values, binary_op=None,
                          binary_pred: Callable | None = None):
    """thrust::inclusive_scan_by_key (segments = consecutive equal keys)."""
    from cuda.radixsort_tpu.ops.scan import scan_by_key

    op = "sum" if binary_op is None else binary_op
    return scan_by_key(keys, values, op, equality_op=binary_pred)


def exclusive_scan_by_key(keys, values, init=0, binary_op=None,
                          binary_pred: Callable | None = None, *,
                          identity=None):
    """thrust::exclusive_scan_by_key — init seeds every segment. A callable
    binary_op needs identity= (its neutral element)."""
    from cuda.radixsort_tpu.ops.scan import scan_by_key

    op = "sum" if binary_op is None else binary_op
    return scan_by_key(keys, values, op, exclusive=True, init=init,
                       identity=identity, equality_op=binary_pred)


# ---------------------------------------------------------------------------
# elementwise / transform family — these exist so thrust call sites
# port 1:1; XLA fuses them into neighbors (DeviceTransform's rationale)
# ---------------------------------------------------------------------------


def for_each(x, op: Callable):
    """thrust::for_each — functional: returns op applied elementwise."""
    return jax.vmap(op)(x)


def transform(op: Callable, *xs):
    """thrust::transform (unary/binary/n-ary)."""
    return jax.vmap(op)(*xs)


def transform_reduce(x, unary_op: Callable, init, binary_op: Callable):
    """thrust::transform_reduce."""
    from cuda.radixsort_tpu.ops.scan import reduce_with

    return reduce_with(jax.vmap(unary_op)(x), binary_op, init)


def transform_inclusive_scan(x, unary_op: Callable, binary_op: Callable):
    """thrust::transform_inclusive_scan."""
    from cuda.radixsort_tpu.ops.scan import plain_scan

    return plain_scan(jax.vmap(unary_op)(x), binary_op)


def transform_exclusive_scan(x, unary_op: Callable, init,
                             binary_op: Callable):
    """thrust::transform_exclusive_scan."""
    from cuda.radixsort_tpu.ops.scan import plain_scan

    t = jax.vmap(unary_op)(x)
    ini = jnp.asarray(init, t.dtype)
    inc = plain_scan(t, binary_op)
    return jnp.concatenate([ini[None], binary_op(ini, inc[:-1])])


def tabulate(n: int, op: Callable):
    """thrust::tabulate — op over [0, n)."""
    return jax.vmap(op)(jnp.arange(n))


def fill(x, value):
    """thrust::fill."""
    return jnp.full_like(x, value)


def replace(x, old_value, new_value):
    """thrust::replace."""
    return jnp.where(x == jnp.asarray(old_value, x.dtype),
                     jnp.asarray(new_value, x.dtype), x)


def replace_if(x, pred: Callable, new_value):
    """thrust::replace_if."""
    return jnp.where(pred(x), jnp.asarray(new_value, x.dtype), x)


def adjacent_difference(x, binary_op: Callable | None = None):
    """thrust::adjacent_difference (out[0] = x[0], CUB SubtractLeft)."""
    op = jnp.subtract if binary_op is None else binary_op
    return jnp.concatenate([x[:1], op(x[1:], x[:-1])])


def inner_product(a, b, init=0):
    """thrust::inner_product."""
    return jnp.asarray(init, a.dtype) + jnp.sum(a * b)


def reverse(x):
    """thrust::reverse."""
    return x[::-1]


def swap_ranges(a, b):
    """thrust::swap_ranges — functional: returns (b, a)."""
    return b, a


# ---------------------------------------------------------------------------
# predicates / search (thrust reductions over predicates)
# ---------------------------------------------------------------------------


def all_of(x, pred: Callable) -> jnp.ndarray:
    """thrust::all_of."""
    return jnp.all(pred(x))


def any_of(x, pred: Callable) -> jnp.ndarray:
    """thrust::any_of."""
    return jnp.any(pred(x))


def none_of(x, pred: Callable) -> jnp.ndarray:
    """thrust::none_of."""
    return ~jnp.any(pred(x))


def find(x, value) -> jnp.ndarray:
    """thrust::find — index of first occurrence, len(x) if absent."""
    return find_if(x, lambda v: v == jnp.asarray(value, x.dtype))


def find_if(x, pred: Callable) -> jnp.ndarray:
    """thrust::find_if — index of first match, len(x) if none."""
    m = pred(x)
    return jnp.where(jnp.any(m), jnp.argmax(m), x.shape[0]).astype(jnp.int32)


def mismatch(a, b) -> jnp.ndarray:
    """thrust::mismatch — first index where a and b differ (len if equal)."""
    m = a != b
    return jnp.where(jnp.any(m), jnp.argmax(m), a.shape[0]).astype(jnp.int32)


def equal(a, b) -> jnp.ndarray:
    """thrust::equal."""
    return jnp.all(a == b)
