"""Segmented scans (scan-by-key) — prefix scans that reset at run starts.

Parity: cub::DeviceScan::{Inclusive,Exclusive}{Sum,Scan}ByKey and
InclusiveScanInit (CUB device/device_scan.cuh:1144-1801): segments are
maximal runs of CONSECUTIVE keys equal under ``equality_op`` — a run-based
contract, not a global group-by (sort first, or use ops.aggregate.groupby,
for grouped semantics).

Two formulations, chosen by op and dtype:

* integer sum: one ``cumsum`` + one segment-start position fill
  (``cummax`` of marked positions — positions are monotone, so the fill is
  exact for ANY value sign) + one gather of the exclusive prefix at the
  segment start: out[i] = cs[i] - exc[start(i)].
* everything else (float sums, min/max/prod/custom associative op): a
  Hillis–Steele doubling scan with head-flag propagation — ceil(log2 n)
  unrolled steps, each a shift + where + op.

Exclusive scans shift values one slot right WITHIN each segment (head
slots take the operator identity) and run the same inclusive machinery; a
per-segment ``init`` then combines from the left, which is exactly CUB's
"init_value is applied to the first element of each segment" contract.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

_NAMED = {
    "sum": (jnp.add, lambda dt: jnp.zeros((), dt)),
    "prod": (jnp.multiply, lambda dt: jnp.ones((), dt)),
    "min": (jnp.minimum, lambda dt: (jnp.asarray(jnp.inf, dt)
                                     if jnp.issubdtype(dt, jnp.floating)
                                     else jnp.asarray(jnp.iinfo(dt).max, dt))),
    "max": (jnp.maximum, lambda dt: (jnp.asarray(-jnp.inf, dt)
                                     if jnp.issubdtype(dt, jnp.floating)
                                     else jnp.asarray(jnp.iinfo(dt).min, dt))),
}


def _resolve_op(op, identity, dtype, *, need_identity):
    if callable(op):
        if identity is None:
            if need_identity:
                raise ValueError("a callable op needs identity= (its "
                                 "neutral element) for exclusive scans")
            return op, None
        return op, jnp.asarray(identity, dtype)
    try:
        f, ident = _NAMED[op]
    except KeyError:
        raise ValueError(f"op must be callable or one of {list(_NAMED)}")
    return f, ident(dtype)


def _head_flags(keys, n, equality_op):
    """True where a new run of equal-consecutive keys begins."""
    cols = keys if isinstance(keys, (tuple, list)) else (keys,)
    if equality_op is None:
        neq = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            neq = neq | (c[1:] != c[:-1])
    else:
        if len(cols) != 1:
            raise ValueError("equality_op takes a single key column")
        neq = ~equality_op(cols[0][:-1], cols[0][1:])
    return jnp.concatenate([jnp.ones((1,), bool), neq])


def _segmented_cumsum(values, flags):
    """Inclusive segmented sum: cumsum minus the exclusive prefix at each
    segment's start (start positions are monotone -> exact cummax fill)."""
    n = values.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    cs = jnp.cumsum(values)
    exc = cs - values
    start = jax.lax.cummax(jnp.where(flags, pos, -1))
    return cs - jnp.take(exc, jnp.clip(start, 0, n - 1), axis=0)


def _segmented_doubling(values, flags, f):
    """Inclusive segmented scan for an arbitrary associative op: flagged
    Hillis–Steele doubling, ceil(log2 n) unrolled shift+where steps."""
    n = values.shape[0]
    v, fl = values, flags
    d = 1
    while d < n:
        pv = jnp.concatenate([v[:d], v[:-d]])   # v[i-d]; first d rows unused
        pf = jnp.concatenate([jnp.ones((d,), bool), fl[:-d]])
        in_range = jnp.arange(n, dtype=jnp.int32) >= d
        take = in_range & jnp.logical_not(fl)
        v = jnp.where(take, f(pv, v), v)
        fl = fl | jnp.where(in_range, pf, False)
        d *= 2
    return v


def cumulative(x, op):
    """Plain (unsegmented) inclusive scan with a named op "sum"/"min"/"max"
    (XLA's own cumulative lowerings). The general `plain_scan` below serves
    arbitrary/custom operators via the compat layers."""
    return {"max": jax.lax.cummax, "min": jax.lax.cummin,
            "sum": jnp.cumsum}[op](x)


def segmented_scan(
    values: jnp.ndarray,
    head_flags: jnp.ndarray,
    op="sum",
    *,
    identity=None,
    exclusive: bool = False,
    init=None,
):
    """Prefix-scan ``values`` with ``op``, restarting at every True in
    ``head_flags`` (position 0 is always a segment head).

    exclusive=True shifts the scan right within each segment; ``init``
    (optional) is combined from the left into every output element of the
    segment — for an inclusive scan this is CUB's InclusiveScanInit, for
    an exclusive scan it seeds each segment (ExclusiveScanByKey).
    """
    f, ident = _resolve_op(op, identity, values.dtype,
                           need_identity=exclusive)
    n = values.shape[0]
    if n == 0:
        return values
    flags = jnp.concatenate(
        [jnp.ones((1,), bool), head_flags.astype(bool)[1:]])
    if exclusive:
        shifted = jnp.concatenate([jnp.full((1,), ident, values.dtype),
                                   values[:-1]])
        values = jnp.where(flags, ident, shifted)
    # sum fast path: ints only — the cumsum-difference trick subtracts two
    # GLOBAL prefixes, so float error would scale with the whole array's
    # magnitude (catastrophic cancellation near segment starts); floats
    # take the doubling path, which only ever combines within segments.
    if op == "sum" and jnp.issubdtype(values.dtype, jnp.integer):
        out = _segmented_cumsum(values, flags)
    else:
        out = _segmented_doubling(values, flags, f)
    if init is not None:
        out = f(jnp.asarray(init, values.dtype), out)
    return out


def plain_scan(values, op, *, identity=None, exclusive: bool = False,
               init=None):
    """Whole-array prefix scan on the same compact-primitive machinery
    (one all-False flag set) — the associative_scan-free path the compat
    layers (DeviceScan/thrust) use for custom operators."""
    n = values.shape[0]
    if n == 0:
        return values
    flags = jnp.zeros((n,), bool)
    return segmented_scan(values, flags, op, identity=identity,
                          exclusive=exclusive, init=init)


def reduce_with(values, op, init=None, *, identity=None):
    """Whole-array reduction for an arbitrary associative op: a log-depth
    pairwise fold (halving loop) — no scan primitive, no n-step loop."""
    f, _ = _resolve_op(op, identity, values.dtype, need_identity=False)
    v = values
    while v.shape[0] > 1:
        m = v.shape[0] // 2
        head = f(v[:m], v[m:2 * m])
        v = (head if v.shape[0] % 2 == 0
             else jnp.concatenate([head, v[-1:]]))
    total = v[0]
    if init is not None:
        total = f(jnp.asarray(init, values.dtype), total)
    return total


@functools.partial(
    jax.jit,
    static_argnames=("op", "equality_op", "exclusive"),
)
def scan_by_key(
    keys,
    values: jnp.ndarray,
    op="sum",
    *,
    identity=None,
    exclusive: bool = False,
    init=None,
    equality_op: Callable | None = None,
):
    """Scan ``values`` within runs of consecutive equal ``keys``.

    ``keys`` may be one array or a tuple of equal-length arrays (runs break
    where ANY column changes). op: "sum"|"prod"|"min"|"max" or an
    associative callable (then pass identity=). Matches
    cub::DeviceScan::*ByKey semantics (run-based segments, per-segment
    init for exclusive scans).
    """
    n = values.shape[0]
    if n == 0:
        return values
    heads = _head_flags(keys, n, equality_op)
    return segmented_scan(values, heads, op, identity=identity,
                          exclusive=exclusive, init=init)
