"""Window functions — per-partition ranks, cumulatives, and shifts.

Reference scope: beyond the CUDA reference (its user story ends at sort);
this is the query-pipeline generalization the BASELINE contract's pipelined
query demands (BASELINE.json:11) — the SQL `OVER (PARTITION BY p ORDER BY
o)` family, built entirely from the framework's own primitives:

  one struct sort (validity limb + partition + order key, the decomposer
  protocol of ops/sort.py) -> every window column is ONE fused segmented
  scan over the partition runs (ops/scan.py monoid) or one masked shift.

No per-partition launches, no ragged anything: a 1-row and a 1M-row
partition cost the same per-row work, and all window columns for a call
share the single sort.

Output rows are REORDERED to (partition, order) — the natural order of the
computation. SQL engines that preserve input order pay a second sort back;
callers that want that can carry an index column and order_by it after.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.scan import segmented_scan
from cuda.radixsort_tpu.ops.sort import sort_struct

WINDOW_FNS = ("row_number", "rank", "dense_rank", "cumsum", "cummin",
              "cummax", "lag", "lead")

_SCAN_OP = {"cumsum": "sum", "cummin": "min", "cummax": "max"}


@functools.partial(
    jax.jit, static_argnames=("outputs", "descending", "config")
)
def window(
    part: jnp.ndarray,
    order: jnp.ndarray,
    values,
    outputs,
    *,
    valid: jnp.ndarray | None = None,
    descending: bool = False,
    config: config_lib.SortConfig | None = None,
):
    """Compute window columns over partitions of `part` ordered by `order`.

    values: a dict of named payload columns (carried through the sort).
    outputs: tuple of (out_name, source_column_name_or_None, fn) with fn in
    WINDOW_FNS; source is None for row_number/rank/dense_rank and a key of
    `values` otherwise. `valid`: optional bool mask — invalid rows sink to
    the tail and never contribute (they break partition runs by the
    validity limb). descending orders each partition by `order` descending.

    Returns (part_sorted, order_sorted, values_sorted: dict,
    window_cols: dict, count) — rows [0, count) valid, grouped by
    partition, ordered within each partition.
    """
    n = part.shape[0]
    if order.shape[0] != n:
        raise ValueError("part/order length mismatch")
    for name, src, fn in outputs:
        if fn not in WINDOW_FNS:
            raise ValueError(f"{fn!r} not in {WINDOW_FNS}")
        if fn in ("row_number", "rank", "dense_rank"):
            if src is not None:
                raise ValueError(f"{fn} takes no source column")
        elif src not in values:
            raise ValueError(f"{name}: unknown source column {src!r}")
    if n == 0:
        empty = {name: jnp.zeros((0,), jnp.int32 if src is None
                                  else values[src].dtype)
                 for name, src, fn in outputs}
        return part, order, dict(values), empty, jnp.zeros((), jnp.int32)
    if valid is None:
        valid = jnp.ones((n,), bool)
    # validity limb: invalid rows sort last whatever `descending` says
    flag = (valid if descending else jnp.logical_not(valid)).astype(jnp.uint8)
    (sflag, spart, sorder), sv = sort_struct(
        (flag, part, order), dict(values), descending=descending,
        config=config)
    count = jnp.sum(valid.astype(jnp.int32))

    # partition runs: break on partition change OR validity-limb change, so
    # the invalid tail never chains onto the last real partition
    heads = jnp.concatenate([
        jnp.ones((1,), bool),
        (spart[1:] != spart[:-1]) | (sflag[1:] != sflag[:-1]),
    ])
    # ranks are pure position arithmetic over monotone start-position
    # fills (cummax of marked positions) — no scans at all:
    #   row_number = pos - partition_start + 1
    #   rank       = peer_run_start - partition_start + 1
    pos = jnp.arange(n, dtype=jnp.int32)
    from cuda.radixsort_tpu.ops.scan import cumulative

    part_start = cumulative(jnp.where(heads, pos, -1), "max")
    row_number = pos - part_start + 1
    # peer runs (equal order value within a partition) drive rank/dense_rank
    peer_heads = heads | jnp.concatenate(
        [jnp.ones((1,), bool), sorder[1:] != sorder[:-1]])
    peer_start = cumulative(jnp.where(peer_heads, pos, -1), "max")

    out_cols = {}
    for name, src, fn in outputs:
        if fn == "row_number":
            out_cols[name] = row_number
        elif fn == "rank":
            out_cols[name] = peer_start - part_start + 1
        elif fn == "dense_rank":
            out_cols[name] = segmented_scan(
                peer_heads.astype(jnp.int32), heads, "sum")
        elif fn in _SCAN_OP:
            out_cols[name] = segmented_scan(sv[src], heads, _SCAN_OP[fn])
        elif fn == "lag":
            v = sv[src]
            shifted = jnp.concatenate([v[:1], v[:-1]])
            out_cols[name] = jnp.where(heads, jnp.zeros((), v.dtype),
                                       shifted)
        elif fn == "lead":
            v = sv[src]
            shifted = jnp.concatenate([v[1:], v[-1:]])
            tails = jnp.concatenate([heads[1:], jnp.ones((1,), bool)])
            out_cols[name] = jnp.where(tails, jnp.zeros((), v.dtype),
                                       shifted)
    return spart, sorder, sv, out_cols, count


def window_table(
    cols,
    partition_by: str,
    order_by: str,
    spec,
    *,
    valid=None,
    descending: bool = False,
    config=None,
):
    """Shared stage body for Query.window / Table.window / the distributed
    plan: one collision check, one payload assembly, one output-dict
    assembly. A window source may name ANY column — including the
    partition or order column itself (the canonical running-total
    `cumsum over the order key` case): those ride the sort a second time
    as payload so the scan sees them aligned.

    Returns (out_cols: dict with all input columns (reordered) + window
    columns, count)."""
    for n_, _, _ in spec:
        if n_ in cols:
            raise ValueError(f"window output {n_!r} collides with an "
                             "existing column")
    needed = {src for _, src, _ in spec if src is not None}
    payload = {k: v for k, v in cols.items()
               if k not in (partition_by, order_by) or k in needed}
    sp, so, sv, wcols, cnt = window(
        cols[partition_by], cols[order_by], payload, spec, valid=valid,
        descending=descending, config=config)
    out = dict(sv)
    out[partition_by] = sp
    out[order_by] = so
    out.update(wcols)
    return out, cnt
