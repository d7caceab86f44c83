"""Declarative query plans over Table — the engine's logical-plan driver.

The reference stack's user story ends at `thrust::sort`; this framework's
BASELINE contract extends it to pipelined queries (filter -> sort -> join,
BASELINE.json:11). `pipeline/query.py` hand-fuses the flagship shape; this
module is the general form: a small immutable logical plan (`Query`) whose
stages lower onto the measured operator set, threading the static-shape
validity protocol (rows [0, count) valid) through every stage — compacted
tables carry real-but-dropped rows in their tails, so every stage masks by
row position, never by sentinel keys.

    q = (Query(orders)
         .where(lambda t: t["amount"] > 100)
         .join(parts, on="part", value="price")
         .groupby("part", "amount", agg="sum")
         .order_by("amount", descending=True)
         .limit(10))
    out, count, stats = q.run()
    print(q.explain())

Every stage's row count lands in `stats` (SURVEY §5 observability). `run()`
executes eagerly stage-by-stage (each operator is jitted internally); for a
single end-to-end jit, close over the plan: `jax.jit(lambda t: Query(t)...
.run())` — Table is a pytree, plans are static structure.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.table import Table


class _Stage(NamedTuple):
    op: str
    args: tuple
    kwargs: dict


class Query:
    """Immutable logical plan over a source Table (or a (Table, count) pair
    whose tail rows are already invalid)."""

    def __init__(self, source: Table, *, _count=None, _stages=()):
        self._source = source
        self._count = _count
        self._stages = tuple(_stages)

    def _with(self, op: str, *args, **kwargs) -> "Query":
        return Query(self._source, _count=self._count,
                     _stages=self._stages + (_Stage(op, args, kwargs),))

    # -- plan builders -------------------------------------------------------
    def where(self, pred: Callable[[Table], jnp.ndarray]) -> "Query":
        """Keep rows where pred(table) is True (stable compaction)."""
        return self._with("where", pred)

    def select(self, *names: str) -> "Query":
        """Project to the named columns."""
        return self._with("select", tuple(names))

    def with_column(self, name: str,
                    fn: Callable[[Table], jnp.ndarray]) -> "Query":
        """Add a computed column (elementwise over the table)."""
        return self._with("with_column", name, fn)

    def join(self, build: Table, *, on, value: str | None = None,
             how: str = "inner", build_count=None) -> "Query":
        """Join against `build[on]`. `on` is one column name or a tuple of
        names (composite equality key — the decomposer protocol drives the
        underlying struct sort). how: "inner" (brings `build[value]`
        across), "left" (all rows + a bool `matched` column), "semi"/"anti"
        (existence filters — probe rows with/without a match; no value).
        `build_count` marks a compacted build side's valid prefix.
        how="right"/"full" additionally emit unmatched build rows (their
        probe columns zero-filled, probe_idx -1 semantics, matched False)."""
        if how not in ("inner", "left", "semi", "anti", "right", "full"):
            raise ValueError(how)
        if how in ("inner", "left", "right", "full") and value is None:
            raise ValueError(f"how={how!r} needs value=")
        on = tuple(on) if isinstance(on, (tuple, list)) else on
        return self._with("join", build, on, value, build_count, how)

    def groupby(self, key: str, value: str, *, agg: str = "sum") -> "Query":
        """Group by `key`, reduce `value` (agg: sum/count/min/max/mean/
        var/std/median). Output columns: key, value —
        or key, `agg` when value names the key column itself (e.g.
        groupby("x", "x", agg="count") yields columns x, count)."""
        return self._with("groupby", key, value, agg)

    def groupby_agg(self, keys, aggs: dict) -> "Query":
        """Multi-key, multi-aggregate group-by: `keys` is a sequence of
        grouping columns, `aggs` maps out_name -> (value_column, agg) with
        agg in sum/count/min/max/mean/var/std/median."""
        return self._with("groupby_agg", tuple(keys),
                          tuple((n, v, a) for n, (v, a) in aggs.items()))

    def quantiles(self, key: str, value: str, qs=(0.25, 0.5, 0.75), *,
                  names=None, max_groups: int | None = None) -> "Query":
        """Per-group quantiles of `value` grouped by `key` (linear
        interpolation; all qs share one sort). Output columns: key plus one
        per q — `names` or "q25"-style defaults.

        max_groups: planner hint — the caller asserts the distinct group
        count is <= max_groups. Distributed runs then use histogram
        refinement (parallel.dselect.quantile_refine_shard): per 4-bit
        level the only collective is one psum'd (targets, 16) histogram —
        no row ever leaves its device — instead of hash-exchanging the raw
        (key, value) table. Requires <=32-bit key/value dtypes. If the
        assertion is violated, only the max_groups key-smallest groups are
        returned (use parallel.dselect.groupby_quantile_distributed
        directly to detect truncation via its n_groups output).
        Single-chip runs ignore the hint.

        Without a hint, distributed runs AUTO-ROUTE: if every earlier
        stage only filters/projects/adds columns and a cheap capped
        distinct count on the source key column (one local sort + one
        (64,) all_gather, run before the plan traces) proves <=64 groups,
        the refinement path is taken with max_groups=64 — the hint is
        only needed to raise that bound or when the key column is derived."""
        qs = tuple(float(q) for q in (qs if isinstance(qs, (tuple, list))
                                      else (qs,)))
        if names is None:
            names = tuple(f"q{round(q * 100)}" for q in qs)
        names = tuple(names)
        if len(names) != len(qs):
            raise ValueError(f"{len(names)} names for {len(qs)} qs")
        if len(set(names)) != len(names) or key in names:
            raise ValueError(f"quantile output names collide: {names}")
        return self._with("quantiles", key, value, qs, names, max_groups)

    def distinct(self, *keys: str) -> "Query":
        """Deduplicate rows by the named columns (all columns when none
        given); output rows are the distinct key tuples, key-ascending,
        projected to those columns."""
        return self._with("distinct", tuple(keys))

    def window(self, partition_by: str, order_by: str, outputs: dict, *,
               descending: bool = False) -> "Query":
        """Append window columns over `OVER (PARTITION BY partition_by
        ORDER BY order_by)`: `outputs` maps out_name -> fn for
        row_number/rank/dense_rank, or out_name -> (value_column, fn) for
        cumsum/cummin/cummax/lag/lead. Rows are reordered to (partition,
        order); the valid prefix is unchanged."""
        spec = tuple(
            (n, None, v) if isinstance(v, str) else (n, v[0], v[1])
            for n, v in outputs.items())
        return self._with("window", partition_by, order_by, spec,
                          descending)

    def order_by(self, *keys: str, key: str | None = None,
                 descending: bool = False) -> "Query":
        """Stable lexicographic sort by one or more columns (most
        significant first); invalid tail rows stay in the tail. `key=` is
        accepted for the original single-column signature."""
        if key is not None:
            keys = keys + (key,)
        if not keys:
            raise ValueError("order_by needs at least one column")
        return self._with("order_by", keys, descending)

    def limit(self, k: int) -> "Query":
        """Truncate the valid prefix to at most k rows."""
        return self._with("limit", k)

    # -- introspection -------------------------------------------------------
    def explain(self) -> str:
        lines = [f"scan {self._source!r}"
                 + ("" if self._count is None else "  [pre-counted]")]
        for st in self._stages:
            if st.op == "where":
                lines.append("where <predicate>")
            elif st.op == "select":
                lines.append(f"select {list(st.args[0])}")
            elif st.op == "with_column":
                lines.append(f"with_column {st.args[0]!r}")
            elif st.op == "join":
                b, on, value, _, how = st.args
                lines.append(f"join[{how}] build={b!r} on={on!r}"
                             + (f" value={value!r}" if value else ""))
            elif st.op == "groupby":
                key, value, agg = st.args
                lines.append(f"groupby key={key!r} value={value!r} "
                             f"agg={agg!r}")
            elif st.op == "groupby_agg":
                keys, aggs = st.args
                lines.append(f"groupby_agg keys={list(keys)} aggs="
                             + str({n: (v, a) for n, v, a in aggs}))
            elif st.op == "quantiles":
                key, value, qs, names, mg = st.args
                lines.append(f"quantiles key={key!r} value={value!r} "
                             f"qs={list(qs)}"
                             + (f" max_groups={mg}" if mg else ""))
            elif st.op == "distinct":
                ks = st.args[0]
                lines.append("distinct" + (f" {list(ks)}" if ks else ""))
            elif st.op == "window":
                part, okey, spec, desc = st.args
                lines.append(
                    f"window partition_by={part!r} order_by={okey!r}"
                    + (" desc" if desc else "") + " outputs="
                    + str({n: (fn if s is None else (s, fn))
                           for n, s, fn in spec}))
            elif st.op == "order_by":
                lines.append(f"order_by {st.args[0]!r}"
                             + (" desc" if st.args[1] else ""))
            elif st.op == "limit":
                lines.append(f"limit {st.args[0]}")
        return "\n -> ".join(lines)

    # -- execution -----------------------------------------------------------
    def run(self, *, mesh=None, axis_name: str = "x", timed: bool = False,
            config: config_lib.SortConfig | None = None):
        """Execute the plan. timed=True (single-chip only) additionally
        records per-stage wall-clock "i:op:ms" entries in stats (each stage
        blocks — use for profiling, not production; SURVEY §5 per-stage
        observability).

        Single chip (mesh=None): returns (table, count, stats) — rows
        [0, count) of every column are the result; stats maps "i:op" ->
        rows valid after that stage.

        Distributed (mesh=...): the source table is sharded over the mesh
        axis and the whole plan runs as ONE shard_map — filters shard-local,
        joins against a replicated build side, group-bys two-phase (local
        partial aggregate, hash exchange of partials, final aggregate).
        `order_by`/`limit` need a global view, so they gather the (post-
        aggregation, small) running result to every device and continue
        replicated. Returns (table, counts, stats): counts is (ndev,) while
        the result is sharded (device d's rows valid in [d*rows, d*rows +
        counts[d])), or a scalar once a stage has gathered; stats values
        are global (psum'd) row counts.
        """
        if mesh is None:
            t = self._source
            count = (jnp.asarray(t.num_rows, jnp.int32)
                     if self._count is None
                     else jnp.asarray(self._count, jnp.int32))
            stats: dict[str, Any] = {}
            for i, st in enumerate(self._stages):
                if timed:
                    import time

                    import jax

                    t0 = time.perf_counter()
                    t, count = _EXEC[st.op](t, count, st, config)
                    jax.block_until_ready(
                        tuple(t[k] for k in t.column_names))
                    stats[f"{i}:{st.op}:ms"] = round(
                        (time.perf_counter() - t0) * 1e3, 3)
                else:
                    t, count = _EXEC[st.op](t, count, st, config)
                stats[f"{i}:{st.op}"] = count
            return t, count, stats
        return _run_distributed(self, mesh, axis_name, config)


def _valid_mask(t: Table, count) -> jnp.ndarray:
    return jnp.arange(t.num_rows, dtype=jnp.int32) < count


def _exec_where(t: Table, count, st: _Stage, config):
    pred = st.args[0]
    mask = pred(t) & _valid_mask(t, count)
    t2, c2 = t.filter(mask, config=config)
    return t2, c2.astype(jnp.int32)


def _exec_select(t: Table, count, st: _Stage, config):
    return t.select(st.args[0]), count


def _exec_with_column(t: Table, count, st: _Stage, config):
    name, fn = st.args
    return t.with_column(name, fn(t)), count


def _join_impl(cols: dict, count, st: _Stage, build_cols: dict, config):
    """Shared join stage body (single-chip Table and shard-local dict)."""
    from cuda.radixsort_tpu.ops.join import join as join_op

    _, on, value, build_count, how = st.args
    on_cols = on if isinstance(on, tuple) else (on,)
    rows = next(iter(cols.values())).shape[0]
    bk = tuple(build_cols[k] for k in on_cols)
    pk = tuple(cols[k] for k in on_cols)
    if len(on_cols) == 1:
        bk, pk = bk[0], pk[0]
    nb = build_cols[on_cols[0]].shape[0]
    bv = (build_cols[value] if value is not None
          else jnp.zeros((nb,), jnp.int32))
    bvalid = (None if build_count is None else
              jnp.arange(nb, dtype=jnp.int32)
              < jnp.asarray(build_count, jnp.int32))
    pvalid = jnp.arange(rows, dtype=jnp.int32) < count

    def key_out(ok):
        return (dict(zip(on_cols, ok)) if len(on_cols) > 1
                else {on_cols[0]: ok})

    if how in ("semi", "anti"):
        ok, oi, cnt = join_op(bk, bv, pk, how=how,
                              build_valid=bvalid, probe_valid=pvalid,
                              config=config)
        out = key_out(ok)
    elif how in ("left", "right", "full"):
        if "matched" in cols:
            raise ValueError(f"{how} join adds a 'matched' column; rename "
                             "the probe's existing 'matched' column first")
        ok, ov, oi, cnt, om = join_op(bk, bv, pk, how=how,
                                      build_valid=bvalid,
                                      probe_valid=pvalid, config=config)
        out = key_out(ok)
        out[value] = ov
        out["matched"] = om
    else:
        ok, ov, oi, cnt = join_op(bk, bv, pk, how="inner",
                                  build_valid=bvalid, probe_valid=pvalid,
                                  config=config)
        out = key_out(ok)
        out[value] = ov
    fill_build = how in ("right", "full")
    for name, col in cols.items():
        if name not in out:
            g = jnp.take(col, jnp.maximum(oi, 0), axis=0)
            # build-only rows (oi == -1) have no probe columns: zero-fill
            out[name] = (jnp.where(oi >= 0, g, jnp.zeros((), col.dtype))
                         if fill_build else g)
    return out, cnt.astype(jnp.int32)


def _exec_join(t: Table, count, st: _Stage, config):
    build = st.args[0]
    out, cnt = _join_impl({k: t[k] for k in t.column_names}, count, st,
                          {k: build[k] for k in build.column_names}, config)
    return Table(out), cnt


def _exec_groupby(t: Table, count, st: _Stage, config):
    from cuda.radixsort_tpu.ops.aggregate import groupby as groupby_op

    key, value, agg = st.args
    gk, gv, cnt = groupby_op(t[key], t[value], agg=agg,
                             valid=_valid_mask(t, count), config=config)
    out_name = value if value != key else agg
    return Table({key: gk, out_name: gv}), cnt.astype(jnp.int32)


def _groupby_agg_cols(cols, keys, aggs, valid, config):
    """Shared multi-agg stage body (columns dict in, columns dict out).

    Decomposable/moment aggregates run in ONE groupby_multi; median columns
    each run a groupby_quantile over the same composite key — both compact
    the same distinct key set in the same ascending order, so the output
    columns align positionally by construction."""
    from cuda.radixsort_tpu.ops.aggregate import (
        groupby_multi,
        groupby_quantile,
    )

    normal = tuple((n, v, a) for n, v, a in aggs if a != "median")
    med = tuple((n, v) for n, v, a in aggs if a == "median")
    out, cnt = {}, None
    if normal or not med:
        kc, vc, cnt = groupby_multi(
            tuple(cols[k] for k in keys),
            tuple(cols[v] for _, v, _ in normal),
            tuple(a for _, _, a in normal),
            valid=valid, config=config)
        out = dict(zip(keys, kc))
        out.update({n: c for (n, _, _), c in zip(normal, vc)})
    # one quantile sort per DISTINCT value column (multiple medians over
    # the same column share it); with no decomposable aggregates the
    # first quantile call also supplies the keys and count — no extra sort
    by_vcol = {}
    for n_, v in med:
        by_vcol.setdefault(v, []).append(n_)
    for v, names_ in by_vcol.items():
        kq, (mcol,), cq = groupby_quantile(
            tuple(cols[k] for k in keys), cols[v], (0.5,), valid=valid,
            config=config)
        for n_ in names_:
            out[n_] = mcol
        if cnt is None:
            out.update(dict(zip(keys, kq)))
            cnt = cq
    return out, cnt.astype(jnp.int32)


def _exec_groupby_agg(t: Table, count, st: _Stage, config):
    keys, aggs = st.args
    out, cnt = _groupby_agg_cols({k: t[k] for k in t.column_names}, keys,
                                 aggs, _valid_mask(t, count), config)
    return Table(out), cnt


def _exec_quantiles(t: Table, count, st: _Stage, config):
    from cuda.radixsort_tpu.ops.aggregate import groupby_quantile

    key, value, qs, names, _max_groups = st.args  # hint is distributed-only
    gk, qcols, cnt = groupby_quantile(t[key], t[value], qs,
                                      valid=_valid_mask(t, count),
                                      config=config)
    out = {key: gk}
    out.update(zip(names, qcols))
    return Table(out), cnt.astype(jnp.int32)


def _exec_distinct(t: Table, count, st: _Stage, config):
    from cuda.radixsort_tpu.ops.aggregate import groupby_multi

    keys = st.args[0] or t.column_names
    kc, _, cnt = groupby_multi(tuple(t[k] for k in keys), (), (),
                               valid=_valid_mask(t, count), config=config)
    return Table(dict(zip(keys, kc))), cnt.astype(jnp.int32)


def _exec_window(t: Table, count, st: _Stage, config):
    from cuda.radixsort_tpu.ops.window import window_table

    part, okey, spec, desc = st.args
    out, cnt = window_table({k: t[k] for k in t.column_names}, part, okey,
                            spec, valid=_valid_mask(t, count),
                            descending=desc, config=config)
    return Table(out), cnt.astype(jnp.int32)


def _exec_order_by(t: Table, count, st: _Stage, config):
    from cuda.radixsort_tpu.ops.sort import sort_struct

    keys, descending = st.args
    keys = (keys,) if isinstance(keys, str) else tuple(keys)
    # validity limb: chosen so the struct-wide `descending` still sinks the
    # invalid tail rows last (they are real dropped rows, not sentinels)
    valid = _valid_mask(t, count)
    flag = (valid if descending else jnp.logical_not(valid)).astype(jnp.uint8)
    others = tuple(n for n in t.column_names if n not in keys)
    (_, *sk), sv = sort_struct((flag,) + tuple(t[k] for k in keys),
                               tuple(t[n] for n in others),
                               descending=descending, config=config)
    out = dict(zip(others, sv))
    out.update(zip(keys, sk))
    return Table(out), count


def _exec_limit(t: Table, count, st: _Stage, config):
    return t, jnp.minimum(count, jnp.asarray(st.args[0], jnp.int32))


_EXEC = {
    "where": _exec_where,
    "select": _exec_select,
    "with_column": _exec_with_column,
    "join": _exec_join,
    "groupby": _exec_groupby,
    "groupby_agg": _exec_groupby_agg,
    "quantiles": _exec_quantiles,
    "distinct": _exec_distinct,
    "window": _exec_window,
    "order_by": _exec_order_by,
    "limit": _exec_limit,
}


# ---------------------------------------------------------------------------
# distributed execution: the whole plan inside one shard_map
# ---------------------------------------------------------------------------

# build tables above this row count are hash-localized instead of probed
# replicated — the same per-chip threshold shuffle.join_distributed routes
# on (~8 MB of key+value columns per chip)
_JOIN_BROADCAST_ROWS = 1 << 20


_AUTO_QUANTILE_GROUPS = 64


def _auto_route_quantiles(stages, src, mesh, axis_name):
    """Fill in missing `max_groups` hints on quantiles stages: when (a) every stage before the quantiles stage only filters rows
    or adds/projects columns (the group-key set can only SHRINK), (b) the
    key and value columns come from the source unrewritten with <=32-bit
    dtypes, and (c) a cheap capped distinct count on the source key column
    (parallel.dselect.distinct_count_capped — one local sort + one (64,)
    all_gather, run EAGERLY before the plan traces) proves <=64 distinct
    groups, the stage takes the zero-row-movement histogram-refinement
    path with max_groups=64. An explicit hint always wins; an estimate
    >64 keeps the whole-row exchange (correct at any group count)."""
    from cuda.radixsort_tpu import twiddle as _tw
    from cuda.radixsort_tpu.parallel.dselect import distinct_count_capped

    out = []
    safe = True
    rewritten: set = set()
    for st in stages:
        if st.op == "quantiles" and st.args[4] is None and safe:
            key, value, qs, names, _ = st.args
            if (key in src.column_names and value in src.column_names
                    and key not in rewritten and value not in rewritten
                    and _tw.bit_width(src[key].dtype) <= 32
                    and _tw.bit_width(src[value].dtype) <= 32):
                ng = int(distinct_count_capped(
                    src[key], cap=_AUTO_QUANTILE_GROUPS, mesh=mesh,
                    axis_name=axis_name))
                if ng <= _AUTO_QUANTILE_GROUPS:
                    st = _Stage("quantiles",
                                (key, value, qs, names,
                                 _AUTO_QUANTILE_GROUPS), st.kwargs)
        if st.op == "with_column":
            rewritten.add(st.args[0])
        elif st.op not in ("where", "select"):
            safe = False
        out.append(st)
    return out


def _run_distributed(q: Query, mesh, axis_name, config):
    import jax
    from jax.sharding import PartitionSpec as P

    from cuda.radixsort_tpu.parallel.dsort import axis_size
    from cuda.radixsort_tpu.parallel.shuffle import _pad_to

    from jax import shard_map

    ndev = axis_size(mesh, axis_name)
    src = q._source
    n = src.num_rows
    s = -(-n // ndev)
    cols0 = {k: _pad_to(src[k], s * ndev) for k in src.column_names}
    plan_stages = _auto_route_quantiles(q._stages, src, mesh, axis_name)
    # replicated side inputs (join build tables), passed as explicit args
    reps = []
    for st in plan_stages:
        if st.op == "join":
            b = st.args[0]
            reps.append({k: b[k] for k in b.column_names})

    def shard_fn(cols, rep_tables):
        d = jax.lax.axis_index(axis_name).astype(jnp.int32)
        cols = {k: v.reshape(-1) for k, v in cols.items()}
        cnt = jnp.clip(n - d * s, 0, s).astype(jnp.int32)
        rep = False  # True once a stage gathered to a replicated view
        stats = {}
        rep_iter = iter(rep_tables)
        for i, st in enumerate(plan_stages):
            if st.op == "join":
                # build tables ride as explicit replicated args (no closure
                # capture inside shard_map); replicated-mode joins use the
                # same local join — replicated probe x replicated build IS
                # the global join. Two reasons to hash-localize instead of
                # broadcasting the build: (a) outer joins (right/full) must
                # emit each unmatched build row exactly ONCE; (b) a LARGE
                # build (above the same per-chip threshold
                # shuffle.join_distributed routes on) should be dealt to
                # its hash owners so each device joins against ~1/ndev of
                # it rather than all of it.
                bt = next(rep_iter)
                nbuild = next(iter(bt.values())).shape[0]
                if not rep and (st.args[4] in ("right", "full")
                                or nbuild > _JOIN_BROADCAST_ROWS):
                    cols, cnt = _dist_join_hash(cols, cnt, st, bt, ndev,
                                                axis_name, config)
                else:
                    cols, cnt = _dist_join(cols, cnt, st, bt, config)
            elif rep or st.op in ("select", "with_column"):
                # replicated (or validity-preserving projection): reuse the
                # single-chip stage on the local view
                t2, cnt = _EXEC[st.op](Table(cols), cnt, st, config)
                cols = {k: t2[k] for k in t2.column_names}
            elif st.op == "where":
                cols, cnt = _dist_where(cols, cnt, st.args[0], config)
            elif st.op == "groupby":
                cols, cnt = _dist_groupby(cols, cnt, st, ndev, axis_name,
                                          config)
            elif st.op == "groupby_agg":
                cols, cnt = _dist_groupby_agg(cols, cnt, st, ndev,
                                              axis_name, config)
            elif st.op == "quantiles":
                cols, cnt = _dist_quantiles(cols, cnt, st, ndev,
                                            axis_name, config)
            elif st.op == "distinct":
                cols, cnt = _dist_distinct(cols, cnt, st, ndev, axis_name,
                                           config)
            elif st.op == "window":
                cols, cnt = _dist_window(cols, cnt, st, ndev, axis_name,
                                         config)
            elif st.op in ("order_by", "limit"):
                if not rep:
                    nxt = (plan_stages[i + 1] if i + 1 < len(plan_stages)
                           else None)
                    if st.op == "order_by" and nxt is not None \
                            and nxt.op == "limit":
                        cols, cnt = _local_top(cols, cnt, st, nxt, config)
                    cols, cnt = _dist_gather(cols, cnt, axis_name)
                    rep = True
                t2, cnt = _EXEC[st.op](Table(cols), cnt, st, config)
                cols = {k: t2[k] for k in t2.column_names}
            stats[f"{i}:{st.op}"] = (cnt if rep
                                     else jax.lax.psum(cnt, axis_name))
        out = {k: v.reshape(1, -1) for k, v in cols.items()}
        if rep:
            return out, cnt.reshape(1), stats, jnp.ones((), jnp.int32)
        return out, cnt.reshape(1), stats, jnp.zeros((), jnp.int32)

    # detect statically whether the output is replicated (any gather stage)
    replicated_out = any(st.op in ("order_by", "limit")
                         for st in plan_stages)
    out_table_spec = P() if replicated_out else P(axis_name)
    cols, counts, stats, _ = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=(out_table_spec,
                   P() if replicated_out else P(axis_name),
                   P(), P()),
        check_vma=False,
    )(cols0, reps)
    t = Table({k: v.reshape(-1) if not replicated_out else v[0]
               for k, v in cols.items()})
    counts = counts.reshape(-1)
    if replicated_out:
        counts = counts[0]
    return t, counts, stats


def _dist_where(cols, cnt, pred, config):
    """Shard-local stable compaction by pred & positional validity."""
    rows = next(iter(cols.values())).shape[0]
    mask = pred(Table(cols)) & (jnp.arange(rows, dtype=jnp.int32) < cnt)
    drop = jnp.logical_not(mask)
    order = jnp.argsort(drop, stable=True)
    return ({k: jnp.take(v, order, axis=0) for k, v in cols.items()},
            jnp.sum(mask.astype(jnp.int32)))


def _dist_join(cols, cnt, st, build, config):
    """Local probe shard against the REPLICATED build table."""
    return _join_impl(cols, cnt, st, build, config)


def _dist_groupby(cols, cnt, st, ndev, axis_name, config):
    """Single-key single-agg distributed groupby = the multi form with one
    key and one aggregate (same output naming as the single-chip stage).
    Non-decomposable aggregates (median) cannot travel as partials: they
    hash-exchange the raw rows instead so each group's full value set lands
    on one device."""
    key, value, agg = st.args
    if agg == "median":
        from cuda.radixsort_tpu.ops.aggregate import groupby as groupby_op
        from cuda.radixsort_tpu.parallel.shuffle import (
            _owner_of_keys,
            exchange_rows,
        )

        rows = next(iter(cols.values())).shape[0]
        valid0 = jnp.arange(rows, dtype=jnp.int32) < cnt
        dest = jnp.where(valid0, _owner_of_keys(cols[key], ndev), ndev)
        (rk, rv), rvalid = exchange_rows([cols[key], cols[value]], dest,
                                         ndev, axis_name, rows)
        gk, gv, c2 = groupby_op(rk, rv, agg="median", valid=rvalid,
                                config=config)
        out_name = value if value != key else agg
        return {key: gk, out_name: gv}, c2.astype(jnp.int32)
    out_name = value if value != key else agg
    st2 = _Stage("groupby_agg", ((key,), ((out_name, value, agg),)), {})
    return _dist_groupby_agg(cols, cnt, st2, ndev, axis_name, config)


def _dist_join_hash(cols, cnt, st, build, ndev, axis_name, config):
    """Hash-localized join over the mesh: hash-exchange probe rows AND
    deal each (replicated) build row to its hash owner, so every key lives
    on exactly one device — the local join is then globally correct for
    EVERY how: unmatched build rows (right/full) emit exactly once, and
    inner/left/semi/anti probe each build row on exactly one device
    (the large-build route; small builds broadcast via _dist_join)."""
    import jax

    from cuda.radixsort_tpu.parallel.shuffle import exchange_rows

    from cuda.radixsort_tpu.parallel.shuffle import _owner_of_key_tuple

    _, on, value, build_count, how = st.args
    on_cols = on if isinstance(on, tuple) else (on,)
    rows = next(iter(cols.values())).shape[0]
    d = jax.lax.axis_index(axis_name).astype(jnp.int32)

    def owner(table_cols):
        return _owner_of_key_tuple(
            [table_cols[k] for k in on_cols], ndev)

    # probe side: route whole rows to their key's hash owner
    valid0 = jnp.arange(rows, dtype=jnp.int32) < cnt
    dest = jnp.where(valid0, owner(cols), ndev)
    names = list(cols)
    recv, rvalid = exchange_rows([cols[k] for k in names], dest, ndev,
                                 axis_name, rows)
    # compact received rows to a valid prefix (the local join's protocol)
    order = jnp.argsort(jnp.logical_not(rvalid), stable=True)
    rcols = {k: jnp.take(v, order, axis=0) for k, v in zip(names, recv)}
    rcnt = jnp.sum(rvalid.astype(jnp.int32))

    # build side is replicated: keep only MY hash-owned rows, compacted
    nb = build[on_cols[0]].shape[0]
    mine = owner(build) == d
    if build_count is not None:
        mine = mine & (jnp.arange(nb, dtype=jnp.int32)
                       < jnp.asarray(build_count, jnp.int32))
    border = jnp.argsort(jnp.logical_not(mine), stable=True)
    blocal = {k: jnp.take(v, border, axis=0) for k, v in build.items()}
    bcnt = jnp.sum(mine.astype(jnp.int32))

    st2 = _Stage("join", (None, on, value, bcnt, how), {})
    return _join_impl(rcols, rcnt, st2, blocal, config)


def _dist_quantiles(cols, cnt, st, ndev, axis_name, config):
    """Quantiles are non-decomposable: hash-exchange the raw (key, value)
    rows so each group's full value set lands on one device, then the
    single-chip op per shard. With the `max_groups` planner hint the
    exchange disappears entirely: histogram refinement resolves every
    (group, q) target with 8 psum'd (targets, 16) histograms — zero row
    movement."""
    from cuda.radixsort_tpu.ops.aggregate import groupby_quantile
    from cuda.radixsort_tpu.parallel.shuffle import (
        _owner_of_keys,
        exchange_rows,
    )

    key, value, qs, names, max_groups = st.args
    rows = next(iter(cols.values())).shape[0]
    valid0 = jnp.arange(rows, dtype=jnp.int32) < cnt
    if max_groups is not None:
        import jax

        from cuda.radixsort_tpu import twiddle
        from cuda.radixsort_tpu.parallel.dselect import quantile_refine_shard

        if (twiddle.bit_width(cols[key].dtype) > 32
                or twiddle.bit_width(cols[value].dtype) > 32):
            raise NotImplementedError(
                "quantiles max_groups hint: <=32-bit key/value dtypes")
        kb = twiddle.twiddle_in(cols[key]).astype(jnp.uint32)
        vb = twiddle.twiddle_in(cols[value]).astype(jnp.uint32)
        gkb, qstack, n_groups = quantile_refine_shard(
            kb, vb, valid0, qs, max_groups, cols[value].dtype, axis_name)
        gk = twiddle.twiddle_out(gkb, cols[key].dtype)
        # the result is replicated (G,); deal slots round-robin across
        # shards so the plan's sharded-output contract holds
        slot = jnp.arange(max_groups, dtype=jnp.int32)
        my = jax.lax.axis_index(axis_name).astype(jnp.int32)
        mine = ((slot % ndev) == my) & (slot < jnp.minimum(
            n_groups, max_groups))
        order = jnp.argsort(jnp.logical_not(mine), stable=True)
        out = {key: jnp.take(gk, order, axis=0)}
        for i, nm in enumerate(names):
            out[nm] = jnp.take(qstack[i], order, axis=0)
        return out, jnp.sum(mine.astype(jnp.int32))
    dest = jnp.where(valid0, _owner_of_keys(cols[key], ndev), ndev)
    (rk, rv), rvalid = exchange_rows([cols[key], cols[value]], dest, ndev,
                                     axis_name, rows)
    gk, qcols, c2 = groupby_quantile(rk, rv, qs, valid=rvalid,
                                     config=config)
    out = {key: gk}
    out.update(zip(names, qcols))
    return out, c2.astype(jnp.int32)


def _dist_distinct(cols, cnt, st, ndev, axis_name, config):
    """Two-phase distributed dedup: local distinct, hash-of-key-tuple
    exchange of the survivors, final distinct per shard."""
    from cuda.radixsort_tpu.ops.aggregate import groupby_multi
    from cuda.radixsort_tpu.parallel.shuffle import (
        _owner_of_key_tuple,
        exchange_rows,
    )

    keys = st.args[0] or tuple(sorted(cols))
    rows = next(iter(cols.values())).shape[0]
    kc, _, c1 = groupby_multi(
        tuple(cols[k] for k in keys), (), (),
        valid=jnp.arange(rows, dtype=jnp.int32) < cnt, config=config)
    dest = jnp.where(jnp.arange(kc[0].shape[0], dtype=jnp.int32) < c1,
                     _owner_of_key_tuple(kc, ndev), ndev)
    recv, rvalid = exchange_rows(list(kc), dest, ndev, axis_name,
                                 kc[0].shape[0])
    k2, _, c2 = groupby_multi(tuple(recv), (), (), valid=rvalid,
                              config=config)
    return dict(zip(keys, k2)), c2.astype(jnp.int32)


def _dist_window(cols, cnt, st, ndev, axis_name, config):
    """Hash-exchange whole rows by partition key (every partition lands on
    exactly one device), then the single-chip window runs per shard —
    within-partition sequences are bit-identical to the single-chip plan;
    cross-partition placement follows the hash (like distributed groupby)."""
    from cuda.radixsort_tpu.ops.window import window_table
    from cuda.radixsort_tpu.parallel.shuffle import (
        _owner_of_keys,
        exchange_rows,
    )

    part, okey, spec, desc = st.args
    rows = next(iter(cols.values())).shape[0]
    valid0 = jnp.arange(rows, dtype=jnp.int32) < cnt
    dest = jnp.where(valid0, _owner_of_keys(cols[part], ndev), ndev)
    names = list(cols)
    recv, rvalid = exchange_rows([cols[k] for k in names], dest, ndev,
                                 axis_name, rows)
    out, c2 = window_table(dict(zip(names, recv)), part, okey, spec,
                           valid=rvalid, descending=desc, config=config)
    return out, c2.astype(jnp.int32)


def _dist_groupby_agg(cols, cnt, st, ndev, axis_name, config):
    """Two-phase multi-key multi-agg: local partials, hash-of-key-tuple
    exchange, final re-aggregation. Non-decomposable aggregates travel as
    their decomposition: count partials re-reduce as sums, mean travels as
    a (sum, count) pair, var/std as (sum, sum-of-squares, count) moments —
    each assembled after the final phase."""
    from cuda.radixsort_tpu.ops.aggregate import (
        _mean_dtype,
        _moments_to_var,
        groupby_multi,
    )
    from cuda.radixsort_tpu.parallel.shuffle import (
        _owner_of_key_tuple,
        exchange_rows,
    )

    keys, aggs = st.args
    if any(a == "median" for _, _, a in aggs):
        # non-decomposable aggregate present: hash-exchange the RAW rows
        # (keys + value columns) so each group's full value set lands on
        # one device, then run the shared single-chip body per shard
        rows = next(iter(cols.values())).shape[0]
        valid0 = jnp.arange(rows, dtype=jnp.int32) < cnt
        dest = jnp.where(
            valid0,
            _owner_of_key_tuple([cols[k] for k in keys], ndev), ndev)
        need = list(dict.fromkeys(list(keys) + [v for _, v, _ in aggs]))
        recv, rvalid = exchange_rows([cols[k] for k in need], dest, ndev,
                                     axis_name, rows)
        return _groupby_agg_cols(dict(zip(need, recv)), keys, aggs,
                                 rvalid, config)
    # expand: one partial column per decomposed aggregate (arrays, so the
    # var/std decomposition can push a squared column through phase 1)
    part_arrays, part_aggs, assemble = [], [], []
    for n_, v, a in aggs:
        col = cols[v]
        if a == "mean":
            assemble.append((n_, a, (len(part_arrays),
                                     len(part_arrays) + 1), col.dtype))
            part_arrays += [col, col]
            part_aggs += ["sum", "count"]
        elif a in ("var", "std"):
            md = _mean_dtype(col.dtype)
            assemble.append((n_, a, (len(part_arrays),
                                     len(part_arrays) + 1,
                                     len(part_arrays) + 2), col.dtype))
            part_arrays += [col, col.astype(md) * col.astype(md), col]
            part_aggs += ["sum", "sum", "count"]
        else:
            assemble.append((n_, a, (len(part_arrays),), None))
            part_arrays.append(col)
            part_aggs.append(a)
    rows = next(iter(cols.values())).shape[0]
    kc, vc, c1 = groupby_multi(
        tuple(cols[k] for k in keys),
        tuple(part_arrays),
        tuple(part_aggs),
        valid=jnp.arange(rows, dtype=jnp.int32) < cnt, config=config)
    dest = jnp.where(jnp.arange(kc[0].shape[0], dtype=jnp.int32) < c1,
                     _owner_of_key_tuple(kc, ndev), ndev)
    recv, rvalid = exchange_rows(list(kc) + list(vc), dest, ndev,
                                 axis_name, kc[0].shape[0])
    nk = len(keys)
    re_aggs = tuple("sum" if a == "count" else a for a in part_aggs)
    k2, v2, c2 = groupby_multi(tuple(recv[:nk]), tuple(recv[nk:]),
                               re_aggs, valid=rvalid, config=config)
    out = dict(zip(keys, k2))
    for n_, a, idx, vdtype in assemble:
        if a == "mean":
            md = _mean_dtype(vdtype)
            out[n_] = v2[idx[0]].astype(md) / v2[idx[1]].astype(md)
        elif a in ("var", "std"):
            out[n_] = _moments_to_var(v2[idx[0]], v2[idx[1]], v2[idx[2]],
                                      a, vdtype)
        else:
            out[n_] = v2[idx[0]]
    return out, c2.astype(jnp.int32)


# Replicating more than this many bytes per device on an order_by/limit
# gather is almost certainly a planner misuse (sort the sharded table with
# parallel.dsort instead of ordering it inside a plan); warn at trace time.
_GATHER_WARN_BYTES = 256 << 20


def _local_top(cols, cnt, order_st, limit_st, config):
    """order_by + limit(k) on one shard, cut to its first k rows. The
    global first k rows of a stable order are each shard's first rows in
    device-major order, so gathering ndev * k rows and ordering again gives
    the same result as gathering everything."""
    t, cnt = _exec_order_by(Table(cols), cnt, order_st, config)
    t, cnt = _exec_limit(t, cnt, limit_st, config)
    k = min(int(limit_st.args[0]), t.num_rows)
    return {n: t[n][:k] for n in t.column_names}, cnt


def _dist_gather(cols, cnt, axis_name):
    """Gather the sharded running result to a replicated compacted view.

    order_by/limit need a global view; this is intended for POST-aggregation
    results (small). The gather replicates ndev x padded-shard-rows on every
    device — guarded by a trace-time warning above _GATHER_WARN_BYTES since
    an early order_by on a large sharded table would replicate the whole
    table."""
    import jax

    rows = next(iter(cols.values())).shape[0]
    gathered_bytes = rows * sum(int(v.dtype.itemsize) for v in cols.values())
    if gathered_bytes > _GATHER_WARN_BYTES:
        import warnings

        warnings.warn(
            f"distributed plan order_by/limit gathers ~{gathered_bytes >> 20}"
            " MiB per shard to EVERY device (replicated view); order large"
            " tables with parallel.dsort before the plan, or move order_by"
            " after the aggregation", stacklevel=2)
    valid = jnp.arange(rows, dtype=jnp.int32) < cnt
    gvalid = jax.lax.all_gather(valid, axis_name, tiled=True)
    gcols = {k: jax.lax.all_gather(v, axis_name, tiled=True)
             for k, v in cols.items()}
    # stable compaction of the gathered valid rows (device-major order)
    drop = jnp.logical_not(gvalid)
    order = jnp.argsort(drop, stable=True)
    return ({k: jnp.take(v, order, axis=0) for k, v in gcols.items()},
            jax.lax.psum(cnt, axis_name))
