"""Column-batch table abstraction — the storage layer of the engine.

SURVEY §1 names "column-batch storage (HBM-resident, sharded)" as the
framework's bottom layer. Operators take raw arrays; this module gives
them a first-class container: a Table is
an immutable set of named, equal-length 1-D columns registered as a JAX
pytree, so it jits, shards (`Table.shard` places every column on a mesh
axis) and donates like any array — columnar by construction (SoA), which is
what the (N, 128)-plane kernels underneath want.

Row validity follows the engine's static-shape convention: operators that
drop rows (filter, join) return (table, count) with rows [0, count) valid —
the selection-vector protocol of BASELINE.json:5, carried at the table
level. No hidden copies: every method lowers onto the measured operator set
(ops/*.py, parallel/*.py).

Reference role: the reference has no table layer (it sorts raw device
arrays); this is the generalization BASELINE.json:5 demands ("HBM-resident
column batches ... generalized into the full operator set").
"""

from __future__ import annotations

from typing import Iterable, Mapping

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib


@jax.tree_util.register_pytree_node_class
class Table:
    """Immutable named-column batch. Columns: equal-length 1-D arrays."""

    def __init__(self, columns: Mapping[str, jnp.ndarray]):
        cols = dict(columns)
        if not cols:
            raise ValueError("Table needs at least one column")
        lens = {k: v.shape[0] for k, v in cols.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column lengths differ: {lens}")
        self._cols = cols

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        names = tuple(sorted(self._cols))
        return tuple(self._cols[k] for k in names), names

    @classmethod
    def tree_unflatten(cls, names, leaves):
        obj = object.__new__(cls)
        obj._cols = dict(zip(names, leaves))
        return obj

    # -- basics ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return next(iter(self._cols.values())).shape[0]

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(sorted(self._cols))

    def column(self, name: str) -> jnp.ndarray:
        return self._cols[name]

    __getitem__ = column

    def select(self, names: Iterable[str]) -> "Table":
        return Table({k: self._cols[k] for k in names})

    def with_column(self, name: str, col: jnp.ndarray) -> "Table":
        d = dict(self._cols)
        d[name] = col
        return Table(d)

    def __repr__(self):
        return (f"Table({self.num_rows} rows, "
                f"{{{', '.join(self.column_names)}}})")

    # -- sharding ----------------------------------------------------------
    def shard(self, mesh, axis_name: str = "x") -> "Table":
        """Place every column on the mesh axis (HBM-resident, sharded)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(axis_name))
        return Table({k: jax.device_put(v, sh)
                      for k, v in self._cols.items()})

    # -- operators (all lower onto ops/*.py) -------------------------------
    def sort_by(self, key: str, *, descending: bool = False,
                config: config_lib.SortConfig | None = None) -> "Table":
        """Stable sort of all columns by one key column."""
        from cuda.radixsort_tpu.ops.sort import sort_pairs

        others = {k: v for k, v in self._cols.items() if k != key}
        names = tuple(sorted(others))
        sk, sv = sort_pairs(self._cols[key],
                            tuple(others[k] for k in names),
                            descending=descending, config=config)
        out = dict(zip(names, sv))
        out[key] = sk
        return Table(out)

    def sort_by_columns(self, keys: Iterable[str], *,
                        descending: bool = False,
                        config: config_lib.SortConfig | None = None
                        ) -> "Table":
        """Lexicographic stable sort by several key columns (decomposer
        protocol — ops/sort.py::sort_struct)."""
        from cuda.radixsort_tpu.ops.sort import sort_struct

        keys = list(keys)
        others = {k: v for k, v in self._cols.items() if k not in keys}
        names = tuple(sorted(others))
        out_keys, sv = sort_struct(
            tuple(self._cols[k] for k in keys),
            tuple(others[k] for k in names),
            descending=descending, config=config)
        out = dict(zip(names, sv))
        out.update(zip(keys, out_keys))
        return Table(out)

    def filter(self, mask: jnp.ndarray, *,
               config: config_lib.SortConfig | None = None):
        """Compact rows where mask is True. Returns (table, count): rows
        [0, count) valid (stable 1-bit partition, 2-bit stage kernel)."""
        from cuda.radixsort_tpu.ops.filter import filter_columns

        names = self.column_names
        cols, count = filter_columns(
            mask, tuple(self._cols[k] for k in names), config=config)
        return Table(dict(zip(names, cols))), count

    def partition_by(self, key: str, *, bits: int, by_hash: bool = False,
                     config: config_lib.SortConfig | None = None):
        """Stable partition into 2^bits buckets by the key column's top
        bits (or its hash). Returns (table, offsets)."""
        from cuda.radixsort_tpu.ops.partition import partition

        others = {k: v for k, v in self._cols.items() if k != key}
        names = tuple(sorted(others))
        sk, sv, offsets = partition(
            self._cols[key], tuple(others[k] for k in names),
            bits=bits, by_hash=by_hash, config=config)
        out = dict(zip(names, sv))
        out[key] = sk
        return Table(out), offsets

    def groupby(self, key: str, value: str, *, agg: str = "sum",
                config: config_lib.SortConfig | None = None):
        """Group by one column, reduce another. Returns (table[key, value],
        count)."""
        from cuda.radixsort_tpu.ops.aggregate import groupby

        gk, gv, count = groupby(self._cols[key], self._cols[value],
                                agg=agg, config=config)
        return Table({key: gk, value: gv}), count

    def groupby_agg(self, keys: Iterable[str],
                    aggs: Mapping[str, tuple[str, str]], *,
                    config: config_lib.SortConfig | None = None):
        """Multi-key, multi-aggregate group-by. `keys`: grouping columns
        (lexicographic); `aggs`: out_name -> (value_column, agg) with agg in
        sum/count/min/max/mean/var/std. Returns (table[keys..., out_names...], count)."""
        from cuda.radixsort_tpu.ops.aggregate import groupby_multi

        keys = list(keys)
        names = list(aggs)
        clash = set(keys) & set(names)
        if clash:
            raise ValueError(f"aggregate names clash with keys: {clash}")
        kc, vc, cnt = groupby_multi(
            tuple(self._cols[k] for k in keys),
            tuple(self._cols[aggs[n][0]] for n in names),
            tuple(aggs[n][1] for n in names), config=config)
        out = dict(zip(keys, kc))
        out.update(zip(names, vc))
        return Table(out), cnt

    def distinct(self, *keys: str, config=None):
        """Distinct rows by the named columns (all when none given) —
        key-ascending. Returns (table[keys...], count)."""
        from cuda.radixsort_tpu.ops.aggregate import groupby_multi

        keys = keys or self.column_names
        kc, _, cnt = groupby_multi(
            tuple(self._cols[k] for k in keys), (), (), config=config)
        return Table(dict(zip(keys, kc))), cnt

    def window(self, partition_by: str, order_by: str,
               outputs: Mapping[str, object], *, descending: bool = False,
               config: config_lib.SortConfig | None = None):
        """Append window columns over OVER (PARTITION BY .. ORDER BY ..):
        `outputs` maps out_name -> fn (row_number/rank/dense_rank) or
        out_name -> (value_column, fn) (cumsum/cummin/cummax/lag/lead).
        Rows are reordered to (partition, order). Returns a Table."""
        from cuda.radixsort_tpu.ops.window import window_table

        spec = tuple(
            (n, None, v) if isinstance(v, str) else (n, v[0], v[1])
            for n, v in outputs.items())
        out, _ = window_table(dict(self._cols), partition_by, order_by,
                              spec, descending=descending, config=config)
        return Table(out)

    def join(self, build: "Table", *, on: str, value: str,
             config: config_lib.SortConfig | None = None):
        """Inner FK join: probe (self) rows against build's `on` column;
        brings build's `value` column across. Returns (table, count) with
        columns: on, value, and every self column (gathered by probe row).
        """
        from cuda.radixsort_tpu.ops.join import join

        ok, ov, oi, count = join(
            build[on], build[value], self._cols[on], how="inner",
            config=config)
        out = {on: ok, value: ov}
        for k, v in self._cols.items():
            if k != on:
                out[k] = jnp.take(v, oi, axis=0)
        return Table(out), count


def table(**columns) -> Table:
    """Convenience constructor: table(a=..., b=...)."""
    return Table(columns)


# --------------------------------------------------------------------------
# distributed table operators (thin wrappers over parallel/*.py; every one
# returns an ExchangeStats pytree — SURVEY §5 observability)
# --------------------------------------------------------------------------


def groupby_distributed(t: Table, key: str, value: str, *, mesh,
                        axis_name: str = "x", agg: str = "sum"):
    """Sized two-phase distributed groupby over a sharded table.
    Returns (Table[key, value] concatenated over the axis, counts, stats)."""
    from cuda.radixsort_tpu.parallel.shuffle import groupby_distributed_sized

    gk, gv, cnt, _cap, st = groupby_distributed_sized(
        t[key], t[value], mesh=mesh, axis_name=axis_name, agg=agg)
    return Table({key: gk, value: gv}), cnt, st


def join_distributed(probe: Table, build: Table, *, on: str, value: str,
                     mesh, axis_name: str = "x",
                     broadcast_threshold: int | None = None):
    """Distributed inner join routed by build size (broadcast small builds,
    hash-exchange both sides otherwise). Returns (Table[on, value,
    probe_row], counts, stats); probe_row is the GLOBAL probe row id —
    gather other probe columns with it."""
    from cuda.radixsort_tpu.parallel import shuffle

    thr = broadcast_threshold if broadcast_threshold is not None else 1 << 20
    if build.num_rows <= thr:
        ok, ov, oi, cnt, st = shuffle.join_distributed_broadcast(
            build[on], build[value], probe[on],
            mesh=mesh, axis_name=axis_name)
    else:
        ok, ov, oi, cnt, _caps, st = shuffle.join_distributed_sized(
            build[on], build[value], probe[on],
            mesh=mesh, axis_name=axis_name)
    return Table({on: ok, value: ov, "probe_row": oi}), cnt, st


def sort_distributed(t: Table, key: str, *, mesh, axis_name: str = "x",
                     descending: bool = False):
    """Distributed keys-only sort of one column (range-partitioned output).
    Returns (sorted_padded, counts, stats) — see parallel.dsort."""
    from cuda.radixsort_tpu.parallel.dsort import sort_distributed as _ds

    return _ds(t[key], mesh=mesh, axis_name=axis_name,
               descending=descending)


def concat_tables(tables, counts=None):
    """UNION ALL: stack tables with the same column set. With `counts`
    (one per table — the validity-prefix protocol), valid rows are
    COMPACTED to the front: each table contributes rows [0, count_i) and
    the result is (table, total_count); without counts, a plain
    concatenation (all rows valid).

    The compaction is one stable 1-bit partition over the
    stacked validity mask — no ragged shapes, no host loop."""
    import jax.numpy as jnp

    tables = list(tables)
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    names = tables[0].column_names
    for t in tables[1:]:
        if t.column_names != names:
            raise ValueError(f"column sets differ: {names} vs "
                             f"{t.column_names}")
    cols = {k: jnp.concatenate([t[k] for t in tables]) for k in names}
    if counts is None:
        return Table(cols)
    if len(counts) != len(tables):
        raise ValueError(f"{len(counts)} counts for {len(tables)} tables")
    from cuda.radixsort_tpu.ops.filter import filter_columns

    masks = [jnp.arange(t.num_rows, dtype=jnp.int32)
             < jnp.asarray(c, jnp.int32)
             for t, c in zip(tables, counts)]
    mask = jnp.concatenate(masks)
    out, total = filter_columns(mask, tuple(cols[k] for k in names))
    return Table(dict(zip(names, out))), total
