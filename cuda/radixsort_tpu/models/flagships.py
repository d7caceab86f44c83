"""Flagship pipelines — the framework's "model zoo".

The reference is a sort program, not an ML framework; its model-family
analogue is the set of benchmark pipeline configurations (BASELINE.json:
6-12). Each flagship here returns ``(fn, example_args)`` with ``fn``
jittable — the same contract as ``__graft_entry__.entry`` — so drivers,
benches and compile checks can enumerate every end-to-end configuration
from one registry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _rng_u32(seed: int, n: int) -> jnp.ndarray:
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))


def sort_u32(n: int = 1 << 20):
    """Keys-only u32 sort — the headline config."""
    import cuda.radixsort_tpu as rs

    def fn(keys):
        return rs.sort(keys)

    return fn, (_rng_u32(0, n),)


def sort_pairs_u64(n: int = 1 << 18):
    """Stable (u64-as-(hi,lo) struct key, i32 payload) pair sort."""
    import cuda.radixsort_tpu as rs

    def fn(hi, lo, pay):
        (ohi, olo), op = rs.sort_struct((hi, lo), pay)
        return ohi, olo, op

    return fn, (_rng_u32(1, n), _rng_u32(2, n),
                jnp.arange(n, dtype=jnp.int32))


def fk_join(n_probe: int = 1 << 18, n_build: int = 1 << 14):
    """FK inner join: probe rows against a unique-key build table."""
    from cuda.radixsort_tpu.ops.join import join

    def fn(build_keys, build_vals, probe_keys):
        return join(build_keys, build_vals, probe_keys, how="inner")

    bk = jnp.arange(n_build, dtype=jnp.uint32)
    pk = _rng_u32(3, n_probe) % jnp.uint32(n_build)
    return fn, (bk, bk.astype(jnp.int32), pk)


def groupby_zipf(n: int = 1 << 18):
    """Group-by sum over skewed keys (half the rows share one key)."""
    import cuda.radixsort_tpu as rs

    def fn(keys, vals):
        return rs.groupby(keys, vals, agg="sum")

    k = _rng_u32(4, n)
    k = jnp.where(k < jnp.uint32(1 << 31), jnp.uint32(42), k % jnp.uint32(1000))
    return fn, (k, jnp.arange(n, dtype=jnp.int32))


def filter_sort_join_query(n_probe: int = 1 << 18, n_build: int = 1 << 14):
    """The pipelined query: filter -> join -> compact, with stats."""
    from cuda.radixsort_tpu.pipeline.query import filter_sort_join

    def fn(probe_keys, probe_vals, build_keys, build_vals):
        return filter_sort_join(probe_keys, probe_vals, build_keys,
                                build_vals, jnp.int32(1 << 19))

    bk = jnp.arange(n_build, dtype=jnp.uint32)
    pk = _rng_u32(5, n_probe) % jnp.uint32(n_build)
    pv = (_rng_u32(6, n_probe) % jnp.uint32(1 << 20)).astype(jnp.int32)
    return fn, (pk, pv, bk, bk.astype(jnp.int32))


def sort_pairs_u32(n: int = 1 << 18):
    """Stable (u32 key, u32 payload) pairs — the multi-plane network path."""
    import cuda.radixsort_tpu as rs

    def fn(keys, pay):
        return rs.sort_pairs(keys, pay)

    return fn, (_rng_u32(7, n), _rng_u32(8, n))


def table_query(n: int = 1 << 18, n_build: int = 1 << 14):
    """Column-batch Table pipeline: filter -> join -> groupby."""
    import cuda.radixsort_tpu as rs

    def fn(k, v, bk, bv):
        t = rs.Table({"k": k, "v": v})
        f, cnt = t.filter(v > 0)
        j, jcnt = f.join(rs.Table({"k": bk, "bval": bv}), on="k",
                         value="bval")
        g, gcnt = j.groupby("k", "bval", agg="sum")
        return g["k"], g["bval"], gcnt

    bk = jnp.arange(n_build, dtype=jnp.uint32)
    k = _rng_u32(9, n) % jnp.uint32(n_build)
    v = (_rng_u32(10, n) % jnp.uint32(200)).astype(jnp.int32) - 100
    return fn, (k, v, bk, bk.astype(jnp.int32))


def window_pipeline(n: int = 1 << 18):
    """Analytics window pipeline: partition ranks + running totals in one
    struct sort (ops/window.py)."""
    from cuda.radixsort_tpu.ops.window import window as window_op

    def fn(part, order, vals):
        sp, so, sv, wc, cnt = window_op(
            part, order, {"v": vals},
            (("rn", None, "row_number"), ("rk", None, "rank"),
             ("cs", "v", "cumsum")))
        return sp, wc["rn"], wc["rk"], wc["cs"], cnt

    part = _rng_u32(5, n) % jnp.uint32(1 << 10)
    order = _rng_u32(6, n) % jnp.uint32(1 << 20)
    return fn, (part, order, (_rng_u32(7, n) % jnp.uint32(99))
                .astype(jnp.int32))


def outer_join_agg(n_probe: int = 1 << 18, n_build: int = 1 << 14):
    """Full outer join feeding a grouped mean — the outer-join operator set
    end-to-end (outer join -> decomposed aggregate)."""
    import cuda.radixsort_tpu as rs
    from cuda.radixsort_tpu.ops.join import join

    def fn(build_keys, build_vals, probe_keys):
        ok, ov, oi, cnt, om = join(build_keys, build_vals, probe_keys,
                                   how="full")
        valid = jnp.arange(ok.shape[0], dtype=jnp.int32) < cnt
        gk, gv, gcnt = rs.groupby(ok, ov, agg="mean", valid=valid)
        return gk, gv, gcnt

    bk = jnp.arange(n_build, dtype=jnp.uint32) * jnp.uint32(2)
    pk = _rng_u32(8, n_probe) % jnp.uint32(2 * n_build)
    return fn, (bk, bk.astype(jnp.int32), pk)


REGISTRY = {
    "sort_u32": sort_u32,
    "sort_pairs_u64": sort_pairs_u64,
    "sort_pairs_u32": sort_pairs_u32,
    "fk_join": fk_join,
    "groupby_zipf": groupby_zipf,
    "filter_sort_join_query": filter_sort_join_query,
    "table_query": table_query,
    "window_pipeline": window_pipeline,
    "outer_join_agg": outer_join_agg,
}
