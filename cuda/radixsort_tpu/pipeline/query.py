"""Pipelined query execution: filter -> sort -> join (BASELINE.json:11).

The end-to-end demonstration query of the framework, single-chip and
distributed. Each stage returns a stats entry (rows in/out, selectivity —
the structured observability of SURVEY.md §5: per-stage stats as a pytree,
replacing the reference's CUB_DEBUG_LOG prints).

Distributed: probe rows stay sharded; the filter and sort run shard-local
under shard_map; the join broadcasts the build side (all_gather)
— XLA schedules the gather asynchronously against the local filter/sort
compute, which is the exchange/compute overlap BASELINE.json asks for.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.ops.filter import filter_columns
from cuda.radixsort_tpu.ops.join import join as join_op
from cuda.radixsort_tpu.parallel.dsort import axis_size


class QueryStats(NamedTuple):
    rows_in: jnp.ndarray
    rows_after_filter: jnp.ndarray
    rows_joined: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("config",))
def filter_sort_join(
    probe_keys: jnp.ndarray,
    probe_vals: jnp.ndarray,
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    threshold,
    config: config_lib.SortConfig | None = None,
):
    """SELECT p.key, p.val, b.val FROM probe p JOIN build b USING (key)
    WHERE p.val > threshold — single chip.

    Returns (keys, probe_vals, build_vals, count, stats): rows [0, count)
    valid, ordered by key.
    """
    n = probe_keys.shape[0]
    mask = probe_vals > threshold
    (fk, fv), nf = filter_columns(mask, (probe_keys, probe_vals),
                                 config=config)

    # join ignores the invalid tail by keying it with a reserved sentinel
    # that cannot match any build key (build keys are user data; instead we
    # bound the probe side to the valid prefix via a mask column carried
    # through the join's probe_idx).
    ok, ov, oi, cnt = join_op(build_keys, build_vals, fk, how="inner",
                              config=config)
    # drop matches whose probe row was filtered out (idx >= nf)
    keep = (jnp.arange(ok.shape[0]) < cnt) & (oi < nf)
    (k2, bv2, pi2), cnt2 = filter_columns(keep, (ok, ov, oi), config=config)
    pv2 = jnp.take(fv, pi2, axis=0)
    stats = QueryStats(
        rows_in=jnp.asarray(n, jnp.int32),
        rows_after_filter=nf.astype(jnp.int32),
        rows_joined=cnt2.astype(jnp.int32),
    )
    return k2, pv2, bv2, cnt2, stats


@functools.partial(jax.jit, static_argnames=("mesh", "axis_name",
                                             "join_strategy", "config"))
def filter_sort_join_distributed(
    probe_keys: jnp.ndarray,
    probe_vals: jnp.ndarray,
    build_keys: jnp.ndarray,
    build_vals: jnp.ndarray,
    threshold,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    join_strategy: str = "auto",
    config: config_lib.SortConfig | None = None,
):
    """Distributed variant: probe sharded over the mesh axis; the build side
    is BROADCAST (small builds — no probe movement) or HASH-EXCHANGED with
    the filtered probe rows (large builds — BASELINE.json:9's shape), per
    `join_strategy` ('auto' routes at 2^20 build rows). Returns per-shard
    results concatenated on the axis plus per-shard counts and a stats
    pytree (psum-reduced totals)."""
    if join_strategy not in ("auto", "broadcast", "hash"):
        raise ValueError(join_strategy)
    if join_strategy == "auto":
        join_strategy = ("broadcast" if build_keys.shape[0] <= (1 << 20)
                         else "hash")

    if join_strategy == "broadcast":
        def shard_fn(pk, pv, bk, bv):
            bk_full = jax.lax.all_gather(bk.reshape(-1), axis_name,
                                         tiled=True)
            bv_full = jax.lax.all_gather(bv.reshape(-1), axis_name,
                                         tiled=True)
            k, pvv, bvv, cnt, stats = filter_sort_join(
                pk.reshape(-1), pv.reshape(-1), bk_full, bv_full, threshold,
                config=config,
            )
            tot = QueryStats(*[jax.lax.psum(s, axis_name) for s in stats])
            return (k.reshape(1, -1), pvv.reshape(1, -1), bvv.reshape(1, -1),
                    cnt.reshape(1, 1), tot)
    else:
        from cuda.radixsort_tpu.ops.filter import filter_columns
        from cuda.radixsort_tpu.ops.join import join as join_op
        from cuda.radixsort_tpu.parallel.shuffle import (
            _owner_of_keys, exchange_rows,
        )

        ndev = axis_size(mesh, axis_name)

        def shard_fn(pk, pv, bk, bv):
            pk, pv = pk.reshape(-1), pv.reshape(-1)
            bk, bv = bk.reshape(-1), bv.reshape(-1)
            sp, sb = pk.shape[0], bk.shape[0]
            n = sp * ndev
            # 1. local filter (selection vector; rows [0, nf) valid)
            mask = pv > threshold
            (fk, fv), nf = filter_columns(mask, (pk, pv), config=config)
            pvalid = jnp.arange(sp) < nf
            # 2. hash-exchange: filtered probe rows AND build rows move to
            #    owner = hash(key) % ndev; the probe's exchange is issued
            #    first so its all_to_all overlaps the build-side grouping
            #    compute (XLA async collectives)
            destp = jnp.where(pvalid, _owner_of_keys(fk, ndev), ndev)
            (rpk, rpv), rpvalid = exchange_rows(
                [fk, fv], destp, ndev, axis_name, sp)
            destb = _owner_of_keys(bk, ndev)
            (rbk, rbv), rbvalid = exchange_rows(
                [bk, bv], destb, ndev, axis_name, sb)
            # 3. local join of the received key partitions
            ok, ov, oi, cnt = join_op(
                rbk, rbv, rpk, how="inner",
                build_valid=rbvalid, probe_valid=rpvalid, config=config)
            opv = jnp.take(rpv, oi, axis=0)  # probe values followed the rows
            tot = QueryStats(
                rows_in=jax.lax.psum(jnp.asarray(n, jnp.int32) // ndev,
                                     axis_name),
                rows_after_filter=jax.lax.psum(nf.astype(jnp.int32),
                                               axis_name),
                rows_joined=jax.lax.psum(cnt.astype(jnp.int32), axis_name),
            )
            return (ok.reshape(1, -1), opv.reshape(1, -1),
                    ov.reshape(1, -1), cnt.reshape(1, 1), tot)

    k, pv, bv, cnt, stats = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis_name),) * 4,
        out_specs=((P(axis_name),) * 4
                   + (jax.tree.map(lambda _: P(), QueryStats(0, 0, 0)),)),
        check_vma=False,
    )(probe_keys, probe_vals, build_keys, build_vals)
    return k.reshape(-1), pv.reshape(-1), bv.reshape(-1), cnt.reshape(-1), stats
