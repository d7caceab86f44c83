"""Distributed segmented scan (scan-by-key) over a device mesh.

Reference scope: the single-GPU reference has no multi-device scans; this is
the mesh-scale generalization the BASELINE contract demands of every
operator (BASELINE.json:5). Single-chip semantics: ops/scan.py (runs of
consecutive equal keys, cub::DeviceScan::*ByKey).

Design — the decoupled-lookback idea done the XLA way: each
shard scans locally (one fused associative_scan), publishes a 4-number
summary (first key, last key, tail-run total, whole-shard-is-one-run flag),
and ONE tiny all_gather lets every shard resolve its cross-shard carry by
walking predecessor summaries — a static ndev-step loop over scalars, not a
polling protocol over device-memory flags. No row ever moves between devices: carries
are O(ndev) scalars while CUB's lookback chain serializes block-to-block
through global memory.

Shard boundaries: a run that spans shards must keep accumulating, so shard
d's carry combines the tail totals of the maximal chain of predecessors
p = d-1, d-2, ... whose last key equals shard d's first key, stopping at the
first predecessor that is not entirely a single run (its tail total already
starts at a run head). The carry applies only to shard d's FIRST run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cuda.radixsort_tpu.ops.scan import _resolve_op, segmented_scan
from cuda.radixsort_tpu.parallel.dsort import axis_size


@functools.partial(
    jax.jit,
    static_argnames=("op", "exclusive", "mesh", "axis_name"),
)
def scan_by_key_distributed(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    op="sum",
    *,
    mesh: Mesh,
    axis_name="x",
    exclusive: bool = False,
    init=None,
    identity=None,
):
    """Scan `values` within runs of consecutive equal `keys`, where both are
    global (n,) arrays laid out shard-major over `axis_name` — the result is
    bit-identical to the single-chip ``scan_by_key(keys, values, ...)``.

    op: "sum" | "prod" | "min" | "max" or an associative callable (callable
    needs identity=). `init` seeds every segment of an exclusive scan, or
    folds into every element of an inclusive one (CUB semantics). n that
    does not divide the mesh is padded transparently (pads extend the final
    run with the operator identity — they cannot change real outputs).
    """
    ndev = axis_size(mesh, axis_name)
    f, ident = _resolve_op(op, identity, values.dtype, need_identity=True)
    n = keys.shape[0]
    if values.shape[0] != n:
        raise ValueError(f"keys/values length mismatch: {n} vs "
                         f"{values.shape[0]}")
    if n == 0:
        return values
    npad = -n % ndev
    if npad:
        keys = jnp.concatenate([keys, jnp.broadcast_to(keys[-1:], (npad,))])
        values = jnp.concatenate(
            [values, jnp.full((npad,), ident, values.dtype)])

    def shard_fn(k, v):
        s = k.shape[0]
        heads = jnp.concatenate(
            [jnp.ones((1,), bool), k[1:] != k[:-1]])
        # local inclusive scan always runs: its last slot is the shard's
        # tail-run total (accumulation since the shard's last run head)
        inc = segmented_scan(v, heads, op, identity=identity)
        local = (segmented_scan(v, heads, op, identity=identity,
                                exclusive=True)
                 if exclusive else inc)
        n_heads = jnp.sum(heads.astype(jnp.int32))
        tails = jax.lax.all_gather(inc[-1], axis_name)          # (ndev,)
        lasts = jax.lax.all_gather(k[-1], axis_name)            # (ndev,)
        whole = jax.lax.all_gather(n_heads == 1, axis_name)     # (ndev,)
        d = jax.lax.axis_index(axis_name).astype(jnp.int32)

        def step(p, carry_state):
            carry, cont, has = carry_state
            in_range = p < d
            match = in_range & (lasts[d - 1 - p] == k[0]) & cont
            new_carry = jnp.where(match,
                                  jnp.where(has, f(tails[d - 1 - p], carry),
                                            tails[d - 1 - p]),
                                  carry)
            return (new_carry, match & whole[d - 1 - p], has | match)

        carry, _, has_carry = jax.lax.fori_loop(
            0, ndev - 1, step,
            (jnp.full((), ident, v.dtype), jnp.ones((), bool),
             jnp.zeros((), bool)))
        # the carry feeds only the shard's first run (rows before the first
        # interior head)
        interior = jnp.cumsum(
            jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             heads[1:].astype(jnp.int32)]))
        first_run = interior == 0
        return jnp.where(first_run & has_carry, f(carry, local), local)

    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name), check_vma=False,
    )(keys, values)
    if init is not None:
        out = f(jnp.asarray(init, values.dtype), out)
    if npad:
        # slicing a shard_map output to a non-divisible length is not
        # expressible in the sharded type system — replicate via an explicit
        # tiled all_gather first (the ragged-n path trades one gather for
        # transparent padding)
        out = shard_map(
            lambda x: jax.lax.all_gather(x, axis_name, tiled=True),
            mesh=mesh, in_specs=P(axis_name), out_specs=P(),
            check_vma=False,
        )(out)
        out = out[:n]
    return out
