"""Structured per-stage observability for distributed operators (SURVEY §5).

Every distributed operator returns an ExchangeStats pytree alongside its
result: per-device row counts in/out, wire bytes moved by the exchange, cap
utilization and the post-op skew factor. This replaces the reference's
CUB_DEBUG_LOG prints (util_debug.cuh) with data a driver can act on —
e.g. the skew factor is what a query planner would watch to trigger
repartitioning, and cap_utilization says how tight the two-phase sized
exchange protocol is running.

All fields are computed inside shard_map from values the operators already
have (send counts, receive counts) — no extra collectives beyond one tiny
psum/max per op.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ExchangeStats(NamedTuple):
    """Per-operator exchange statistics.

    rows_in:  (ndev,) int32 — valid input rows contributed per source shard.
    rows_out: (ndev,) int32 — valid result rows owned per destination shard.
    wire_bytes: (ndev,) float32 — bytes each device put on the interconnect.
        This is the PADDED-LANE UPPER BOUND ((ndev-1) send lanes of `cap`
        rows each; the self-lane stays local) even when exact send counts
        are known — it is what the all_to_all physically moves. float32,
        not int: int32 overflows at large caps (2^27 rows x 8 B x 7
        peers ~ 7.5 GB > 2^31), and int64 silently truncates to int32
        with x64 disabled; f32 is exact to
        16 MB and within 1/2^24 above — observability-grade.
    cap: int32 — the static lane capacity the exchange ran with.
    cap_utilization: float32 — max send-lane occupancy / cap (1.0 == the
        sized exchange is tight; ~0 == the default full-shard cap is wasteful).
    skew: float32 — max(rows_out) / mean(rows_out) over devices (1.0 ==
        perfectly balanced; ndev == everything on one device).
    """

    rows_in: jnp.ndarray
    rows_out: jnp.ndarray
    wire_bytes: jnp.ndarray
    cap: jnp.ndarray
    cap_utilization: jnp.ndarray
    skew: jnp.ndarray


def shard_stats(send_counts, rows_out, cap: int, ndev: int, axis_name: str,
                bytes_per_row: int, skew_ndev: int | None = None):
    """Build the per-shard slice of ExchangeStats inside shard_map.

    send_counts: (ndev,) rows this shard sends to each destination (or None
    when the op broadcasts instead of exchanging — wire bytes then must be
    passed precomputed via bytes_per_row with send_counts=None semantics).
    rows_out: () valid rows this shard owns after the op.
    skew_ndev: device count for the skew denominator when it differs from
    the exchange lane count `ndev` (hierarchical exchanges: lanes span one
    mesh axis, skew spans the whole mesh).
    Returns an ExchangeStats whose array fields are shaped (1,) / () for
    out_specs concatenation over the mesh axis.
    """
    skew_ndev = ndev if skew_ndev is None else skew_ndev
    rows_out = jnp.asarray(rows_out, jnp.int32)
    # static Python-int product BEFORE array conversion (no i32 overflow)
    wire = jnp.asarray(float((ndev - 1) * cap * bytes_per_row), jnp.float32)
    if send_counts is None:
        rows_in = rows_out
        util = jnp.float32(1.0)
    else:
        rows_in = jnp.sum(send_counts).astype(jnp.int32)
        util = jnp.max(send_counts).astype(jnp.float32) / jnp.float32(cap)
    # skew over the mesh: psum of rows_out gives the total; pmax the max
    total = jax.lax.psum(rows_out, axis_name)
    mx = jax.lax.pmax(rows_out, axis_name)
    skew = mx.astype(jnp.float32) * skew_ndev / jnp.maximum(
        total.astype(jnp.float32), 1.0)
    return ExchangeStats(
        rows_in=rows_in.reshape(1),
        rows_out=rows_out.reshape(1),
        wire_bytes=wire.reshape(1),
        cap=jnp.asarray(cap, jnp.int32),
        cap_utilization=jax.lax.pmax(util, axis_name),
        skew=skew,
    )


def stats_out_specs(axis_name: str):
    """out_specs entry for an ExchangeStats returned from shard_map: the
    per-device vectors concatenate over the axis, the scalars replicate."""
    from jax.sharding import PartitionSpec as P

    return ExchangeStats(
        rows_in=P(axis_name),
        rows_out=P(axis_name),
        wire_bytes=P(axis_name),
        cap=P(),
        cap_utilization=P(),
        skew=P(),
    )


def describe(stats: ExchangeStats) -> str:
    """One-line human summary (debugging)."""
    import numpy as np

    ri = np.asarray(stats.rows_in)
    ro = np.asarray(stats.rows_out)
    wb = float(np.asarray(stats.wire_bytes).sum())
    util = float(stats.cap_utilization)
    over = "  !!OVERFLOW(rows dropped)" if util > 1.0 else ""
    return (
        f"rows_in={int(ri.sum())} rows_out={int(ro.sum())} "
        f"per_dev_out={ro.tolist()} wire_MB={wb / 1e6:.2f} "
        f"cap={int(stats.cap)} util={util:.2f} "
        f"skew={float(stats.skew):.2f}{over}"
    )
