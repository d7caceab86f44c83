"""Smoke run of the engine on one GPU at the BASELINE.json contract sizes.

Drives the main path once through the public entry points, checks every
result on the device or against numpy, and prints one JSON line per phase
(size, compile seconds, run seconds, device memory, verdict):

  1. `rs.sort` of u32 keys: bit-exact against `np.sort` at 2^24; at 2^30,
     sortedness plus a permutation fingerprint (per-byte digit histograms
     and wrapping 64-bit sums) equal to the input's.
  2. stable `rs.sort_pairs`, u64 key + i32 row id, 2^28 pairs.
  3. `ops.join.join`, 2^30 probe x 10^8 build FK join (the largest
     power-of-two probe that fits, if 2^30 does not).
  4. `rs.groupby` sum over 2^28 Zipf-skewed keys, exact against numpy.
  5. the filter -> join -> group-by -> order-by -> limit `Query` over a
     2^27-row fact table and a 2^24-row dimension, exact against numpy.
  6. the tests marked `gpu`, in this process (`pytest.main`, one worker).

`--multichip` runs only the distributed path on four cards, each part
against its one-card counterpart: `dsort.sort_distributed`, the sized
hash join and group-by of `parallel.shuffle`, and the phase-5 plan with
`mesh=`. It prints rows/s on one card and on four.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
any failed phase raises instead, and the script exits non-zero without it,
as it does when JAX finds no GPU. Data is generated on the device from
`--seed`.

    python chip_smoke.py [--seed 0]
    python chip_smoke.py --multichip
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# One process holds the card(s): let it reserve most of their memory. Set
# before anything creates the JAX backend (importing the package does).
os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

import cuda.radixsort_tpu as rs  # noqa: E402
from cuda.radixsort_tpu.ops.join import join as join_op  # noqa: E402
from cuda.radixsort_tpu.utils import profiling  # noqa: E402

_REPO = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------- helpers


def _emit(rec: dict) -> None:
    print(json.dumps(rec, default=str), flush=True)


def _check(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(f"chip_smoke: {what}")


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _hlo_sorts(compiled) -> dict:
    """Which sorts the optimized HLO kept: CUB radix-sort custom calls vs
    XLA's own sort instructions."""
    text = compiled.as_text()
    return {"cub_radix_sort": text.count("__cub$DeviceRadixSort"),
            "xla_sort": text.count(" sort(")}


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")}


def _compile(fn, *args):
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _run(compiled, compile_s: float, *args, runs: int = 2):
    """Run a compiled function `runs` times, each call ending in
    block_until_ready. Returns (out, record)."""
    run_s = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        run_s.append(time.perf_counter() - t0)
    return out, {"compile_s": compile_s, "run_s": run_s,
                 "hlo": _hlo_sorts(compiled), "memory": _memory(compiled)}


def _timed(fn, *args):
    return _run(*_compile(fn, *args), *args)


def _spread_hist(d, nbins):
    """Histogram by scatter-add into 64 interleaved copies (less contention
    on one bin), summed — plain jnp."""
    lane = jnp.arange(d.shape[0], dtype=jnp.uint32) & jnp.uint32(63)
    return (jnp.zeros((64, nbins), jnp.int64)
            .at[lane, d].add(1, mode="drop").sum(axis=0))


@jax.jit
def fingerprint_u32(x):
    """Permutation-invariant fingerprint: the four per-byte histograms and
    wrapping u64 sums of x and x*x."""
    hists = jnp.stack([_spread_hist((x >> jnp.uint32(8 * b)) & jnp.uint32(255),
                                    256) for b in range(4)])
    x64 = x.astype(jnp.uint64)
    return hists, jnp.sum(x64), jnp.sum(x64 * x64)


def zipf_keys(key, n: int, domain: int):
    """Zipf(s=1)-skewed keys in [0, domain): inverse CDF of the log-uniform
    law, P(k) ~ 1/(k+1.5)."""
    u = jax.random.uniform(key, (n,), jnp.float64)
    k = jnp.floor(jnp.exp(u * jnp.log(domain + 1.0))) - 1.0
    return jnp.clip(k, 0, domain - 1).astype(jnp.uint32)


def build_value(k):
    """Closed-form build value of join key k (u32 arithmetic wraps)."""
    return ((k * jnp.uint32(0x9E3779B1)) >> jnp.uint32(1)).astype(jnp.int32)


def dim_value(k):
    """Closed-form dimension payload of key k, in [0, 1000)."""
    return ((k * jnp.uint32(2654435761)) % jnp.uint32(1000)).astype(jnp.int32)


def dim_value_np(k):
    k = np.asarray(k, np.uint64)
    return ((k * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) % np.uint64(1000)


# ---------------------------------------------------------------- phases


def phase_sort_u32(n_exact: int, n_large: int, seed: int) -> dict:
    key = jax.random.PRNGKey(seed)
    keys = jax.random.bits(key, (n_exact,), jnp.uint32)
    out, exact = _timed(rs.sort, keys)
    _check(np.array_equal(np.asarray(out), np.sort(np.asarray(keys))),
           f"rs.sort differs from np.sort at n={n_exact}")
    del keys, out
    keys = jax.random.bits(jax.random.fold_in(key, 1), (n_large,), jnp.uint32)
    fp_in = fingerprint_u32(keys)
    out, large = _timed(rs.sort, keys)
    _check(jnp.all(out[1:] >= out[:-1]), f"rs.sort output unsorted at n={n_large}")
    fp_out = fingerprint_u32(out)
    _check(all(bool(jnp.array_equal(a, b)) for a, b in zip(fp_in, fp_out)),
           f"rs.sort output is no permutation of its input at n={n_large}")
    return {"phase": "sort_u32", "n_exact": n_exact, "exact": exact,
            "n": n_large, **large, "ok": True}


def phase_sort_pairs(n: int, seed: int) -> dict:
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    wide = jax.random.bits(k1, (n,), jnp.uint64)
    narrow = jax.random.bits(k2, (n,), jnp.uint64) & jnp.uint64(1023)
    keys = jnp.where(jax.random.bernoulli(k3, 0.5, (n,)), narrow, wide)
    rowid = jnp.arange(n, dtype=jnp.int32)
    (ko, po), rec = _timed(rs.sort_pairs, keys, rowid)

    @jax.jit
    def verdict(keys, ko, po):
        nondecr = jnp.all(ko[1:] >= ko[:-1])
        stable = jnp.all((ko[1:] != ko[:-1]) | (po[1:] > po[:-1]))
        follows = jnp.all(jnp.take(keys, po) == ko)
        perm = jnp.all(jnp.zeros((n,), jnp.int32).at[po].add(1) == 1)
        return nondecr, stable, follows, perm

    nondecr, stable, follows, perm = verdict(keys, ko, po)
    _check(nondecr, "sort_pairs keys not non-decreasing")
    _check(stable, "sort_pairs row ids not increasing within equal keys")
    _check(follows, "sort_pairs payload does not follow its key")
    _check(perm, "sort_pairs payload is no permutation")
    return {"phase": "sort_pairs_u64_i32", "n": n, **rec, "ok": True}


def _join_inputs(n_probe: int, n_build: int, seed: int):
    key = jax.random.PRNGKey(seed)
    kb, kp = jax.random.split(key)
    bk = (jax.random.permutation(kb, n_build).astype(jnp.uint32)
          * jnp.uint32(2))
    pk = jax.random.bits(kp, (n_probe,), jnp.uint32) % jnp.uint32(2 * n_build)
    return bk, build_value(bk), pk


def phase_join(n_probe: int, n_build: int, seed: int) -> dict:
    """FK inner join: build keys are the even numbers below 2*n_build in a
    seeded order, probe keys uniform below 2*n_build, so exactly the even
    probe keys match. Halves the probe while the compiled join does not fit
    the free device memory."""
    def run(bk, bv, pk):
        return join_op(bk, bv, pk, how="inner")

    reduced = []
    while True:
        bk, bv, pk = _join_inputs(n_probe, n_build, seed)
        compiled, compile_s = _compile(run, bk, bv, pk)
        mem = _memory(compiled)
        stats = jax.devices()[0].memory_stats() or {}
        free = stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)
        need = (mem.get("output_size_in_bytes", 0)
                + mem.get("temp_size_in_bytes", 0))
        if not stats or need <= free or n_probe <= (1 << 20):
            break
        _emit({"phase": "join", "n_probe": n_probe, "memory": mem,
               "free_bytes": free, "note": "does not fit; halving probe"})
        reduced.append(n_probe)
        del bk, bv, pk, compiled
        n_probe //= 2
    (ok, ov, oi, cnt), rec = _run(compiled, compile_s, bk, bv, pk)

    @jax.jit
    def verdict(pk, ok, ov, oi, cnt):
        live = jnp.arange(ok.shape[0]) < cnt
        rows_ok = jnp.all(~live | ((ov == build_value(ok))
                                   & (jnp.take(pk, oi, mode="clip") == ok)))
        want = jnp.sum((pk % jnp.uint32(2) == 0).astype(jnp.int64))
        hit = jnp.zeros(pk.shape, jnp.int32).at[
            jnp.where(live, oi, pk.shape[0])].set(1, mode="drop")
        return rows_ok, want, jnp.sum(hit.astype(jnp.int64))

    rows_ok, want, distinct = verdict(pk, ok, ov, oi, cnt)
    _check(rows_ok, "join output rows disagree with the closed form")
    _check(int(cnt) == int(want),
           f"join matched {int(cnt)} rows, {int(want)} probe keys are even")
    _check(int(distinct) == int(want), "join emitted a probe row twice")
    return {"phase": "join", "n_probe": n_probe, "n_build": n_build,
            "matches": int(cnt), "reduced_from": reduced, **rec, "ok": True}


def phase_groupby(n: int, domain: int, seed: int) -> dict:
    key = jax.random.PRNGKey(seed)
    kk, kv = jax.random.split(key)
    keys = zipf_keys(kk, n, domain)
    vals = jax.random.randint(kv, (n,), -(1 << 23), 1 << 23, jnp.int64)
    (gk, gv, cnt), rec = _timed(lambda k, v: rs.groupby(k, v, agg="sum"),
                                keys, vals)
    # numpy oracle: |sums| < 2^(23 + log2 n) <= 2^53, so float64 bincount
    # weights are exact
    hk, hv = np.asarray(keys), np.asarray(vals)
    present = np.bincount(hk, minlength=domain) > 0
    sums = np.bincount(hk, weights=hv.astype(np.float64), minlength=domain)
    want_k = np.nonzero(present)[0]
    c = int(cnt)
    _check(c == want_k.shape[0], f"groupby found {c} groups, numpy "
           f"{want_k.shape[0]}")
    _check(np.array_equal(np.asarray(gk)[:c], want_k.astype(np.uint32)),
           "groupby keys differ from numpy")
    _check(np.array_equal(np.asarray(gv)[:c], sums[want_k].astype(np.int64)),
           "groupby i64 sums differ from numpy")
    return {"phase": "groupby_zipf_sum", "n": n, "groups": c, **rec,
            "ok": True}


def _query_tables(n_fact: int, n_dim: int, seed: int):
    key = jax.random.PRNGKey(seed)
    kk, kv, kd = jax.random.split(key, 3)
    fk = jax.random.bits(kk, (n_fact,), jnp.uint32) % jnp.uint32(2 * n_dim)
    fv = jax.random.randint(kv, (n_fact,), -1000, 1001, jnp.int32)
    dk = jax.random.permutation(kd, n_dim).astype(jnp.uint32)
    return rs.table(k=fk, v=fv), rs.table(k=dk, p=dim_value(dk))


def query_plan(fact, dim, limit: int = 100):
    return (rs.Query(fact).where(lambda t: t["v"] > 0)
            .join(dim, on="k", value="p")
            .groupby("k", "p", agg="sum")
            .order_by("p", descending=True).limit(limit))


def check_query(fact, n_dim: int, cols, count, limit: int = 100) -> None:
    """Exact check of the phase-5 result against numpy: every returned
    (k, sum) is right, and the returned sums are the `limit` largest."""
    hk, hv = np.asarray(fact["k"]), np.asarray(fact["v"])
    sel = hk[(hv > 0) & (hk < n_dim)]
    counts = np.bincount(sel, minlength=n_dim).astype(np.int64)
    sums = counts * dim_value_np(np.arange(n_dim)).astype(np.int64)
    want_top = np.sort(sums[counts > 0])[::-1][:limit]
    c = int(np.asarray(count))
    _check(c == want_top.shape[0], f"query returned {c} rows")
    got_k = np.asarray(cols["k"])[:c].astype(np.int64)
    got_p = np.asarray(cols["p"])[:c].astype(np.int64)
    _check(np.all(counts[got_k] > 0) and np.array_equal(sums[got_k], got_p),
           "query sums disagree with numpy")
    _check(np.array_equal(got_p, want_top), "query top sums disagree")


def phase_query(n_fact: int, n_dim: int, seed: int) -> dict:
    fact, dim = _query_tables(n_fact, n_dim, seed)
    jax.block_until_ready((fact, dim))
    plan = query_plan(fact, dim)
    run_s = []
    for _ in range(2):   # the first call compiles
        t0 = time.perf_counter()
        cols, count, _ = plan.run()
        jax.block_until_ready((cols, count))
        run_s.append(time.perf_counter() - t0)
    check_query(fact, n_dim, cols, count)
    return {"phase": "query", "n_fact": n_fact, "n_dim": n_dim,
            "first_call_s": run_s[0], "run_s": run_s[1:], "ok": True}


class _Tally:
    """pytest plugin: counts outcomes of the test calls."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests() -> dict:
    import pytest

    os.environ["RS_TEST_GPU"] = "1"
    tally = _Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(_REPO, "tests")], plugins=[tally])
    rec = {"phase": "gpu_tests", "passed": tally.passed,
           "failed": tally.failed, "skipped": tally.skipped,
           "seconds": time.perf_counter() - t0, "rc": int(rc)}
    _check(rc == 0 and tally.failed == 0 and tally.passed > 0,
           f"gpu-marked tests: {rec}")
    return {**rec, "ok": True}


# ---------------------------------------------------------------- four cards


def _valid_rows(counts, per: int):
    """Mask of the valid rows of a sharded (ndev*per,) output."""
    counts = np.asarray(counts)
    return (np.arange(counts.shape[0] * per) % per) < np.repeat(counts, per)


def _dense_by_index(idx, vals, valid, size: int):
    """Host copy of vals scattered to idx (rows where valid) in a dense
    (size,) array, plus the hit mask."""
    idx, vals = np.asarray(idx)[valid], np.asarray(vals)[valid]
    dense, hit = np.zeros(size, vals.dtype), np.zeros(size, bool)
    dense[idx] = vals
    hit[idx] = True
    return dense, hit


def multichip(per_card: int, sort_n: int, n_dim: int, seed: int,
               ndev: int = 4):
    """Distributed sort, join, group-by and plan on an `ndev`-card mesh,
    each against the one-card operator on the same data. Yields one record
    per part as it passes."""
    from cuda.radixsort_tpu.parallel import dsort, shuffle

    mesh = dsort.make_mesh(ndev)
    dev0 = jax.devices()[0]
    key = jax.random.PRNGKey(seed)

    def clock(fn, *args):
        jax.block_until_ready(fn(*args))          # warm-up (compiles)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    # -- sort --------------------------------------------------------------
    keys = jax.random.bits(jax.random.fold_in(key, 0), (sort_n,), jnp.uint32)
    (out, counts, _cap, _st), t4 = clock(
        lambda k: dsort.sort_distributed_sized(k, mesh=mesh), keys)
    one = jax.device_put(keys, dev0)
    ref, t1 = clock(rs.sort, one)
    got = dsort.reconstruct_sorted(out, counts, jnp.uint32, sort_n)
    _check(np.array_equal(got, np.asarray(ref)),
           "sort_distributed differs from one-card rs.sort")
    yield {"phase": "multichip_sort", "n": sort_n, "ndev": ndev,
           "rows_per_s_1": sort_n / t1, "rows_per_s_n": sort_n / t4,
           "ok": True}
    del keys, out, one, ref, got

    # -- hash join on Zipf probe keys ---------------------------------------
    n = per_card * ndev
    nb = max(n // 16, 1)
    bk = jax.random.permutation(jax.random.fold_in(key, 1), nb).astype(
        jnp.uint32)
    bv = build_value(bk)
    pk = zipf_keys(jax.random.fold_in(key, 2), n, 2 * nb)
    (ok, ov, oi, cnt, _caps, _st), t4 = clock(
        lambda b, v, p: shuffle.join_distributed_sized(b, v, p, mesh=mesh),
        bk, bv, pk)
    (sk, sv, si, scnt), t1 = clock(
        lambda b, v, p: join_op(b, v, p, how="inner"), bk, bv, pk)
    per = ok.shape[0] // ndev
    dv, dh = _dense_by_index(oi, ov, _valid_rows(cnt, per), size=n)
    sv_, sh = _dense_by_index(si, sv, np.arange(sk.shape[0]) < int(scnt),
                              size=n)
    _check(int(np.sum(cnt)) == int(scnt), "distributed join match count")
    _check(np.array_equal(dh, sh) and np.array_equal(dv, sv_),
           "join_distributed_sized differs from the one-card join")
    yield {"phase": "multichip_join", "n_probe": n, "n_build": nb,
           "ndev": ndev, "rows_per_s_1": n / t1, "rows_per_s_n": n / t4,
           "ok": True}
    del bk, bv, pk, ok, ov, oi, sk, sv, si

    # -- group-by on Zipf keys ----------------------------------------------
    domain = max(n // 4, 2)
    gkeys = zipf_keys(jax.random.fold_in(key, 3), n, domain)
    gvals = jax.random.randint(jax.random.fold_in(key, 4), (n,), -1000, 1000,
                               jnp.int64)
    (dk, dvv, dcnt, _cap, _st), t4 = clock(
        lambda k, v: shuffle.groupby_distributed_sized(k, v, mesh=mesh,
                                                       agg="sum"),
        gkeys, gvals)
    (gk, gv, gcnt), t1 = clock(lambda k, v: rs.groupby(k, v, agg="sum"),
                               gkeys, gvals)
    per = dk.shape[0] // ndev
    a, ah = _dense_by_index(dk, dvv, _valid_rows(dcnt, per), size=domain)
    b, bh = _dense_by_index(gk, gv, np.arange(gk.shape[0]) < int(gcnt),
                            size=domain)
    _check(int(np.sum(dcnt)) == int(gcnt), "distributed group count")
    _check(np.array_equal(ah, bh) and np.array_equal(a, b),
           "groupby_distributed_sized differs from the one-card groupby")
    yield {"phase": "multichip_groupby", "n": n, "ndev": ndev,
           "rows_per_s_1": n / t1, "rows_per_s_n": n / t4, "ok": True}
    del gkeys, gvals, dk, dvv, gk, gv

    # -- the phase-5 plan with mesh= ------------------------------------------
    fact, dim = _query_tables(n, n_dim, seed + 5)
    plan = query_plan(fact, dim)
    (cols1, c1, _), t1 = clock(plan.run)
    (cols4, c4, _), t4 = clock(lambda: plan.run(mesh=mesh))
    check_query(fact, n_dim, cols1, c1)
    check_query(fact, n_dim, cols4, c4)
    yield {"phase": "multichip_query", "n_fact": n, "n_dim": n_dim,
           "ndev": ndev, "rows_per_s_1": n / t1, "rows_per_s_n": n / t4,
           "ok": True}


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multichip", action="store_true",
                    help="four cards: the distributed path only")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    profiling.enable_compile_cache()
    _emit({"jax_version": jax.__version__,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "device_kind": devs[0].device_kind, "device_count": len(devs)})
    print("nvidia-smi name, power.limit:", flush=True)
    print(profiling.power_limit(), flush=True)

    s = args.seed
    if args.multichip:
        if len(devs) < 4:
            print(f"chip_smoke: --multichip needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 2
        phases = [lambda: multichip(1 << 26, 1 << 30, 1 << 24, s)]
    else:
        phases = [
            lambda: phase_sort_u32(1 << 24, 1 << 30, s),
            lambda: phase_sort_pairs(1 << 28, s + 1),
            lambda: phase_join(1 << 30, 100_000_000, s + 2),
            lambda: phase_groupby(1 << 28, 1 << 24, s + 3),
            lambda: phase_query(1 << 27, 1 << 24, s + 4),
            phase_gpu_tests,
        ]
    for phase in phases:
        t0 = time.perf_counter()
        recs = phase()
        for rec in [recs] if isinstance(recs, dict) else recs:
            _emit({**rec, "phase_wall_s": time.perf_counter() - t0,
                   "peak_bytes_in_use_so_far": _peak_bytes()})
            t0 = time.perf_counter()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
