"""External (out-of-core) sort: datasets larger than one chip's HBM.

The scaling mechanism the reference applies INSIDE one GPU — portioning the
input so fixed-size resources cover any N (2^30 histogram portions, 2^28
onesweep portions; SURVEY §5 "long-context analogue") — applied at the
host/device boundary: the device sorts HBM-sized chunks at engine speed,
and the native host runtime (csrc/hostutils.cpp::rt_kway_merge_u32, a
threaded merge-path k-way merge) combines the returned runs. Host RAM is
the capacity limit, not HBM.

Stability: chunks are taken in input order and the native merge breaks key
ties by run index, so the whole pipeline is a stable sort. Payload columns
ride the same merge.

This is a HOST-level operator (numpy in, numpy out, one device round trip
per chunk) — the deliberate exception to the everything-jits rule, since
its reason to exist is exceeding device memory.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu import config as config_lib
from cuda.radixsort_tpu.utils import native


def sort_external(
    keys: np.ndarray,
    *,
    chunk: int = 1 << 27,
    config: config_lib.SortConfig | None = None,
) -> np.ndarray:
    """Ascending sort of a host u32 array of any size that fits host RAM.

    chunk: rows sorted on-device per round trip (default 2^27 = 512 MiB of
    key+buffer traffic).
    """
    if keys.dtype != np.uint32:
        raise TypeError("sort_external: u32 keys (twiddle wider dtypes "
                        "into limbs or use sort_external_pairs)")
    from cuda.radixsort_tpu.ops.sort import sort as _sort

    n = keys.shape[0]
    if n <= chunk:
        return np.asarray(_sort(jnp.asarray(keys), config=config))
    dev_sort = jax.jit(lambda x: _sort(x, config=config), donate_argnums=0)
    runs = []
    for lo in range(0, n, chunk):
        piece = jnp.asarray(keys[lo: lo + chunk])
        runs.append(np.asarray(dev_sort(piece)))
    return native.kway_merge_u32(runs)


def sort_external_pairs(
    keys: np.ndarray,
    values: np.ndarray,
    *,
    chunk: int = 1 << 26,
    config: config_lib.SortConfig | None = None,
):
    """Stable key-value external sort (u32 keys, 4-byte payload)."""
    if keys.dtype != np.uint32:
        raise TypeError("sort_external_pairs: u32 keys")
    if values.dtype.itemsize != 4:
        raise TypeError("sort_external_pairs: 4-byte payload dtype")
    from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs

    n = keys.shape[0]
    if n <= chunk:
        ok, ov = _sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                             config=config)
        return np.asarray(ok), np.asarray(ov)
    dev_sort = jax.jit(lambda k, v: _sort_pairs(k, v, config=config),
                       donate_argnums=(0, 1))
    kruns, vruns = [], []
    for lo in range(0, n, chunk):
        ok, ov = dev_sort(jnp.asarray(keys[lo: lo + chunk]),
                          jnp.asarray(values[lo: lo + chunk]))
        kruns.append(np.asarray(ok))
        vruns.append(np.asarray(ov))
    mk, mv = native.kway_merge_u32(kruns, vruns)
    return mk, mv.view(values.dtype)


def sort_external_file(
    in_path: str,
    out_path: str,
    *,
    chunk: int = 1 << 27,
    tmpdir: str | None = None,
    config: config_lib.SortConfig | None = None,
) -> int:
    """Disk-spill external sort: u32 keys stored as raw little-endian
    binary at `in_path`, ascending result written to `out_path`. Datasets
    may exceed HOST RAM: the input is memory-mapped, each device-sorted
    chunk spills to a temporary run file, and the native k-way merge
    streams runs -> output through np.memmap windows (the OS page cache is
    the working set — the same portioning idea as the reference's 2^28
    onesweep portions, one level further out). Returns the row count.
    """
    import os
    import tempfile

    from cuda.radixsort_tpu.ops.sort import sort as _sort
    from cuda.radixsort_tpu.utils import native

    size = os.path.getsize(in_path)
    if size % 4:
        raise ValueError(f"{in_path}: size {size} is not a u32 multiple")
    n = size // 4
    src = np.memmap(in_path, dtype=np.uint32, mode="r")
    if n <= chunk:
        out = np.memmap(out_path, dtype=np.uint32, mode="w+", shape=(n,))
        out[:] = np.asarray(_sort(jnp.asarray(np.asarray(src)),
                                  config=config))
        out.flush()
        return n
    dev_sort = jax.jit(lambda x: _sort(x, config=config), donate_argnums=0)
    tdir = tempfile.mkdtemp(dir=tmpdir, prefix="tpusort_runs_")
    run_paths = []
    try:
        for i, lo in enumerate(range(0, n, chunk)):
            piece = jnp.asarray(np.asarray(src[lo: lo + chunk]))
            rp = os.path.join(tdir, f"run{i:05d}.u32")
            run = np.memmap(rp, dtype=np.uint32, mode="w+",
                            shape=(min(chunk, n - lo),))
            run[:] = np.asarray(dev_sort(piece))
            run.flush()
            del run
            run_paths.append(rp)
        runs = [np.memmap(rp, dtype=np.uint32, mode="r")
                for rp in run_paths]
        out = np.memmap(out_path, dtype=np.uint32, mode="w+", shape=(n,))
        native.kway_merge_u32(runs, out=out)
        out.flush()
        del runs, out
    finally:
        for rp in run_paths:
            try:
                os.remove(rp)
            except OSError:
                pass
        try:
            os.rmdir(tdir)
        except OSError:
            pass
    return n


def sort_external_pairs_file(
    keys_path: str,
    values_path: str,
    out_keys_path: str,
    out_values_path: str,
    *,
    chunk: int = 1 << 26,
    tmpdir: str | None = None,
    config: config_lib.SortConfig | None = None,
) -> int:
    """Disk-spill stable key-value external sort (u32 keys + 4-byte
    payload as raw binary files) — the pairs sibling of
    `sort_external_file`: memmapped inputs, spilled (key, value) run
    files, one streaming native merge into memmapped outputs."""
    import os
    import tempfile

    from cuda.radixsort_tpu.ops.sort import sort_pairs as _sort_pairs
    from cuda.radixsort_tpu.utils import native

    ksize = os.path.getsize(keys_path)
    vsize = os.path.getsize(values_path)
    if ksize % 4 or vsize != ksize:
        raise ValueError("keys/values files must be equal-length u32-"
                         f"multiples (got {ksize} / {vsize} bytes)")
    n = ksize // 4
    ksrc = np.memmap(keys_path, dtype=np.uint32, mode="r")
    vsrc = np.memmap(values_path, dtype=np.uint32, mode="r")
    if n <= chunk:
        ok, ov = _sort_pairs(jnp.asarray(np.asarray(ksrc)),
                             jnp.asarray(np.asarray(vsrc)), config=config)
        kout = np.memmap(out_keys_path, dtype=np.uint32, mode="w+",
                         shape=(n,))
        vout = np.memmap(out_values_path, dtype=np.uint32, mode="w+",
                         shape=(n,))
        kout[:] = np.asarray(ok)
        vout[:] = np.asarray(ov)
        kout.flush()
        vout.flush()
        return n
    dev_sort = jax.jit(lambda k, v: _sort_pairs(k, v, config=config),
                       donate_argnums=(0, 1))
    tdir = tempfile.mkdtemp(dir=tmpdir, prefix="tpusort_pruns_")
    paths = []
    try:
        for i, lo in enumerate(range(0, n, chunk)):
            m = min(chunk, n - lo)
            ok, ov = dev_sort(jnp.asarray(np.asarray(ksrc[lo: lo + m])),
                              jnp.asarray(np.asarray(vsrc[lo: lo + m])))
            kp = os.path.join(tdir, f"k{i:05d}.u32")
            vp = os.path.join(tdir, f"v{i:05d}.u32")
            for pth, arr in ((kp, ok), (vp, ov)):
                mm = np.memmap(pth, dtype=np.uint32, mode="w+", shape=(m,))
                mm[:] = np.asarray(arr)
                mm.flush()
                del mm
            paths.append((kp, vp))
        kruns = [np.memmap(kp, dtype=np.uint32, mode="r")
                 for kp, _ in paths]
        vruns = [np.memmap(vp, dtype=np.uint32, mode="r")
                 for _, vp in paths]
        kout = np.memmap(out_keys_path, dtype=np.uint32, mode="w+",
                         shape=(n,))
        vout = np.memmap(out_values_path, dtype=np.uint32, mode="w+",
                         shape=(n,))
        native.kway_merge_u32(kruns, vruns, out=kout, vout=vout)
        kout.flush()
        vout.flush()
        del kruns, vruns, kout, vout
    finally:
        for kp, vp in paths:
            for pth in (kp, vp):
                try:
                    os.remove(pth)
                except OSError:
                    pass
        try:
            os.rmdir(tdir)
        except OSError:
            pass
    return n


def join_external(
    build_keys: np.ndarray,
    build_vals: np.ndarray,
    probe_keys: np.ndarray,
    *,
    chunk: int = 1 << 27,
    materialize: bool = True,
    config: config_lib.SortConfig | None = None,
):
    """Out-of-core FK inner join: the build side stays device-resident,
    the probe side streams through in `chunk`-row slices (the BASELINE.json:9 contract shape, 1B probe x 100M build, becomes
    executable on ONE chip: each slice is a (nb + chunk)-row sort-coalesce
    join, the same portioning discipline as the reference's 2^28 onesweep
    portions, dispatch_radix_sort.cuh:712-755).

    Host numpy in / host numpy out. A short final slice is padded with
    probe_valid=False rows so every slice reuses ONE compiled executable.

    materialize=True returns (keys, vals, probe_idx, count) as
    concatenated host arrays (probe_idx is global). materialize=False
    skips the device->host result transfer and returns
    (count, checksum_u32) — the compute-rate path (the device->host
    transfer would otherwise dominate the measurement).
    """
    if probe_keys.dtype != np.uint32 or build_keys.dtype != np.uint32:
        raise TypeError("join_external: u32 keys")
    from cuda.radixsort_tpu.ops.join import join as _join

    nprobe = probe_keys.shape[0]
    bk = jnp.asarray(build_keys)
    bv = jnp.asarray(build_vals)

    @functools.partial(jax.jit, donate_argnums=(2,))
    def one(bk_, bv_, pk_, pvalid_):
        ok, ov, oi, cnt = _join(bk_, bv_, pk_, how="inner",
                                probe_valid=pvalid_, config=config)
        return ok, ov, oi, cnt

    @functools.partial(jax.jit, donate_argnums=(2,))
    def one_fold(bk_, bv_, pk_, pvalid_):
        ok, ov, oi, cnt = _join(bk_, bv_, pk_, how="inner",
                                probe_valid=pvalid_, config=config)
        pos = jnp.arange(ok.shape[0], dtype=jnp.int32)
        live = pos < cnt
        fold = (jnp.sum(jnp.where(live, ok, 0), dtype=jnp.uint32)
                ^ jnp.sum(jnp.where(live, ov, 0),
                          dtype=jnp.int32).astype(jnp.uint32))
        return cnt, fold

    total = 0
    checksum = np.uint32(0)
    out_k, out_v, out_i = [], [], []
    full_valid = jnp.ones((chunk,), bool)
    for lo in range(0, nprobe, chunk):
        m = min(chunk, nprobe - lo)
        piece = probe_keys[lo: lo + m]
        if m < chunk:
            piece = np.concatenate(
                [piece, np.zeros((chunk - m,), np.uint32)])
            pvalid = jnp.asarray(
                np.arange(chunk, dtype=np.int32) < m)
        else:
            pvalid = full_valid
        pdev = jnp.asarray(piece)
        if materialize:
            ok, ov, oi, cnt = one(bk, bv, pdev, pvalid)
            c = int(cnt)
            out_k.append(np.asarray(ok)[:c])
            out_v.append(np.asarray(ov)[:c])
            out_i.append(np.asarray(oi)[:c] + lo)
            total += c
        else:
            cnt, fold = one_fold(bk, bv, pdev, pvalid)
            total += int(cnt)
            checksum ^= np.uint32(fold)
    if materialize:
        return (np.concatenate(out_k) if out_k else np.zeros((0,), np.uint32),
                np.concatenate(out_v) if out_v else np.zeros((0,), build_vals.dtype),
                np.concatenate(out_i) if out_i else np.zeros((0,), np.int32),
                total)
    return total, checksum
