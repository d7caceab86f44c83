"""Measurement harness — the framework's tracing/profiling subsystem.

Reference parity (SURVEY.md §5): the reference exposes NVTX ranges per public
API call (CUB device_radix_sort.cuh:351,784) and cudaEvent GpuTimer timing.
Equivalents here:

  * `timed_calls` — host clock around calls that end in `block_until_ready`,
    after a warm-up call that compiles.
  * `trace` — wraps a block in jax.profiler.trace (view in TensorBoard /
    Perfetto); operators carry their jitted function names.
  * `PEAKS` / `speed_of_light` — the device's published peaks, keyed by
    `device_kind`, and a bytes-moved model against them. A device that is
    not in the table is an error, never a default.
  * `enable_compile_cache` and `device_record` — the set-up and record
    header shared by `bench.py` and `chip_smoke.py`.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time

import jax

# Published peaks, keyed by jax.devices()[0].device_kind. Source: NVIDIA
# H200 data sheet (SXM part): 141 GB of HBM3e at 4.8 TB/s, rated at 700 W.
PEAKS = {
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "hbm_bytes": 141e9},
}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def peak(kind: str | None = None) -> dict:
    """Published peaks of a device kind (default: the first JAX device)."""
    kind = kind if kind is not None else jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def speed_of_light(bytes_moved: int, seconds: float,
                   kind: str | None = None) -> dict:
    """Fraction of the device-memory bandwidth peak achieved by an op.

    bytes_moved: total device-memory reads+writes of the op (e.g. one radix
    pass over N u32 keys = 2 * 4 * N)."""
    bw = peak(kind)["hbm_bytes_per_s"]
    achieved = bytes_moved / seconds
    return {
        "achieved_bytes_per_s": achieved,
        "hbm_bytes_per_s": bw,
        "fraction_of_sol": achieved / bw,
    }


def timed_calls(fn, args, m: int = 5) -> dict:
    """Time ``jax.jit(fn)(*args)`` with the host clock, every call ending in
    ``block_until_ready``. The first call compiles and is reported apart."""
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(*args))
    first = time.perf_counter() - t0
    samples = []
    for _ in range(m):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        samples.append(time.perf_counter() - t0)
    return {"seconds": statistics.median(samples), "samples": samples,
            "first_call_seconds": first}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope (view in TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def enable_compile_cache() -> str:
    """Persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR``
    says when it is set (JAX reads it; nothing is set here), otherwise the
    fixed in-checkout ``.jax_cache/``, so that a later run finds what an
    earlier one compiled. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def power_limit() -> str:
    """``nvidia-smi`` name and power limit of the cards, read by a child
    process that stays off JAX ("not available" where there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip()


def device_record() -> dict:
    """The header every measurement record carries."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "nvidia_smi": power_limit(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "jax_version": jax.__version__,
    }
