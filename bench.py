"""Sort benchmark on one GPU — prints JSON record lines.

Metric (BASELINE.json:2): keys/s sorting uint32 with `rs.sort`, at 2^24 and
at the contract's 2^30 (set BENCH_SKIP_1B=1 to skip the second). Keys are
generated on the device. Each size is warmed up (compiled) first, then timed
with the host clock around calls that end in `block_until_ready`; the
record gives the median and every sample.

Every record names the platform, device kind, device count and the card's
power limit. The script fails when JAX finds no GPU: a CPU time is no
measurement of this program.

    python bench.py
"""

import json
import os
import sys

import jax
import jax.numpy as jnp

from cuda.radixsort_tpu.utils import profiling

SKIP_1B = os.environ.get("BENCH_SKIP_1B") == "1"


def bench_sort(logn: int, seed: int, header: dict) -> dict:
    import cuda.radixsort_tpu as rs

    keys = jax.random.bits(jax.random.PRNGKey(seed), (1 << logn,),
                           jnp.uint32)
    r = profiling.timed_calls(rs.sort, (keys,), m=5)
    return {**header, "metric": f"u32_sort_keys_per_s_2^{logn}",
            "value": (1 << logn) / r["seconds"], "unit": "keys/s",
            "seconds_median": r["seconds"], "seconds_samples": r["samples"],
            "first_call_seconds": r["first_call_seconds"]}


def main() -> int:
    profiling.enable_compile_cache()
    header = profiling.device_record()
    if header["platform"] != "gpu":
        print(json.dumps({**header, "error": "no GPU found"}), flush=True)
        return 1
    print(json.dumps(bench_sort(24, 0, header)), flush=True)
    if not SKIP_1B:
        print(json.dumps(bench_sort(30, 1, header)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
