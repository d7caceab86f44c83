"""Radix partition (`rs.partition`) vs numpy: bucket order, stability and
skewed inputs, on both engines."""

import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu import twiddle

N = 8192
ENGINES = pytest.mark.parametrize(
    "cfg", [rs.SortConfig(engine="xla"),
            rs.SortConfig(engine="reference", radix_bits=4, tile_rows=8)],
    ids=["xla", "reference"])


def _oracle(keys, bits, payload=None):
    bkt = (np.asarray(twiddle.twiddle_in(jnp.asarray(keys))).astype(np.uint64)
           >> np.uint64(32 - bits))
    order = np.argsort(bkt, kind="stable")
    offsets = np.searchsorted(bkt[order], np.arange((1 << bits) + 1),
                              side="left")
    offsets[-1] = keys.shape[0]
    return keys[order], (payload[order] if payload is not None else None), offsets


@ENGINES
@pytest.mark.parametrize("bits", [4, 8])
def test_partition_uniform(cfg, bits):
    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    ko, _, off = rs.partition(jnp.asarray(keys), bits=bits, config=cfg)
    want, _, want_off = _oracle(keys, bits)
    np.testing.assert_array_equal(np.asarray(ko), want)
    np.testing.assert_array_equal(np.asarray(off), want_off)


def test_partition_with_payload_stability():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    payload = np.arange(N, dtype=np.uint32)  # original index -> proves stability
    ko, po, _ = rs.partition(jnp.asarray(keys), jnp.asarray(payload), bits=4)
    want_k, want_p, _ = _oracle(keys, 4, payload)
    np.testing.assert_array_equal(np.asarray(ko), want_k)
    np.testing.assert_array_equal(np.asarray(po), want_p)


@pytest.mark.parametrize("case", ["constant", "two_vals", "skew90",
                                  "empty_buckets"])
def test_partition_skew(case):
    rng = np.random.default_rng(len(case))
    if case == "constant":
        keys = np.full(N, 0xABCD1234, dtype=np.uint32)
    elif case == "two_vals":
        keys = np.where(rng.random(N) < 0.5, 0x5, 0xF0000005).astype(np.uint32)
    elif case == "skew90":
        keys = rng.integers(0, 2**32, size=N, dtype=np.uint32)
        keys[: int(0.9 * N)] = 7
        rng.shuffle(keys)
    else:
        keys = (rng.integers(0, 2, size=N, dtype=np.uint32) << 31) | 3
    payload = np.arange(N, dtype=np.int32)
    ko, po, off = rs.partition(jnp.asarray(keys), jnp.asarray(payload), bits=4)
    want_k, want_p, want_off = _oracle(keys, 4, payload)
    np.testing.assert_array_equal(np.asarray(ko), want_k)
    np.testing.assert_array_equal(np.asarray(po), want_p)
    np.testing.assert_array_equal(np.asarray(off), want_off)


def test_digit_histogram_every_nibble():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2**32, size=2 * N, dtype=np.uint32)
    for s in range(8):
        got = rs.digit_histogram(jnp.asarray(keys), begin_bit=4 * s, bits=4)
        want = np.bincount((keys >> (4 * s)) & 15, minlength=16)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=f"{s}")
