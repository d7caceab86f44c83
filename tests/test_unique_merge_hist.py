"""Oracle tests: unique/RLE, sorted merge, histograms, and the widened CUB
compat surface (DeviceSelect/DevicePartition/DeviceRunLengthEncode/
DeviceHistogram/DeviceMerge/DeviceScan/DeviceReduce)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda.radixsort_tpu import (
    digit_histogram,
    distinct,
    histogram_even,
    histogram_range,
    merge_sorted,
    merge_sorted_pairs,
    non_trivial_runs,
    run_length_encode,
    unique,
)
from cuda.radixsort_tpu import cub_compat as cc
from cuda.radixsort_tpu import twiddle


def _runs_oracle(x):
    """(starts, values, lengths) of consecutive equal runs."""
    x = np.asarray(x)
    if x.size == 0:
        return np.array([], np.int64), x, np.array([], np.int64)
    starts = np.flatnonzero(np.concatenate([[True], x[1:] != x[:-1]]))
    lengths = np.diff(np.concatenate([starts, [x.size]]))
    return starts, x[starts], lengths


# ---------------------------------------------------------------------- unique


def test_unique_consecutive_semantics():
    # NOT sorted: only adjacent duplicates collapse (CUB Unique semantics)
    x = np.array([3, 3, 1, 1, 1, 7, 3, 3, 0], np.uint32)
    uk, count = unique(jnp.asarray(x))
    _, vals, _ = _runs_oracle(x)
    assert int(count) == len(vals)
    np.testing.assert_array_equal(np.asarray(uk)[: int(count)], vals)


@pytest.mark.parametrize("n", [1, 255, 4096, 100_000])
def test_unique_sorted(n):
    rng = np.random.default_rng(n)
    x = np.sort(rng.integers(0, max(2, n // 3), size=n).astype(np.uint32))
    uk, count = unique(jnp.asarray(x))
    ref = np.unique(x)
    assert int(count) == len(ref)
    np.testing.assert_array_equal(np.asarray(uk)[: int(count)], ref)


def test_unique_empty():
    uk, count = unique(jnp.zeros((0,), jnp.uint32))
    assert uk.shape[0] == 0 and int(count) == 0


def test_run_length_encode():
    rng = np.random.default_rng(7)
    x = np.repeat(rng.integers(0, 50, size=200).astype(np.int32),
                  rng.integers(1, 9, size=200))
    uk, lengths, nruns = run_length_encode(jnp.asarray(x))
    _, vals, lens = _runs_oracle(x)
    assert int(nruns) == len(vals)
    np.testing.assert_array_equal(np.asarray(uk)[: int(nruns)], vals)
    np.testing.assert_array_equal(np.asarray(lengths)[: int(nruns)], lens)
    # tail is zero-length padding
    assert not np.any(np.asarray(lengths)[int(nruns):])


def test_run_length_encode_all_equal():
    x = np.full(1000, 42, np.uint32)
    uk, lengths, nruns = run_length_encode(jnp.asarray(x))
    assert int(nruns) == 1
    assert int(lengths[0]) == 1000 and int(uk[0]) == 42


def test_non_trivial_runs():
    x = np.array([5, 5, 5, 1, 2, 2, 9, 0, 0, 0, 0, 3], np.uint32)
    offs, lens, nruns = non_trivial_runs(jnp.asarray(x))
    assert int(nruns) == 3
    np.testing.assert_array_equal(np.asarray(offs)[:3], [0, 4, 7])
    np.testing.assert_array_equal(np.asarray(lens)[:3], [3, 2, 4])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_distinct(dtype):
    rng = np.random.default_rng(3)
    x = rng.integers(-40, 40, size=5000).astype(dtype)
    vals, count = distinct(jnp.asarray(x))
    ref = np.unique(x)
    assert int(count) == len(ref)
    np.testing.assert_array_equal(np.asarray(vals)[: int(count)], ref)


# ----------------------------------------------------------------------- merge


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("na,nb", [(1000, 1000), (1, 5000), (3000, 17)])
def test_merge_sorted(dtype, na, nb):
    rng = np.random.default_rng(na * 31 + nb)
    a = np.sort(rng.integers(-10_000, 10_000, size=na).astype(dtype))
    b = np.sort(rng.integers(-10_000, 10_000, size=nb).astype(dtype))
    out = merge_sorted(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.sort(np.concatenate([a, b])))


def test_merge_sorted_descending():
    rng = np.random.default_rng(11)
    a = np.sort(rng.integers(0, 999, size=400).astype(np.uint32))[::-1].copy()
    b = np.sort(rng.integers(0, 999, size=700).astype(np.uint32))[::-1].copy()
    out = merge_sorted(jnp.asarray(a), jnp.asarray(b), descending=True)
    ref = np.sort(np.concatenate([a, b]))[::-1]
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_merge_sorted_u64():
    rng = np.random.default_rng(13)
    a = np.sort(rng.integers(0, 2**63, size=800, dtype=np.uint64))
    b = np.sort(rng.integers(0, 2**63, size=300, dtype=np.uint64))
    out = merge_sorted(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.sort(np.concatenate([a, b])))


def test_merge_sorted_empty_sides():
    a = jnp.asarray(np.arange(10, dtype=np.uint32))
    e = jnp.zeros((0,), jnp.uint32)
    np.testing.assert_array_equal(np.asarray(merge_sorted(a, e)), np.arange(10))
    np.testing.assert_array_equal(np.asarray(merge_sorted(e, a)), np.arange(10))


def test_merge_pairs_stable_across_inputs():
    # heavy ties: every a-row must precede every equal b-row
    rng = np.random.default_rng(5)
    na, nb = 1200, 900
    a = np.sort(rng.integers(0, 40, size=na).astype(np.uint32))
    b = np.sort(rng.integers(0, 40, size=nb).astype(np.uint32))
    av = np.arange(na, dtype=np.int32)            # source tag: a = [0, na)
    bv = np.arange(na, na + nb, dtype=np.int32)   # b = [na, na+nb)
    ok, ov = merge_sorted_pairs(jnp.asarray(a), jnp.asarray(av),
                                jnp.asarray(b), jnp.asarray(bv))
    cat_k = np.concatenate([a, b])
    cat_v = np.concatenate([av, bv])
    perm = np.argsort(cat_k, kind="stable")
    np.testing.assert_array_equal(np.asarray(ok), cat_k[perm])
    np.testing.assert_array_equal(np.asarray(ov), cat_v[perm])


# ------------------------------------------------------------------ histograms


def test_histogram_even_oracle():
    rng = np.random.default_rng(23)
    x = rng.uniform(-50, 150, size=20_000).astype(np.float32)
    nbins = 64
    got = histogram_even(jnp.asarray(x), nbins, 0.0, 100.0)
    inr = x[(x >= 0.0) & (x < 100.0)]
    ref, _ = np.histogram(inr, bins=nbins, range=(0.0, 100.0))
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert int(np.sum(np.asarray(got))) == len(inr)  # out-of-range dropped


def test_histogram_even_int_samples():
    rng = np.random.default_rng(29)
    x = rng.integers(0, 256, size=10_000).astype(np.uint32)
    got = histogram_even(jnp.asarray(x), 256, 0, 256)
    ref = np.bincount(x, minlength=256)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_histogram_range_oracle():
    rng = np.random.default_rng(31)
    x = rng.uniform(0, 100, size=8_000).astype(np.float32)
    levels = np.array([0.0, 1.0, 5.0, 25.0, 50.0, 100.0], np.float32)
    got = histogram_range(jnp.asarray(x), jnp.asarray(levels))
    ref, _ = np.histogram(x[x < 100.0], bins=levels)
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("bits,begin", [(8, 0), (8, 24), (4, 12), (7, 0)])
def test_digit_histogram_u32(bits, begin):
    rng = np.random.default_rng(bits * 100 + begin)
    x = rng.integers(0, 2**32, size=1 << 17, dtype=np.uint64).astype(np.uint32)
    got = digit_histogram(jnp.asarray(x), begin_bit=begin, bits=bits)
    ref = np.bincount((x >> begin) & ((1 << bits) - 1), minlength=1 << bits)
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert int(np.sum(np.asarray(got))) == len(x)


@pytest.mark.parametrize("bits", range(1, 9))
def test_digit_histogram_widths(bits):
    rng = np.random.default_rng(40 + bits)
    n = (1 << 16) + 123
    x = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    begin = 32 - bits - (bits % 3)
    got = digit_histogram(jnp.asarray(x), begin_bit=begin, bits=bits)
    ref = np.bincount((x >> begin) & ((1 << bits) - 1), minlength=1 << bits)
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_digit_histogram_f32_twiddle_space():
    rng = np.random.default_rng(37)
    x = rng.normal(size=4096).astype(np.float32)
    got = digit_histogram(jnp.asarray(x), begin_bit=28, bits=4)
    tb = np.asarray(twiddle.twiddle_in(jnp.asarray(x)))
    ref = np.bincount((tb >> 28) & 15, minlength=16)
    np.testing.assert_array_equal(np.asarray(got), ref)


# ---------------------------------------------------------------- compat layer


def test_device_select_flagged_and_if():
    rng = np.random.default_rng(41)
    x = rng.integers(0, 1000, size=3000).astype(np.int32)
    flags = x % 3 == 0
    out, count = cc.DeviceSelect.Flagged(jnp.asarray(x), jnp.asarray(flags))
    np.testing.assert_array_equal(np.asarray(out)[: int(count)], x[flags])
    out2, count2 = cc.DeviceSelect.If(jnp.asarray(x), lambda v: v < 100)
    np.testing.assert_array_equal(np.asarray(out2)[: int(count2)], x[x < 100])


def test_device_select_unique_by_key():
    k = np.array([1, 1, 2, 2, 2, 3, 1, 1], np.uint32)
    v = np.array([10, 11, 20, 21, 22, 30, 40, 41], np.int32)
    ok, ov, count = cc.DeviceSelect.UniqueByKey(jnp.asarray(k), jnp.asarray(v))
    assert int(count) == 4
    np.testing.assert_array_equal(np.asarray(ok)[:4], [1, 2, 3, 1])
    np.testing.assert_array_equal(np.asarray(ov)[:4], [10, 20, 30, 40])


def test_device_partition_stable_both_sides():
    rng = np.random.default_rng(43)
    x = rng.integers(0, 100, size=2000).astype(np.uint32)
    sel = x < 50
    out, count = cc.DevicePartition.If(jnp.asarray(x), lambda v: v < 50)
    np.testing.assert_array_equal(np.asarray(out)[: int(count)], x[sel])
    np.testing.assert_array_equal(np.asarray(out)[int(count):], x[~sel])


def test_device_rle_and_histogram():
    x = np.array([4, 4, 4, 9, 9, 2], np.uint32)
    uk, lens, n = cc.DeviceRunLengthEncode.Encode(jnp.asarray(x))
    assert int(n) == 3
    np.testing.assert_array_equal(np.asarray(uk)[:3], [4, 9, 2])
    np.testing.assert_array_equal(np.asarray(lens)[:3], [3, 2, 1])
    h = cc.DeviceHistogram.HistogramEven(jnp.asarray(x.astype(np.float32)),
                                         11, 0.0, 10.0)
    assert h.shape[0] == 10 and int(h[4]) == 3 and int(h[9]) == 2


def test_device_merge():
    a = np.array([1, 3, 5], np.uint32)
    b = np.array([2, 3, 8, 9], np.uint32)
    out = cc.DeviceMerge.MergeKeys(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out), [1, 2, 3, 3, 5, 8, 9])


def test_device_scan():
    x = np.array([3, 1, 4, 1, 5], np.int32)
    ex = cc.DeviceScan.ExclusiveSum(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ex), [0, 3, 4, 8, 9])
    inc = cc.DeviceScan.InclusiveSum(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(inc), [3, 4, 8, 9, 14])
    exmin = cc.DeviceScan.ExclusiveScan(jnp.asarray(x), jnp.minimum, 100)
    np.testing.assert_array_equal(np.asarray(exmin), [100, 3, 1, 1, 1])
    incmax = cc.DeviceScan.InclusiveScan(jnp.asarray(x), jnp.maximum)
    np.testing.assert_array_equal(np.asarray(incmax), [3, 3, 4, 4, 5])


def test_device_reduce():
    x = np.array([7, -2, 9, 0], np.int32)
    assert int(cc.DeviceReduce.Sum(jnp.asarray(x))) == 14
    assert int(cc.DeviceReduce.Min(jnp.asarray(x))) == -2
    assert int(cc.DeviceReduce.Max(jnp.asarray(x))) == 9
    i, v = cc.DeviceReduce.ArgMin(jnp.asarray(x))
    assert (int(i), int(v)) == (1, -2)
    i, v = cc.DeviceReduce.ArgMax(jnp.asarray(x))
    assert (int(i), int(v)) == (2, 9)
    r = cc.DeviceReduce.Reduce(jnp.asarray(x), jnp.minimum, 127)
    assert int(r) == -2
