"""Sorted-set algebra (ops/setops.py): thrust multiset semantics oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda.radixsort_tpu.ops.setops import (
    set_difference,
    set_intersection,
    set_symmetric_difference,
    set_union,
)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(55)


def _multiset_oracle(a, b):
    """Per-value counts -> (intersection, union, diff, symdiff) multisets,
    ascending, matching thrust's count semantics."""
    from collections import Counter

    ca, cb = Counter(a.tolist()), Counter(b.tolist())
    vals = sorted(set(ca) | set(cb))
    inter, uni, diff, sym = [], [], [], []
    for v in vals:
        m, n = ca.get(v, 0), cb.get(v, 0)
        inter += [v] * min(m, n)
        uni += [v] * max(m, n)
        diff += [v] * max(m - n, 0)
        sym += [v] * abs(m - n)
    return (np.array(inter, a.dtype), np.array(uni, a.dtype),
            np.array(diff, a.dtype), np.array(sym, a.dtype))


@pytest.mark.parametrize("hi", [10, 2**32 - 1])
def test_setops_multiset_semantics(rng, hi):
    a = np.sort(rng.integers(0, hi, size=801, dtype=np.uint32))
    b = np.sort(rng.integers(0, hi, size=1203, dtype=np.uint32))
    inter, uni, diff, sym = _multiset_oracle(a, b)
    for fn, oracle in ((set_intersection, inter), (set_union, uni),
                       (set_difference, diff),
                       (set_symmetric_difference, sym)):
        out, cnt = fn(jnp.asarray(a), jnp.asarray(b))
        cnt = int(cnt)
        assert cnt == oracle.shape[0], fn.__name__
        np.testing.assert_array_equal(np.asarray(out)[:cnt], oracle,
                                      err_msg=fn.__name__)


def test_setops_max_key_no_sentinel_conflation(rng):
    # real keys at u32 max must survive (no sentinel keys)
    a = np.array([5, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    b = np.array([0xFFFFFFFF], np.uint32)
    out, cnt = set_union(jnp.asarray(a), jnp.asarray(b))
    assert int(cnt) == 3
    np.testing.assert_array_equal(np.asarray(out)[:3],
                                  [5, 0xFFFFFFFF, 0xFFFFFFFF])
    out, cnt = set_difference(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)],
                                  [5, 0xFFFFFFFF])
    out, cnt = set_symmetric_difference(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)],
                                  [5, 0xFFFFFFFF])


def test_setops_signed_and_float(rng):
    a = np.sort(rng.integers(-100, 100, size=300).astype(np.int32))
    b = np.sort(rng.integers(-100, 100, size=200).astype(np.int32))
    inter, _, _, _ = _multiset_oracle(a, b)
    out, cnt = set_intersection(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], inter)
    fa = np.sort(rng.normal(size=150).astype(np.float32))
    fb = np.sort(np.concatenate([fa[:40], rng.normal(size=60).astype(
        np.float32)]))
    out, cnt = set_intersection(jnp.asarray(fa), jnp.asarray(fb))
    inter_f = np.intersect1d(fa, fb)  # fa values are distinct w.p. 1
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], inter_f)


def test_setops_empty_sides(rng):
    a = np.sort(rng.integers(0, 50, size=64, dtype=np.uint32))
    e = np.empty(0, np.uint32)
    out, cnt = set_union(jnp.asarray(a), jnp.asarray(e))
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], a)
    out, cnt = set_intersection(jnp.asarray(e), jnp.asarray(a))
    assert int(cnt) == 0
    out, cnt = set_difference(jnp.asarray(a), jnp.asarray(e))
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], a)


def test_thrust_setops_surface(rng):
    from cuda.radixsort_tpu import thrust_compat as thrust

    a = np.sort(rng.integers(0, 30, size=100, dtype=np.uint32))
    b = np.sort(rng.integers(0, 30, size=100, dtype=np.uint32))
    inter, uni, diff, sym = _multiset_oracle(a, b)
    for fn, oracle in ((thrust.set_intersection, inter),
                       (thrust.set_union, uni),
                       (thrust.set_difference, diff),
                       (thrust.set_symmetric_difference, sym)):
        out, cnt = fn(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], oracle)
