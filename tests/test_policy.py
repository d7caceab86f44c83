"""SortConfig policy: the engines it accepts, and the reference engine's
knobs (digit width, tile size) each agreeing with the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu import config as config_lib


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("engine", ["pallas", "bitonic", "cub", ""])
def test_unknown_engine_rejected(engine):
    with pytest.raises(ValueError, match="engine"):
        config_lib.SortConfig(engine=engine)


def test_auto_resolves_to_xla():
    assert config_lib.resolve(None).engine == "xla"
    assert config_lib.resolve(rs.SortConfig(engine="reference")).engine == \
        "reference"
    assert config_lib.resolve(None, radix_bits=4).radix_bits == 4


@pytest.mark.parametrize("radix_bits,tile_rows", [
    (2, 8), (4, 8), (5, 16), (8, 64),
])
def test_reference_knob_variants(radix_bits, tile_rows):
    cfg = rs.SortConfig(engine="reference", radix_bits=radix_bits,
                        tile_rows=tile_rows)
    assert cfg.num_bins == 1 << radix_bits
    assert cfg.tile_elems == tile_rows * 128
    keys = _keys(3 * cfg.tile_elems + 17, seed=radix_bits * 10 + tile_rows)
    out = np.asarray(rs.sort(jnp.asarray(keys), config=cfg))
    np.testing.assert_array_equal(out, np.sort(keys))


@pytest.mark.parametrize("radix_bits", [2, 4])
def test_partition_width_variants(radix_bits):
    # a partition-class op through the reference engine's digit widths
    from cuda.radixsort_tpu.ops.filter import filter_columns

    rng = np.random.default_rng(7)
    n = 128 * 64
    vals = rng.integers(0, 100, size=n).astype(np.int32)
    mask = vals >= 50
    cfg = rs.SortConfig(engine="reference", radix_bits=radix_bits,
                        tile_rows=16)
    (out,), cnt = filter_columns(jnp.asarray(mask), (jnp.asarray(vals),),
                                 config=cfg)
    assert int(cnt) == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(out)[: int(cnt)], vals[mask])
