"""Test harness config.

The suite runs on the CPU with 8 virtual devices (the distributed tests
exercise shard_map/all-to-all logic without a multi-card host). Tests
marked ``gpu`` need a card: they skip on the CPU and run, in one process
with one worker, when RS_TEST_GPU=1 is set on a machine with a GPU —
``chip_smoke.py`` runs them that way as its last phase:

    RS_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist
"""

import os
import sys

# Must be set before the first backend use: the CPU unless the GPU run is
# asked for explicitly.
if os.environ.get("RS_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)  # 64-bit keys are first-class here.

import pytest  # noqa: E402


# Fast representative lane: `pytest -m smoke` (a few minutes on the CPU).
_SMOKE_MODULES = {
    "test_twiddle",        # key-ordering bijections, the correctness root
    "test_sort_oracle",    # end-to-end sort vs numpy oracles
    "test_operators",      # one test per operator family
    "test_thrust_layer",   # L5 API surface
    "test_dsort",          # distributed sort on the CPU-8 mesh
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "smoke: fast representative lane (`pytest -m smoke`, <5 min on CPU)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (run with RS_TEST_GPU=1 -m gpu)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.fspath.purebasename in _SMOKE_MODULES:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(autouse=True)
def _gpu_marked_needs_gpu(request):
    """Tests marked ``gpu`` skip unless JAX's default backend is a GPU —
    decided here, at run time, so every xdist worker collects the same
    tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU (RS_TEST_GPU=1 on a machine with one)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """The full suite in one process segfaulted (~60% in) with hundreds of
    cached executables across 8 virtual devices; per-module cache clearing
    bounds the growth (the halves always passed in isolation)."""
    yield
    jax.clear_caches()
