"""chip_smoke.py on the CPU: every phase at a tiny size, its checkers,
its refusal to run without a GPU, and the measurement helpers it shares
with bench.py (compile-cache directory, peak table, record header)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from cuda.radixsort_tpu.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phase", [
    lambda: cs.phase_sort_u32(1 << 12, 1 << 14, 0),
    lambda: cs.phase_sort_pairs(1 << 13, 1),
    lambda: cs.phase_join(1 << 14, 1000, 2),
    lambda: cs.phase_groupby(1 << 14, 1 << 10, 3),
    lambda: cs.phase_query(1 << 14, 1 << 11, 4),
], ids=["sort_u32", "sort_pairs", "join", "groupby", "query"])
def test_phase_tiny(phase):
    rec = phase()
    assert rec["ok"] is True


def test_join_phase_counts_even_probes():
    rec = cs.phase_join(1 << 13, 512, 7)
    assert rec["n_probe"] == 1 << 13 and rec["reduced_from"] == []
    assert 0 < rec["matches"] < 1 << 13


def test_multichip_tiny_on_four_virtual_devices():
    recs = list(cs.multichip(1 << 11, 1 << 13, 1 << 9, 0, ndev=4))
    assert [r["phase"] for r in recs] == [
        "multichip_sort", "multichip_join", "multichip_groupby",
        "multichip_query"]
    assert all(r["ok"] for r in recs)


def test_fingerprint_sees_a_changed_key():
    x = jax.random.bits(jax.random.PRNGKey(0), (4096,), jnp.uint32)
    a = cs.fingerprint_u32(x)
    b = cs.fingerprint_u32(jnp.sort(x))
    c = cs.fingerprint_u32(x.at[5].add(jnp.uint32(1 << 24)))
    assert all(bool(jnp.array_equal(p, q)) for p, q in zip(a, b))
    assert not all(bool(jnp.array_equal(p, q)) for p, q in zip(a, c))


def test_query_check_rejects_a_wrong_sum():
    fact, dim = cs._query_tables(1 << 13, 1 << 10, 1)
    cols, count, _ = cs.query_plan(fact, dim).run()
    cs.check_query(fact, 1 << 10, cols, count)
    bad = cols.with_column("p", cols["p"].at[3].add(1))
    with pytest.raises(AssertionError):
        cs.check_query(fact, 1 << 10, bad, count)


def test_zipf_keys_are_skewed_and_in_range():
    k = np.asarray(cs.zipf_keys(jax.random.PRNGKey(3), 1 << 16, 1 << 12))
    assert k.min() >= 0 and k.max() < 1 << 12
    counts = np.bincount(k, minlength=1 << 12)
    assert counts[0] > 20 * np.median(counts[counts > 0])


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_fails_without_gpu():
    r = _run(["bench.py"], ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stdout


@pytest.fixture
def _restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_dir_from_environment(monkeypatch, _restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_in_checkout(monkeypatch, _restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_peak_table_knows_the_h200():
    p = profiling.peak("NVIDIA H200")
    assert p["hbm_bytes_per_s"] == 4.8e12 and p["hbm_bytes"] == 141e9


def test_peak_table_raises_on_unknown_device():
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.peak("Unknown Accelerator")
    with pytest.raises(ValueError):
        profiling.speed_of_light(1e9, 1.0, kind="cpu")


def test_device_record_names_the_device():
    rec = profiling.device_record()
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert {"device_kind", "nvidia_smi", "xla_flags", "jax_version"} <= set(rec)
