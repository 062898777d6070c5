"""Device handling: the Pallas interpret rule, the compile-cache location,
and the benchmark's peak table."""

import os

import jax
import pytest

import bench
from big_linear_algebra.ops.pallas_utils import interpret_mode
from big_linear_algebra.utils import compile_cache


def test_interpret_only_on_cpu():
    """Interpret on the CPU, compile on the GPU, refuse anything else: no
    accelerator ever falls back to the interpreter."""
    assert interpret_mode("cpu") is True
    assert interpret_mode("gpu") is False
    for other in ("rocm", "metal", "neuron"):
        with pytest.raises(RuntimeError, match="no Pallas route"):
            interpret_mode(other)
    assert interpret_mode() is True  # the tests' own backend is the CPU


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")
    assert compile_cache.enable_compile_cache(2.0) == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              restore_cache_config):
    """Unset (or empty) variable: ``<checkout>/.jax_cache``, which
    .gitignore lists."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value in (None, ""):
        if value is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
        want = os.path.join(root, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peak_table_h100_and_unknown_device():
    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["tf32_flops"] == 495e12
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["source"]
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "Some Accelerator v1"):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.peaks(kind)


def test_bench_requires_gpu():
    """The benchmark never times the CPU under a device metric's name."""
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.require_gpu()
