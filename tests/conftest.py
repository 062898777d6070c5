"""Test configuration: CPU backend with a virtual 8-device mesh + float64.

Tests run on the CPU so they are hermetic and so multi-card sharding can be
validated without real cards (SURVEY.md §8): Pallas kernels run in interpret
mode (ops/pallas_utils.py), shardings run over 8 virtual CPU devices, and
float64 is enabled so the C-reference oracle (double precision,
lib/matrix.h:4) can be matched tightly. Tests that need the card carry the
``gpu`` marker and skip here; ``chip_smoke.py`` runs them on the card.
"""

import os

# BLA_TESTS_ON_GPU=1 (set by chip_smoke.py, which runs the ``gpu``-marked
# tests in its own process on the card) leaves the backend alone.
ON_GPU = os.environ.get("BLA_TESTS_ON_GPU") == "1"

if not ON_GPU:
    # Must be set before jax is imported anywhere.
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    # Pin the CPU even where the environment names another platform: the
    # config update wins over JAX_PLATFORMS.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from big_linear_algebra.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

if not ON_GPU:
    # Persistent compile cache: the U-Net train/sample graphs take minutes
    # to compile on CPU; cache them across test runs.
    enable_compile_cache(min_compile_secs=5.0)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default backend is a GPU.
    Decided here, at run time, never while a module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs on the card through chip_smoke.py")
