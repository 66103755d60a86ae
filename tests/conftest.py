"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding tests use
`--xla_force_host_platform_device_count` as the fake cluster (SURVEY.md §4).
Tests that need the GPU carry the `gpu` marker and skip on the CPU; on the
card run them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from multi_orb_slam.utils import compile_cache  # noqa: E402

# Persist compiles across test runs (XLA compiles dominate the suite).
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.05)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the test process's compiler memory.

    A full run compiles hundreds of distinct XLA programs in one process;
    past ~70% of the suite the XLA CPU compiler has been observed to
    SEGFAULT under the accumulated allocator pressure.  Dropping the
    in-memory executable caches between modules keeps the process flat
    (cross-module recompiles mostly hit the persistent disk cache).
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu -m gpu)")
    return jax.devices()[0]
