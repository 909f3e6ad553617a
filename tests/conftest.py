"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding/collective logic is exercised on XLA's host platform with 8
virtual devices. JAX_PLATFORMS=cpu is set only when the caller has not set
it, so `JAX_PLATFORMS=cuda pytest -m gpu` runs the GPU-marked tests on a
card (tests/test_gpu.py); those decide inside a fixture whether a card is
present.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "true"

import numpy as np
import pytest

from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache

# the suite is compile-dominated on CPU; repeat runs on this host hit the
# cache (its own subdirectory per host CPU, utils/compile_cache.py)
enable_compile_cache()


@pytest.fixture(autouse=True, scope="module")
def _bound_process_memory_maps():
    """Drop jit executables after every test module.

    The full suite compiles 1000+ CPU executables in one process; their
    code pages accumulate memory MAPPINGS until the process hits
    vm.max_map_count (default 65530 — measured 62k+ maps at the ~90%
    mark), at which point the next XLA compile/serialize mmap fails and
    SEGFAULTS (4/4 reproductions at the same late module; either half of
    the suite alone passes). Modules rarely share jit signatures, so
    clearing between modules costs little and keeps the map count
    bounded."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
