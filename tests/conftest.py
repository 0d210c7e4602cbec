"""Test configuration.

Runs the suite on a virtual 8-device CPU mesh so sharding/distribution code
paths are exercised without an accelerator (≅ SURVEY.md §4's prescription;
the reference's tests were single-GPU only — multi-device tests are new
capability). The platform is pinned through jax.config, before the backend
initializes. The card is exercised by chip_smoke.py, not the unit suite.

Mirrors the reference's fixed-seed pattern (python/tests/conftest.py:13-20,
utils.py:25-27 seed_rand).
"""
import os

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # older jax: fall back to XLA_FLAGS (pre-backend-init)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

# Persistent compile cache: most of the suite's wall time is CPU jit
# compiles, and the cache hits across processes and xdist workers.
from libgdf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def rand_seed():
    np.random.seed(0xabcdef)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
