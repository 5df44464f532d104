"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so the full multi-device
sharding path (jax.sharding.Mesh + shard_map over the pair axis) executes
without a GPU. Must be set before jax is imported anywhere. The program
itself runs on the GPU: `python chip_smoke.py` on the card (README); the
compiled-kernel tests run there with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Persistent compilation cache: the suite compiles the same large pipeline
# programs every run; caching them on disk cuts repeat-run wall-clock a lot.
jax.config.update("jax_compilation_cache_dir", "/tmp/jaxcache-tests")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
