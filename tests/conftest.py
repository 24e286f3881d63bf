"""Test harness config: run everything on a virtual 8-device CPU mesh so
sharding tests exercise real collectives without accelerator hardware."""

import os

# Force CPU even on a machine with a GPU: tests must be runnable anywhere,
# and the sharding tests need 8 devices. jax may already be imported, so set
# the config directly too — the env var alone is only read at jax import
# time. Tests marked ``gpu`` need the card: run them there with
#   P3D_TEST_ON_GPU=1 python -m pytest tests/ -m gpu
# (without the variable they skip through the ``gpu`` fixture).
ON_GPU = os.environ.get("P3D_TEST_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The GPU device, or a skip: decided when the test runs, never at
    import (every xdist worker must collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX device platform: {dev.platform}); "
                    "run on the card with P3D_TEST_ON_GPU=1 -m gpu")
    return dev


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """XLA:CPU segfaults once enough distinct programs accumulate in one
    process (backend_compile_and_load crashes mid-suite; order-dependent,
    any module passes solo), so the compile caches are cleared at EVERY
    module boundary. Costs some duplicate compiles; keeps the one-process
    full suite green."""
    jax.clear_caches()
    yield
