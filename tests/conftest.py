"""Test configuration: force CPU with 8 virtual devices so multi-chip
sharding (gaml_tpu.parallel) is exercised without accelerator hardware.

Tests marked ``chip`` need a CUDA GPU; the ``chip_device`` fixture skips
them elsewhere (decided when the test runs, never at import).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller names a platform (the chip-marked tests run on
# the card with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# tests exercise the device bulk path deterministically: bypass the
# cold-executable cost-model routing (readset._device_ready)
os.environ.setdefault("GAML_DEV_EAGER", "1")

import pytest  # noqa: E402


@pytest.fixture
def chip_device():
    """The CUDA GPU for tests marked ``chip``; skips where JAX has none.
    On the card: ``JAX_PLATFORMS=cuda python -m pytest -m chip tests``."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX platform is {dev.platform!r})")
    return dev
