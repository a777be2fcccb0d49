"""Test configuration: JAX on a virtual 8-device CPU mesh.

The tests run on the CPU. Shardings are checked on host-platform virtual
devices, and the plain-JAX twins stand in for the CUDA kernel. Tests
marked ``gpu`` need the card: their fixture skips them here, and
chip_smoke.py runs the same comparisons on a GPU.

The platform is pinned through the config as well as JAX_PLATFORMS, so
an installed accelerator plugin cannot claim the tests.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from wfmash_tpu.utils import jaxcache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jaxcache.enable()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (runs on the card via "
                    "chip_smoke.py)")
    return devs[0]
