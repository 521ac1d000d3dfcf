"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual host
devices for the multi-device mesh tests. Tests that need a CUDA GPU carry
the ``gpu`` marker and take the ``gpu_device`` fixture, which skips them
where JAX finds no GPU; on a machine with one, run them with
``python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from openvo_jax.utils.cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
# Oracle tests compare against float64 NumPy/OpenCV: keep matmuls exact f32.
jax.config.update("jax_default_matmul_precision", "highest")
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX finds none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a CUDA GPU (JAX found none)")
    return devices[0]
