"""Test harness config: CPU backend with 8 virtual devices.

Sharding paths are validated on fake CPU devices
(xla_force_host_platform_device_count), the standard "multi-device
without the devices" mechanism (SURVEY.md §4.3).  ``JAX_PLATFORMS``
defaults to ``cpu``; tests marked ``gpu`` need a card and run with
``python -m pytest -m gpu tests/`` on a machine that has one (see
README), where they decide inside the ``gpu_device`` fixture.
Must run before the first jax import.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# x64 on: lets the f64 paths be tested tightly; f32 paths cast explicitly.
jax.config.update("jax_enable_x64", True)


@pytest.fixture()
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform})")
    return dev
