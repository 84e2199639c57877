"""Test configuration: run JAX on CPU with 8 virtual devices.

Tests force the CPU backend and expose 8 virtual host devices so the
multi-device sharding paths are exercised without several accelerators —
the JAX equivalent of a distributed test rig (SURVEY §4).  Tests that
need a GPU carry the ``gpu`` marker and skip here; ``chip_smoke.py``
runs the same checks on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

# CPU unless the caller names platforms (JAX_PLATFORMS=cuda,cpu on a GPU
# host runs the ``gpu``-marked tests on the card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import pytest  # noqa: E402  (imported after backend selection on purpose)


@pytest.fixture(scope="session")
def cpu_devices():
    devices = jax.devices("cpu")
    assert len(devices) == 8, f"expected 8 virtual CPU devices, got {devices}"
    return devices


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs these checks on the card")
    return jax.devices()[0]
