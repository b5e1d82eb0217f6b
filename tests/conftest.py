"""Test configuration: CPU JAX with 8 virtual devices by default.

Multi-chip sharding is validated on a virtual CPU mesh (the standard JAX
fake-multi-device trick), replacing the reference's (absent) distributed
tests. ``JAX_PLATFORMS`` defaults to ``cpu``; the card-only tier (marker
``gpu``) runs on a GPU machine with ``JAX_PLATFORMS=cuda,cpu``.
"""

import os
from pathlib import Path

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Two-tier suite: engine and mesh tests dominate the full run, so every
# test is auto-marked `fast` or `heavy` by file; `pytest -m fast` finishes
# in minutes and CI runs both tiers.
_HEAVY_FILES = {
    "test_device_engine.py",
    "test_pallas_kernel.py",
    "test_parallel.py",
    "test_fuzz_parity.py",
    "test_multiprocess.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        heavy = (
            Path(str(item.fspath)).name in _HEAVY_FILES
            or item.get_closest_marker("slow") is not None
            or item.get_closest_marker("heavy") is not None
        )
        if heavy:
            if item.get_closest_marker("heavy") is None:
                item.add_marker(pytest.mark.heavy)
        else:
            item.add_marker(pytest.mark.fast)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (card-only tests; decided
    here, never at import or collection time)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device: {dev.platform})")
    return dev
