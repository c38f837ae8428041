"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Must set env vars before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import jax
import pytest

# Set through jax.config too, in case jax was configured before this file ran.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

# Modules dominated by golden end-to-end renders or subprocess spawns
# (the release gate); `-m "not slow"` runs the fast unit suite.
SLOW_MODULES = {
    "test_adaptive",
    "test_amr",
    "test_formula_e2e",
    "test_multiprocess",
    "test_polarized_e2e",
    "test_reference_goldens",
    "test_render_truecolor",
    "test_simulation_e2e",
    "test_slowlight",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES
