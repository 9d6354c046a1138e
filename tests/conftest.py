"""Test configuration: the tests run on the host CPU with an 8-device
virtual mesh, so multi-device sharding paths are exercised without
accelerators. The GPU's own checks live in chip_smoke.py
(``python chip_smoke.py`` on a machine with the card)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")
SHADERS = REFERENCE / "shaders" / "shaders_glsl"


@pytest.fixture(scope="session")
def shader_root() -> pathlib.Path:
    if not SHADERS.is_dir():
        pytest.skip("reference shader tree not available")
    return SHADERS


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE.is_dir():
        pytest.skip("reference tree not available")
    return REFERENCE
