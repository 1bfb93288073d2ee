"""Test configuration: JAX on a virtual 8-device CPU mesh, so the
multi-device sharding paths compile and run on any host.

A ``JAX_PLATFORMS`` that names another platform is left as it is, for the
tests marked ``gpu`` (``JAX_PLATFORMS=cuda python -m pytest tests/ -m
gpu`` on a GPU host); elsewhere those tests skip.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    # the suite wants a deterministic virtual 8-device mesh and fast
    # local compiles, whatever accelerator the host has
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import pathlib

import jax
import pytest

# persistent compile cache: the batch-pipeline tests trigger several
# moderately large XLA compiles; keep them across test runs
from vorbispizza_tpu.utils.cache import configure as _configure_cache

_configure_cache(jax)

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE_TESTFILES = pathlib.Path("/root/reference/TestFiles")


@pytest.fixture(scope="session")
def testfiles():
    if not REFERENCE_TESTFILES.exists():
        pytest.skip("reference test files not available")
    return sorted(REFERENCE_TESTFILES.glob("*.ogg"))


@pytest.fixture(scope="session")
def testfile1():
    p = REFERENCE_TESTFILES / "1test.ogg"
    if not p.exists():
        pytest.skip("1test.ogg not available")
    return p


@pytest.fixture(scope="session")
def gpu_device():
    """JAX's first device when it is a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (JAX found {dev.platform}); run with "
            "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu"
        )
    return dev
