"""Test harness config: run JAX on a virtual 8-device CPU mesh with x64.

Multi-device sharding is exercised on `xla_force_host_platform_device_count=8`
virtual CPU devices; numerics-validation tests use float64 on the CPU. The
framework itself is dtype-polymorphic and runs f32 on the GPU. Tests that
need the card carry the `gpu` marker and take the `gpu_device` fixture below,
which skips them where there is no card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# The suite validates numerics in f64 and sharding on virtual devices: pin
# the CPU platform even where an accelerator is present, unless the caller
# named the GPU (`JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/` on the card).
if not any(p in os.environ.get("JAX_PLATFORMS", "") for p in ("cuda", "gpu")):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# The settings every entry point runs under: full-f32 matmul precision (the
# precision tests check the lowered programs for it) and the persistent
# compilation cache (XLA CPU compiles of the bigger jits dominate the suite).
from gorio_tpu.utils.jax_config import configure_jax

configure_jax()

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live XLA executables after each test module. A long single-process
    run accumulating hundreds of CPU executables has produced hard aborts
    (SIGABRT inside XLA compile) on small boxes; the persistent cache above
    makes re-jitting cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none. Decided here,
    at run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/")
    return gpus[0]
