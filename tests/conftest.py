"""Test config: CPU backend, 8 virtual devices for mesh tests, float64 parity.

Some installed pytest plugins (jaxtyping) import jax before this conftest
runs, so env vars alone are too late for JAX_PLATFORMS/JAX_ENABLE_X64.  The
backend itself is still uninitialized at conftest time, so configure through
jax.config, which takes effect at first backend use.

``GST_TEST_GPU=1`` leaves the backend alone instead, for the tests marked
``gpu`` (compiled kernels, which have no CPU lowering):

    GST_TEST_GPU=1 python -m pytest tests/ -m gpu
"""
import os

import pytest

if os.environ.get("GST_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_ENABLE_X64"] = "true"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    assert jax.devices()[0].platform == "cpu", (
        "tests must run on CPU; backend was initialized before conftest")
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time, so
    every test worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Pallas kernels have no CPU "
                    "lowering (run with GST_TEST_GPU=1 on the card)")
    return jax.devices()[0]
