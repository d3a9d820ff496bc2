"""Test configuration: CPU backend with 8 virtual devices for sharding tests.

Tests marked ``gpu`` need the card and skip elsewhere (the ``gpu`` fixture
decides).  To run them on a machine with a GPU, leave the platform to JAX::

    PYLOO_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
"""

import os

if not os.environ.get("PYLOO_TESTS_ON_GPU"):
    # Must be set before jax initializes: every test session gets a virtual
    # 8-device CPU mesh so the sharding paths execute without several cards.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not os.environ.get("PYLOO_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The GPU device, or skip: tests marked ``gpu`` need the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (found {dev.platform}); run with"
            " PYLOO_TESTS_ON_GPU=1 on a machine with one"
        )
    return dev


@pytest.fixture(scope="module", autouse=True)
def _bounded_live_executables():
    """Clear XLA compilation caches at every test-module boundary.

    XLA:CPU segfaults compiling large programs once hundreds of executables
    from earlier modules are live in the process (deterministic at
    full-suite scale only; any subset passes).  A single hand-placed clear
    before the biggest program (test_samplers) stopped being enough as the
    suite grew — the round-3 batched-refit programs pushed the trip point
    back into test_refit — so the bound is now enforced at every module
    boundary.  Cost: shared substrate kernels recompile per module
    (seconds), against a ~25-minute suite.
    """
    jax.clear_caches()
    yield
