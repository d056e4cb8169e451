"""Test configuration: CPU backend, x64, 8 virtual devices for sharding tests.

Mirrors the reference's test conditions (CPU + float64,
``/root/reference/tests/test_solvers.py:17-18``) and adds the standard JAX
substitute for a multi-device fixture: ``xla_force_host_platform_device_count``
so ``shard_map`` collectives are exercised without a multi-device machine.
Pallas kernels run in interpret mode there.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere.  They run on
the card with ``PDE_OPT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``,
which leaves JAX on its default platform instead of forcing the CPU.
"""

import os

import pytest

ON_GPU = os.environ.get("PDE_OPT_TEST_PLATFORM") == "gpu"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU (decided at test
    time, never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU: run with "
                        "PDE_OPT_TEST_PLATFORM=gpu on a machine with one")
