"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh so the multi-device
sharding paths (parallel/) are exercised without several cards, the same
way `__graft_entry__.dryrun_multichip` dry-runs them. The environment is
set BEFORE jax is imported. GPU kernels run here in interpret mode.

Tests that need the card carry the `gpu` marker and take the
`gpu_device` fixture, which skips them on a host without a GPU. They run
on the card through `python chip_smoke.py`.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from raytracingproject_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on a host without one")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip. Decided when the test runs, never at
    import, so every test worker collects the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU on this host; chip_smoke.py runs this on one")
    return gpus[0]
