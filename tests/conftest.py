"""Test configuration: run on a virtual 8-device CPU mesh with x64 available.

Sharding tests need multiple devices without accelerator hardware; parity
tests vs the float64 NumPy oracle need x64. Tests marked `gpu` compile a
kernel for the card; they skip here and run on the H100 through
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` (see README).
"""

import os

# JAX_PLATFORMS=cuda selects the card for the `gpu` tests; anything else
# runs the suite on the virtual CPU mesh.
ON_CARD = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)
if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8, jax.devices()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (long OSSE/realcase integration runs)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long integration test, skipped unless --runslow or RUN_SLOW=1")
    config.addinivalue_line(
        "markers",
        "gpu: compiles a kernel for the GPU; skips where JAX finds none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow (use --runslow or RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
