"""Test configuration: force an 8-device virtual CPU mesh.

Sharding/parallelism tests run against 8 virtual CPU devices, the JAX
analogue of a fake multi-chip cluster. Note the environment may pre-register
an accelerator plugin and set JAX_PLATFORMS itself, so we must both set
XLA_FLAGS before JAX initializes AND override jax_platforms via jax.config.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run slow-marked tests (full suite)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long e2e/train/kernel-grad tests (>=~15s each); excluded from "
        "the default run, enabled with --runslow",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's hand-written kernels); skips "
        "without one",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
