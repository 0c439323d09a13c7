import os

# 8 virtual CPU devices for the shard_map / pjit distribution tests.
# (The 512-device override is dryrun.py-only, per the launch design.)
# XLA_FLAGS must be set before jax initializes its backends; the pinned JAX
# does not recognize the jax_num_cpu_devices config option.
_FLAG = "--xla_force_host_platform_device_count=8"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _FLAG).strip()

try:
    import jax
except ImportError:
    # CI fast job installs numpy+pytest only; the core schedule/IR tests
    # never touch jax, and the tests that do import it fail at import time
    # with a clear error if collected without it.
    jax = None

if jax is not None:
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except AttributeError:
        pass  # older JAX: XLA_FLAGS above already forces 8 host devices

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: paper-scale (p=1152) cells excluded from tier-1"
    )
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of the PyTorch port; skips "
        "without a GPU (on one: PYTHONPATH=src python -m pytest tests/test_torch_kernels.py -m cuda)"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
