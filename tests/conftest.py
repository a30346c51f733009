import os

# CPU with a virtual 8-device mesh, set BEFORE jax initializes: multi-device
# sharding is exercised on host devices; runs on the card are the separate
# GPU-marked tests and chip_smoke.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided inside the fixture,
    never at import or collection time, so every test worker collects the same
    tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled census kernel has no CPU lowering")
    return jax.devices()[0]
