"""Test configuration: run on a virtual 8-device CPU platform by default.

Multi-device sharding is exercised without a cluster the same way the
reference tests the multi-FPGA ring without one (file-backed pipe mocks and
rank injection, ``tests/IOPipeDebugging.hpp``, SURVEY.md §4): by forcing
XLA's host platform to expose 8 devices. Must run before jax is imported.

Tests marked ``gpu`` need an NVIDIA GPU; they skip elsewhere. Run them on
the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (which
``chip_smoke.py`` does as its first phase).
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: many tests compile the same small programs,
# so repeat runs are cheap. The directory follows the rule every entry point
# uses (JAX_COMPILATION_CACHE_DIR if set, else <checkout>/.jax_cache).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from stencilstream_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax  # noqa: E402

jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU. Decided
    here, at run time, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py on the card)")
