"""Root pytest config: pin the CPU with a virtual 8-device mesh before JAX starts.

Tests run on the CPU (``JAX_PLATFORMS=cpu`` unless the environment names
another platform) with 8 virtual devices so the multi-device sharding paths
are exercised without accelerators.  Tests that need a GPU carry the ``gpu``
marker and skip elsewhere (tests/test_gpu.py); ``chip_smoke.py`` runs them
on the card with ``JAX_PLATFORMS=cuda``.  float64 is enabled so the
oracle-parity tests can also run the pipeline in exact mode.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Every test compiles afresh: the gateway and the CLI point JAX at the
# persistent compilation cache, and a suite-wide on-disk cache would carry
# executables from one run (or one xdist worker) into the next.
jax.config.update("jax_enable_compilation_cache", False)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_cpu_accumulation():
    """Free compiled executables between test modules.

    Full-suite runs in one process once deterministically crashed inside
    XLA:CPU's backend_compile_and_load at a late big compile
    (tests/test_two_tier.py) while every <=75% subset passed and the same
    compile succeeded alone - a crash triggered only by a process's
    accumulated compiled-program state.  Dropping cached executables at
    module boundaries keeps the live-program set far below that threshold
    at the cost of cross-module recompiles.
    """
    yield
    import jax

    jax.clear_caches()
