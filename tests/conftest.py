"""Test configuration: force an 8-device virtual CPU platform.

Tests run on the CPU (SURVEY.md §4: the CPU backend is the "fake backend"
for CI); multi-device sharding tests use 8 virtual CPU devices. The GPU
kernel runs here in the Pallas interpreter; what only a GPU can run is in
chip_smoke.py.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)
# No persistent compilation cache for tests: XLA:CPU executables embed
# the host's machine features, and a cache directory shared across hosts
# can hand one host another's code. Small CPU recompiles are cheap.
jax.config.update("jax_enable_compilation_cache", False)


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound in-process native state: dropping compiled executables at
    module teardown keeps the accumulated compiler state of a long
    single-process run small; modules share almost no compilations, so
    the recompile cost is minimal."""
    yield
    import jax

    jax.clear_caches()
