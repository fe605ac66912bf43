"""Test configuration: force a virtual 8-device CPU mesh + float64.

The tests run on the CPU. Multi-device sharding is validated without a GPU by
forcing XLA's host platform to expose 8 virtual devices (the standard JAX recipe for testing
`Mesh`/`shard_map` programs in CI). float64 is enabled so numerical tests can
assert LAPACK-grade tolerances; the library itself never requires x64.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
	os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Pin the platform in jax.config too, so an accelerator plugin installed
# beside JAX is never initialized by the tests.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
	"""Drop compiled executables between test modules.

	A single pytest process compiles ~400+ XLA programs across the suite;
	past that the XLA:CPU backend segfaults inside `backend_compile_and_load`
	(its JIT code region fills — host RAM is not the limit; reproduced at the
	same global test index regardless of which test sits there). Clearing the
	jit caches at module teardown keeps the resident-executable count bounded
	at the cost of recompiling fixtures shared across modules.
	"""
	yield
	jax.clear_caches()
