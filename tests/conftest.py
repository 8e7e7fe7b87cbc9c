"""Test configuration: run everything on a virtual 8-device CPU mesh in f64.

Multi-chip sharding paths are exercised on the host via
``--xla_force_host_platform_device_count`` exactly as the driver's
``dryrun_multichip`` does; numerical tests use float64 to validate the
reference's 1e-12 convergence targets (device benchmarks run f32 paths).
"""

import os

# Force CPU: the tests never take an accelerator, even where one is
# attached.  If jax was imported already, the env var alone is too late —
# set the platform through jax.config (effective until backends
# initialize).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running end-to-end test")
