"""Test configuration: force an 8-device CPU JAX platform.

Tests validate numerics on the CPU; the GPU path is exercised by
chip_smoke.py (bit-exact against the CPU, plus decryption).  The
multi-device CPU mesh validates the sharded code paths.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
