"""Test configuration: force CPU with an 8-device virtual mesh and x64.

Multi-device sharding paths are exercised on virtual CPU devices; the real
multi-GPU path runs in ``chip_smoke.py --chips 4``.
These env vars must be set before jax is imported by any test module.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
