"""Test configuration: run on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual device mesh
(xla_force_host_platform_device_count). The compile cache stays off so test
processes write nothing into the checkout.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["FEM_TPU_NO_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
