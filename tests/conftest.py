"""Test configuration: the suite runs on XLA:CPU with 8 virtual devices, so
sharding tests run deterministically without a GPU. The platform is forced
with `jax.config.update` after import as well as through JAX_PLATFORMS, so a
GPU-enabled JAX install also stays on the CPU here.
"""
import os

# tests run on forced-CPU: disable the package's persistent compile cache
# (XLA:CPU AOT entries embed machine-feature lists that vary across flag
# configurations and reload with SIGILL-risk warnings)
os.environ.setdefault("LLDSLAM_NO_COMPILE_CACHE", "1")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
