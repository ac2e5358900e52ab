"""Test harness configuration.

Tests run on the CPU with eight virtual devices, so the multi-device sharding
tests have a mesh to shard over. What needs a GPU is exercised by
chip_smoke.py, not here.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from xframe_tpu.library.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()
