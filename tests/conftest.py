"""Test configuration: the CPU backend with an 8-device virtual mesh.

The suite runs on the CPU: ``jax.config.update("jax_platforms", "cpu")``
below switches the platform before any backend initializes, whatever
JAX_PLATFORMS says, and multi-device sharding is exercised on a virtual
CPU mesh.  XLA_FLAGS is read lazily at CPU backend init, so setting it
here works.  Tests that need a GPU carry the ``gpu`` marker and skip
here; the card is exercised by ``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# The full suite compiles hundreds of XLA:CPU programs in one process;
# at the kernel default vm.max_map_count=65530 the accumulated mappings
# eventually make LLVM fail mid-compile (observed as both 'Cannot
# allocate memory' and hard segfaults at varying tests).  Raise it when
# permitted; best-effort — CI without the privilege just stays at the
# default and long runs may need `sysctl -w vm.max_map_count=1048576`.
try:
    with open("/proc/sys/vm/max_map_count", "r+") as fh:
        if int(fh.read()) < 1048576:
            fh.seek(0)
            fh.write("1048576")
except OSError:
    pass
