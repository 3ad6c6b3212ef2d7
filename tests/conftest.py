"""Test harness: force CPU with 8 virtual devices so sharding tests run
without an accelerator. Must run before jax is imported anywhere."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# set through the config too, in case jax was imported before this file
jax.config.update("jax_platforms", "cpu")

# the tests keep their own fixed cache directory in the checkout, apart
# from the device runs' (tpuvec/utils/safecache)
from tpuvec.utils.safecache import configure_compilation_cache  # noqa: E402

configure_compilation_cache("cpu-tests")

# A full suite run accumulates >65530 memory mappings (the default
# vm.max_map_count) from XLA:CPU JIT-compiled executables; once mmap
# starts failing the process SEGFAULTS inside LLVM / executable
# deserialization (diagnosed by watching /proc/<pid>/maps cross the
# limit exactly where three earlier runs crashed). Raise the knob when
# the environment allows it (we run as root in a container).
try:
    _MMC = "/proc/sys/vm/max_map_count"
    with open(_MMC) as _f:
        _cur = int(_f.read())
    if _cur < 262144:
        with open(_MMC, "w") as _f:
            _f.write("1048576")
except OSError:
    import warnings

    warnings.warn(
        "could not raise vm.max_map_count; a full-suite run may segfault "
        "in XLA:CPU once ~65K mappings accumulate (see CLAUDE.md)"
    )

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
