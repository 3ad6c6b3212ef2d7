"""Atomic writes for jax's persistent compilation cache.

jax's LRUCache.put writes entries with a bare ``Path.write_bytes``
(jax/_src/lru_cache.py) — NOT atomic. A process killed mid-write (driver
timeout, Ctrl-C, crash) leaves a truncated zstd entry, and every later
process that reads that key SEGFAULTS inside executable deserialization
(observed: fatal crash in
``compilation_cache.get_executable_and_time``). This module monkeypatches
``put`` to write to a same-directory temp file and ``os.replace`` it into
place, which makes interrupted writers harmless.

Entry points call ``configure_compilation_cache()`` before their first
jit compilation: it picks the cache directory and turns on the atomic
writes.
"""

from __future__ import annotations

import os
import tempfile

_patched = False

# fixed cache root inside the checkout (listed in .gitignore): the path is
# part of how the cache is found again, so it never comes from a temp
# name, a pid or the clock
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_ROOT = os.path.join(_CHECKOUT, ".jax_cache")


def compilation_cache_dir(name: str = "device") -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else ``.jax_cache/<name>``
    in the checkout (the tests use their own ``name``)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CACHE_ROOT, name
    )


def configure_compilation_cache(name: str = "device") -> str:
    """Point jax's persistent compilation cache at
    ``compilation_cache_dir(name)``, cache every program that takes over a
    second to compile, and make cache writes atomic. Returns the directory."""
    import jax

    path = compilation_cache_dir(name)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    enable_atomic_cache_writes()
    return path


def enable_atomic_cache_writes() -> None:
    global _patched
    if _patched:
        return
    try:
        from jax._src import lru_cache
    except ImportError:  # cache layout changed; fail open
        return

    orig_put = lru_cache.LRUCache.put

    def atomic_put(self, key, val):
        if not key:
            raise ValueError("key cannot be empty")
        cache_path = self.path / f"{key}{lru_cache._CACHE_SUFFIX}"
        if cache_path.exists():
            return
        fd, tmp = tempfile.mkstemp(
            dir=str(self.path), prefix=".tmp-", suffix=".part"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(val)
            os.replace(tmp, cache_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self.eviction_enabled:
            # keep the original bookkeeping (atime sidecar + eviction)
            try:
                self._evict_if_needed(additional_size=0)
                import time as _time

                atime_path = self.path / f"{key}{lru_cache._ATIME_SUFFIX}"
                atime_path.write_bytes(_time.time_ns().to_bytes(8, "little"))
            except OSError:
                pass

    # only replace when the upstream signature still matches
    if orig_put.__name__ == "put":
        lru_cache.LRUCache.put = atomic_put
        _patched = True
