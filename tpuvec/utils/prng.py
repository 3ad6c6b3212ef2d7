"""Deterministic HNSW level sampling.

The reference samples insert levels from an exponential decay with a
time-seeded hash RNG (src/hnsw/insert.rs:114-137), which makes builds
irreproducible. We key a counter-based integer hash (splitmix32 finalizer)
on (rng_seed, node id) instead, so levels are a pure function of the id
and stable across rebuilds. The numpy and jnp paths share the integer hash
bit-for-bit; the float log/floor agrees except at ulp-boundary ids (a ±1
level difference there is harmless — any level assignment yields a valid
graph).

level = floor(-ln(u) * level_factor), capped at max_level,
with level_factor = 1/ln(M) (src/hnsw/mod.rs:44).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sample_levels_np", "sample_levels"]

_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35


def _mix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(_MIX1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_MIX2)
    h ^= h >> np.uint32(16)
    return h


def sample_levels_np(ids: np.ndarray, seed: int, level_factor: float, max_level: int) -> np.ndarray:
    """Levels for node ids (numpy host path)."""
    with np.errstate(over="ignore"):
        h = (np.asarray(ids, dtype=np.uint32) + np.uint32(1)) * np.uint32(_GOLDEN)
        h = _mix32_np(h ^ np.uint32(seed & 0xFFFFFFFF))
    # uniform in (0, 1]: use top 24 bits, never zero
    u = ((h >> np.uint32(8)).astype(np.float32) + np.float32(1.0)) / np.float32(1 << 24)
    lv = np.floor(-np.log(u) * np.float32(level_factor)).astype(np.int32)
    return np.minimum(lv, np.int32(max_level))


@partial(jax.jit, static_argnums=(1, 2, 3))
def sample_levels(ids: jnp.ndarray, seed: int, level_factor: float, max_level: int) -> jnp.ndarray:
    """Levels for node ids (jnp device path) — bit-identical to the numpy form.

    Jitted into ONE program: the eager form is ~10 tiny dispatches per
    insert batch."""
    h = (ids.astype(jnp.uint32) + jnp.uint32(1)) * jnp.uint32(_GOLDEN)
    h = h ^ jnp.uint32(seed & 0xFFFFFFFF)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(_MIX1)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(_MIX2)
    h = h ^ (h >> 16)
    u = ((h >> 8).astype(jnp.float32) + 1.0) / float(1 << 24)
    lv = jnp.floor(-jnp.log(u) * level_factor).astype(jnp.int32)
    return jnp.minimum(lv, jnp.int32(max_level))
