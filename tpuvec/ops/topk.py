"""Top-k-smallest selection utilities.

Replaces the reference's binary heaps (src/hnsw/search.rs:192-250) with
fixed-width selection networks (no data-dependent heap ops under jit).

Wide selections run as a GROUP-WISE BITONIC CASCADE in place of
``lax.top_k``: split the width into pow-2 groups, bitonic-sort each group
and keep its smallest next_pow2(k) (the global top-k is always inside the
union of per-group top-k), then shrink recursively until one bitonic
finishes the job. Every stage is static reshapes + rolls + selects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuvec.ops.sort import bitonic_smallest

__all__ = ["topk_smallest", "merge_topk"]

_INF = jnp.float32(jnp.inf)


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def topk_smallest(
    dists: jnp.ndarray, ids: jnp.ndarray, k: int, *, group: int = 256
):
    """Smallest-k along the last axis (k <= width).

    dists [..., N] f32 (inf = masked out), ids [..., N] int32.
    Returns (dists [..., k], ids [..., k]) sorted ascending by distance.
    """
    length = dists.shape[-1]
    kp = _next_pow2(max(k, 2))
    if kp * 4 > group:
        # per-group keep wouldn't shrink the width; wide-k selections are
        # rare (coarse_k ~ corpus) and generic top_k is fine there
        neg, idx = jax.lax.top_k(-dists, k)
        return -neg, jnp.take_along_axis(ids, idx, axis=-1)
    batch = dists.shape[:-1]
    while dists.shape[-1] > group:
        lc = dists.shape[-1]
        g = -(-lc // group)
        if g * group != lc:
            pad = [(0, 0)] * (dists.ndim - 1) + [(0, g * group - lc)]
            dists = jnp.pad(dists, pad, constant_values=jnp.inf)
            ids = jnp.pad(ids, pad, constant_values=-1)
        dd = dists.reshape(*batch, g, group)
        ii = ids.reshape(*batch, g, group)
        dd, ii = bitonic_smallest(dd, ii, k=kp)
        dists = dd.reshape(*batch, g * kp)
        ids = ii.reshape(*batch, g * kp)
    return bitonic_smallest(dists, ids, k=k)


def merge_topk(
    d_a: jnp.ndarray, i_a: jnp.ndarray, d_b: jnp.ndarray, i_b: jnp.ndarray, k: int
):
    """Merge two top-k sets (e.g. running result + new chunk) -> smallest k."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    return topk_smallest(d, i, k)
