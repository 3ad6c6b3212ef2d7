"""Exact (ENN) brute-force KNN: tiled matmul + chunked top-k merge.

Batched replacement for the reference's row-at-a-time scan
(brute_force_search, src/vtab.rs:2573-2623): distances for a whole
[B queries x chunk] tile come out of one matmul, and the running top-k
is merged per chunk with masked lax.top_k. Doubles as the ground-truth
oracle for HNSW recall tests (the reference computes its ground truth the
same way in-test, tests/test_recall_accuracy.rs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpuvec.ops.distance import internal_pairwise, internal_to_output
from tpuvec.ops.topk import merge_topk, topk_smallest
from tpuvec.types import DistanceMetric

__all__ = ["bruteforce_knn", "bruteforce_knn_internal"]

_INF = jnp.float32(jnp.inf)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@partial(
    jax.jit,
    static_argnames=("metric", "k", "chunk", "normalized"),
)
def bruteforce_knn_internal(
    q: jnp.ndarray,
    x: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    metric: DistanceMetric,
    k: int,
    chunk: int = 16384,
    normalized: bool = False,
    slot_codes: jnp.ndarray | None = None,
    q_codes: jnp.ndarray | None = None,
):
    """Exact k-NN in *internal* distance space.

    q [B, D]; x [N, D] (N padded rows allowed — mask them via `valid`);
    valid [N] bool. Returns (internal_dists [B, k], ids [B, k]) ascending;
    masked/padded slots come back as (+inf, -1).

    `slot_codes` [N] int32 + `q_codes` [B] int32 enable PER-QUERY equality
    filtering in one dispatch (multi-tenant serving: B queries, each its
    own partition): row n is eligible for query b iff
    slot_codes[n] == q_codes[b]. The [B, chunk] mask is computed in-kernel
    against the distance tile the matmul already produced, so the filtered
    batch costs the same as the unfiltered one — vs the reference, which
    parses PARTITION KEY but never filters at all (src/vtab.rs:2479-2480).
    """
    b, _ = q.shape
    n = x.shape[0]
    if metric is DistanceMetric.HAMMING:
        # +-1 matmul path: per-chunk footprint is the int8 expansion
        # [chunk, 32*W] plus the [B, chunk] output — bound it to ~512 MB
        per_row = max(32 * x.shape[-1] + b * 4, 1)
        chunk = min(chunk, max(_ceil_to((512 << 20) // per_row, 128), 128))
    chunk = min(chunk, _ceil_to(n, 128))
    n_pad = _ceil_to(n, chunk)
    if n_pad != n:
        pad = n_pad - n
        x = jnp.pad(x, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))
        if slot_codes is not None:
            slot_codes = jnp.pad(slot_codes, (0, pad), constant_values=-1)
    n_chunks = n_pad // chunk

    init_d = jnp.full((b, k), _INF, dtype=jnp.float32)
    init_i = jnp.full((b, k), -1, dtype=jnp.int32)

    xs = x.reshape(n_chunks, chunk, x.shape[-1])
    vs = valid.reshape(n_chunks, chunk)
    starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    cs = None if slot_codes is None else slot_codes.reshape(n_chunks, chunk)

    def step(carry, inp):
        run_d, run_i = carry
        xc, vc, start, cc = inp
        d = internal_pairwise(metric, q, xc, normalized=normalized)
        d = jnp.where(vc[None, :], d, _INF)
        if cc is not None:
            d = jnp.where(cc[None, :] == q_codes[:, None], d, _INF)
        ids = (start + jnp.arange(chunk, dtype=jnp.int32))[None, :].repeat(b, axis=0)
        cd, ci = topk_smallest(d, ids, min(k, chunk))
        if k > chunk:  # pad chunk top-k up to k for a uniform merge width
            cd = jnp.pad(cd, ((0, 0), (0, k - chunk)), constant_values=_INF)
            ci = jnp.pad(ci, ((0, 0), (0, k - chunk)), constant_values=-1)
        return merge_topk(run_d, run_i, cd, ci, k), None

    (out_d, out_i), _ = jax.lax.scan(
        step, (init_d, init_i), (xs, vs, starts, cs)
    )
    out_i = jnp.where(jnp.isfinite(out_d), out_i, -1)
    return out_d, out_i


def bruteforce_knn(
    q: jnp.ndarray,
    x: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    metric: DistanceMetric,
    k: int,
    chunk: int = 16384,
    normalized: bool = False,
):
    """Exact k-NN returning user-metric distances (ascending) and ids."""
    d, i = bruteforce_knn_internal(
        q, x, valid, metric=metric, k=k, chunk=chunk, normalized=normalized
    )
    out = internal_to_output(metric, d, normalized=normalized)
    return jnp.where(jnp.isfinite(d), out, _INF), i
