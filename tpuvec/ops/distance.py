"""Batched distance kernels (plain jnp; XLA fuses and lowers them).

Batched replacement for the reference's per-pair simsimd dispatch
(src/distance/mod.rs:52-84, src/distance/scalar.rs). Instead of one
(a, b) -> scalar call per graph edge, every op here is batched:

* ``*_pairwise(q, x)``: [B, D] x [N, D] -> [B, N]  (matmul forms)
* ``gathered_*(q, nbrs)``: [B, D] x [B, M, D] -> [B, M]  (beam-search form)

Distance semantics match the reference:
  L2      sqrt(sum((a-b)^2))          (scalar.rs:12-21)
  L1      sum(|a-b|)                  (scalar.rs:25-38)
  COSINE  1 - a.b/(|a| |b|)           (scalar.rs:42-52)
  HAMMING popcount(a XOR b)           (scalar.rs:102-112)

Graph traversal uses *internal* distances that are monotone transforms of
the user metric (squared L2 instead of L2; cosine runs on normalized
vectors as squared L2, converted on output as cos = L2^2/2 — the
reference's trick, src/hnsw/mod.rs:129-146). ``internal_to_output``
converts internal values to user-facing ones.

int8 inputs accumulate exactly in int32 (simsimd's i8 kernels
do the same in SIMD registers) before converting to f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuvec.types import DistanceMetric, VectorType

__all__ = [
    "sq_l2_pairwise",
    "l2_pairwise",
    "l1_pairwise",
    "cosine_pairwise",
    "hamming_pairwise",
    "unpack_pm1",
    "internal_pairwise",
    "gathered_internal",
    "internal_to_output",
    "internal_needs_normalize",
]

_F32 = jnp.float32

# f32 dots run at HIGHEST precision (full f32, not TF32 or bf16 passes) so
# distance rankings match the reference's f32 SIMD kernels; a reduced
# default (~1e-3 relative error) is enough to reorder near-ties.
_PRECISION = jax.lax.Precision.HIGHEST


def _dot(a: jnp.ndarray, b_t: jnp.ndarray, int_accum: bool) -> jnp.ndarray:
    """a [B, D] @ b_t [D, N] with the right accumulator type."""
    if int_accum:
        return jax.lax.dot_general(
            a.astype(jnp.int8),
            b_t.astype(jnp.int8),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
    return jnp.dot(
        a.astype(_F32),
        b_t.astype(_F32),
        preferred_element_type=_F32,
        precision=_PRECISION,
    )


def _sq_norms(x: jnp.ndarray, int_accum: bool) -> jnp.ndarray:
    if int_accum:
        xi = x.astype(jnp.int32)
        return jnp.sum(xi * xi, axis=-1)
    xf = x.astype(_F32)
    return jnp.sum(xf * xf, axis=-1)


def sq_l2_pairwise(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Squared L2: [B, D] x [N, D] -> [B, N] via |q|^2 + |x|^2 - 2 q.x."""
    int_accum = q.dtype == jnp.int8 and x.dtype == jnp.int8
    qx = _dot(q, x.T, int_accum)
    qn = _sq_norms(q, int_accum)[:, None]
    xn = _sq_norms(x, int_accum)[None, :]
    if int_accum:
        return (qn + xn - 2 * qx).astype(_F32)
    d = qn + xn - 2.0 * qx
    return jnp.maximum(d, 0.0)  # guard fp cancellation


def l2_pairwise(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(sq_l2_pairwise(q, x))


def l1_pairwise(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """L1 via broadcast [B, N, D] reduce — callers chunk N to bound memory."""
    qf = q.astype(_F32)[:, None, :]
    xf = x.astype(_F32)[None, :, :]
    return jnp.sum(jnp.abs(qf - xf), axis=-1)


def cosine_pairwise(q: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Cosine distance 1 - sim, zero-norm guarded like simsimd (-> dist 1)."""
    int_accum = q.dtype == jnp.int8 and x.dtype == jnp.int8
    qx = _dot(q, x.T, int_accum).astype(_F32)
    qn = jnp.sqrt(_sq_norms(q, int_accum).astype(_F32))[:, None]
    xn = jnp.sqrt(_sq_norms(x, int_accum).astype(_F32))[None, :]
    denom = qn * xn
    sim = jnp.where(denom > 0, qx / jnp.where(denom > 0, denom, 1.0), 0.0)
    return 1.0 - sim


def unpack_pm1(w: jnp.ndarray) -> jnp.ndarray:
    """Packed bits [..., W] uint32 -> [..., W*32] int8 in {-1, +1}
    (LSB-first within each word, matching the codec's packing order)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (w[..., :, None] >> shifts) & jnp.uint32(1)  # [..., W, 32]
    pm1 = (bits.astype(jnp.int8) << 1) - jnp.int8(1)
    return pm1.reshape(*w.shape[:-1], w.shape[-1] * 32)

def hamming_pairwise(qw: jnp.ndarray, xw: jnp.ndarray) -> jnp.ndarray:
    """Hamming over packed uint32 words: [B, W] x [N, W] -> [B, N] (f32).

    Runs as a matmul via the +-1 expansion: for s = 2*bit - 1,
    s_a . s_b = Dp - 2*hamming(a, b), so one int8 matmul with exact int32
    accumulation replaces the [B, N, W] XOR+popcount broadcast cube
    (identical counts: zero pad bits agree on both sides and cancel).
    Reference kernel: src/distance/scalar.rs:102-112.
    """
    dp = qw.shape[-1] * 32
    sq = unpack_pm1(qw)
    sx = unpack_pm1(xw)
    dot = jax.lax.dot_general(
        sq,
        sx.T,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return ((dp - dot) >> 1).astype(_F32)


# --------------------------------------------------------------------------
# Internal (graph) distances
# --------------------------------------------------------------------------


def internal_needs_normalize(metric: DistanceMetric, vec_type: VectorType) -> bool:
    """Cosine + float32 stores normalized vectors and runs L2 internally
    (reference: src/hnsw/mod.rs:129-135 + insert.rs:300-311)."""
    return metric is DistanceMetric.COSINE and vec_type is VectorType.FLOAT32


def internal_pairwise(
    metric: DistanceMetric,
    q: jnp.ndarray,
    x: jnp.ndarray,
    *,
    normalized: bool = False,
) -> jnp.ndarray:
    """Internal distance matrix for graph ops. Monotone in the user metric.

    L2 -> squared L2; COSINE with `normalized=True` -> squared L2 of the
    normalized vectors; COSINE otherwise -> 1-sim; L1 -> L1; HAMMING -> counts.
    """
    if metric is DistanceMetric.L2:
        return sq_l2_pairwise(q, x)
    if metric is DistanceMetric.COSINE:
        if normalized:
            return sq_l2_pairwise(q, x)
        return cosine_pairwise(q, x)
    if metric is DistanceMetric.L1:
        return l1_pairwise(q, x)
    if metric is DistanceMetric.HAMMING:
        return hamming_pairwise(q, x)
    raise ValueError(f"unsupported metric {metric}")


def gathered_internal(
    metric: DistanceMetric,
    q: jnp.ndarray,
    nbrs: jnp.ndarray,
    *,
    normalized: bool = False,
) -> jnp.ndarray:
    """Internal distances q [B, D] vs gathered nbrs [B, M, D] -> [B, M]."""
    if metric in (DistanceMetric.L2, DistanceMetric.COSINE) and (
        metric is DistanceMetric.L2 or normalized
    ):
        int_accum = q.dtype == jnp.int8 and nbrs.dtype == jnp.int8
        if int_accum:
            qi = q.astype(jnp.int32)
            ni = nbrs.astype(jnp.int32)
            diff = qi[:, None, :] - ni
            return jnp.sum(diff * diff, axis=-1).astype(_F32)
        qf = q.astype(_F32)
        nf = nbrs.astype(_F32)
        qx = jnp.einsum("bd,bmd->bm", qf, nf, preferred_element_type=_F32, precision=_PRECISION)
        d = jnp.sum(qf * qf, axis=-1)[:, None] + jnp.sum(nf * nf, axis=-1) - 2.0 * qx
        return jnp.maximum(d, 0.0)
    if metric is DistanceMetric.COSINE:
        qf = q.astype(_F32)
        nf = nbrs.astype(_F32)
        qx = jnp.einsum("bd,bmd->bm", qf, nf, preferred_element_type=_F32, precision=_PRECISION)
        qn = jnp.sqrt(jnp.sum(qf * qf, axis=-1))[:, None]
        nn = jnp.sqrt(jnp.sum(nf * nf, axis=-1))
        denom = qn * nn
        sim = jnp.where(denom > 0, qx / jnp.where(denom > 0, denom, 1.0), 0.0)
        return 1.0 - sim
    if metric is DistanceMetric.L1:
        return jnp.sum(
            jnp.abs(q.astype(_F32)[:, None, :] - nbrs.astype(_F32)), axis=-1
        )
    if metric is DistanceMetric.HAMMING:
        xor = jnp.bitwise_xor(q[:, None, :], nbrs)
        return jnp.sum(jax.lax.population_count(xor), axis=-1).astype(_F32)
    raise ValueError(f"unsupported metric {metric}")


def internal_to_output(
    metric: DistanceMetric, internal: jnp.ndarray, *, normalized: bool = False
) -> jnp.ndarray:
    """Convert internal distances to the user-facing metric.

    Reference equivalents: L2 output = sqrt (scalar.rs:20), cosine output
    for normalized internal-L2 = L2^2/2 (mod.rs:139-146; our internal is
    already squared so it is sq/2).
    """
    if metric is DistanceMetric.L2:
        return jnp.sqrt(internal)
    if metric is DistanceMetric.COSINE and normalized:
        return internal / 2.0
    return internal
