"""Batched distance / top-k / rerank operations (plain jnp, compiled by XLA)."""

from tpuvec.ops.distance import (
    cosine_pairwise,
    gathered_internal,
    hamming_pairwise,
    internal_pairwise,
    internal_to_output,
    l1_pairwise,
    l2_pairwise,
    sq_l2_pairwise,
)

__all__ = [
    "sq_l2_pairwise",
    "l2_pairwise",
    "l1_pairwise",
    "cosine_pairwise",
    "hamming_pairwise",
    "internal_pairwise",
    "gathered_internal",
    "internal_to_output",
]
