"""Device-resident HNSW graph state: structure-of-arrays in device memory.

Device-resident replacement for the reference's SQLite shadow tables
(_hnsw_nodes / _hnsw_edges / _hnsw_meta, src/shadow.rs:192-257): instead of
point queries against a page cache, the whole graph lives as padded,
fixed-degree arrays that batched kernels gather from.

Layout (cap = node capacity, Dp = dim padded to a lane multiple):

  vectors     [cap, Dp]        index copy of each vector (normalized for
                               cosine, quantized for int8/binary indexes) —
                               the analogue of _hnsw_nodes.vector
  adj0        i32 [cap, M0]    level-0 adjacency, -1 padded
  adj0_dist   f32 [cap, M0]    stored internal edge distances — same trick
                               as the reference's _hnsw_edges.distance
                               column (src/shadow.rs:241-254): prune without
                               re-fetching vectors
  levels      i32 [cap]        node level; -1 = absent/deleted
  upper_slot  i32 [cap]        compact-slot id for nodes with level >= 1
  upper_nodes i32 [cap_u]      slot -> node id (-1 = unused)
  upper_adj   i32 [cap_u, LU*M]   adjacency at levels 1..LU (level l at
  upper_dist  f32 [cap_u, LU*M]   columns [(l-1)*M, l*M) — flattened 2D:
                                  XLA pads a [cap_u, LU, M] layout's minor
                                  dims to tiles, multiplying the bytes)
  entry_point / entry_level / count / upper_count   scalars

Only ~1/M of nodes have level >= 1, so the upper graph is stored compactly
(cap_u = cap/8 slots by default) and is small enough that construction-time
neighbor selection on upper levels is done *exactly* with a matmul
over all upper nodes instead of graph traversal.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuvec.index.params import HnswParams
from tpuvec.ops.distance import internal_needs_normalize
from tpuvec.types import DistanceMetric, IndexQuantization, VectorType

__all__ = ["HnswConfig", "GraphState", "allocate", "config_for", "prepare_queries"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Static (hashable) graph configuration — jit-compile-time constants."""

    dim: int                      # logical dimensions
    padded_dim: int               # lane-aligned storage width (words for BIT)
    metric: DistanceMetric
    vec_type: VectorType          # user element type
    quantization: IndexQuantization
    normalized: bool              # index copy is L2-normalized (cosine trick)
    cap: int
    cap_u: int
    m: int
    max_m0: int
    lu: int                       # number of stored upper levels
    ef_construction: int
    ef_search: int
    rng_seed: int
    level_factor: float
    simple_prune: bool = False    # False = RNG diversity heuristic (params.py)
    build_max_iters: int | None = None  # construction-beam iteration cap

    @property
    def store_dtype(self):
        if self.quantization is IndexQuantization.INT8:
            return jnp.int8
        if self.quantization is IndexQuantization.BINARY:
            return jnp.uint32
        if self.vec_type is VectorType.FLOAT32:
            return jnp.float32
        if self.vec_type is VectorType.INT8:
            return jnp.int8
        return jnp.uint32  # BIT: packed words

    @property
    def internal_metric_is_hamming(self) -> bool:
        return (
            self.vec_type is VectorType.BIT
            or self.quantization is IndexQuantization.BINARY
        )

    @property
    def graph_metric(self) -> DistanceMetric:
        """Metric used for internal graph distances."""
        if self.internal_metric_is_hamming:
            return DistanceMetric.HAMMING
        return self.metric


def config_for(
    dim: int,
    *,
    metric: DistanceMetric = DistanceMetric.COSINE,
    vec_type: VectorType = VectorType.FLOAT32,
    quantization: IndexQuantization = IndexQuantization.NONE,
    params: HnswParams | None = None,
    cap: int = 1024,
) -> HnswConfig:
    """Build an HnswConfig. Default metric is cosine, matching the vtab
    default (src/vtab.rs:240-249)."""
    params = params or HnswParams()
    params.validate()
    if vec_type is VectorType.BIT or quantization is IndexQuantization.BINARY:
        # packed uint32 words
        padded = _ceil_to(max(dim, 1), 32) // 32
        # align to 8 words only: device layouts are dense, so padding packed
        # words to a multiple of 128 would 4x the store (5.1 GB vs
        # 1.3 GB at 10M x 1024 bits) for zero gather benefit
        padded = _ceil_to(padded, 8)
    elif vec_type is VectorType.INT8 or quantization is IndexQuantization.INT8:
        padded = _ceil_to(dim, 128)
    else:
        padded = _ceil_to(dim, 128)
    cap = max(_ceil_to(cap, 128), 128)
    cap_u = max(_ceil_to(cap // 8, 128), 128)
    lu = min(6, params.max_level)
    return HnswConfig(
        dim=dim,
        padded_dim=padded,
        metric=metric,
        vec_type=vec_type,
        quantization=quantization,
        normalized=(
            internal_needs_normalize(metric, vec_type)
            and quantization is not IndexQuantization.BINARY
        ),
        cap=cap,
        cap_u=cap_u,
        m=params.m,
        max_m0=params.max_m0,
        lu=lu,
        ef_construction=params.ef_construction,
        ef_search=params.ef_search,
        rng_seed=params.rng_seed,
        level_factor=params.level_factor,
        simple_prune=params.simple_prune,
        build_max_iters=params.build_max_iters,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GraphState:
    vectors: jnp.ndarray       # [cap, Dp] store_dtype
    adj0: jnp.ndarray          # [cap, M0] i32
    adj0_dist: jnp.ndarray     # [cap, M0] f32
    levels: jnp.ndarray        # [cap] i32 (-1 absent)
    upper_slot: jnp.ndarray    # [cap] i32 (-1 none)
    upper_nodes: jnp.ndarray   # [cap_u] i32 (-1 unused)
    upper_adj: jnp.ndarray     # [cap_u, LU*M] i32 (level l-1 at cols [(l-1)M, lM))
    upper_dist: jnp.ndarray    # [cap_u, LU*M] f32
    entry_point: jnp.ndarray   # [] i32
    entry_level: jnp.ndarray   # [] i32
    count: jnp.ndarray         # [] i32
    upper_count: jnp.ndarray   # [] i32


def allocate(config: HnswConfig) -> GraphState:
    """Fresh empty graph."""
    c = config
    return GraphState(
        vectors=jnp.zeros((c.cap, c.padded_dim), dtype=c.store_dtype),
        adj0=jnp.full((c.cap, c.max_m0), -1, dtype=jnp.int32),
        adj0_dist=jnp.full((c.cap, c.max_m0), jnp.inf, dtype=jnp.float32),
        levels=jnp.full((c.cap,), -1, dtype=jnp.int32),
        upper_slot=jnp.full((c.cap,), -1, dtype=jnp.int32),
        upper_nodes=jnp.full((c.cap_u,), -1, dtype=jnp.int32),
        upper_adj=jnp.full((c.cap_u, c.lu * c.m), -1, dtype=jnp.int32),
        upper_dist=jnp.full((c.cap_u, c.lu * c.m), jnp.inf, dtype=jnp.float32),
        entry_point=jnp.int32(-1),
        entry_level=jnp.int32(-1),
        count=jnp.int32(0),
        upper_count=jnp.int32(0),
    )


# --------------------------------------------------------------------------
# Vector preparation (index copies and queries share the same transform)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("config",))
def prepare_vectors(config: HnswConfig, v: jnp.ndarray) -> jnp.ndarray:
    """Transform raw user vectors [B, dim] into index/store form [B, Dp].

    Mirrors the reference insert path: normalize-if-cosine
    (insert.rs:300-311) then quantize-for-index (insert.rs:313-322);
    queries go through the same transform at search time
    (search.rs:285-302).
    """
    from tpuvec.quantize import quantize_int8_for_index

    c = config
    if c.vec_type is VectorType.BIT:
        # already packed words; pad to padded_dim
        pad = c.padded_dim - v.shape[-1]
        return jnp.pad(v.astype(jnp.uint32), ((0, 0), (0, pad)))

    vf = v.astype(jnp.float32)
    if c.normalized:
        norm = jnp.linalg.norm(vf, axis=-1, keepdims=True)
        vf = jnp.where(norm > 0, vf / jnp.where(norm > 0, norm, 1.0), vf)

    if c.quantization is IndexQuantization.BINARY:
        d32 = _ceil_to(c.dim, 32)
        vf = jnp.pad(vf, ((0, 0), (0, d32 - vf.shape[-1])))
        # pad bits replicate the mean-threshold of real dims only
        mean = jnp.mean(vf[:, : c.dim], axis=-1, keepdims=True)
        bits = (vf >= mean).astype(jnp.uint32)
        # zero out padding bits
        mask = (jnp.arange(d32) < c.dim)[None, :]
        from tpuvec.quantize import pack_bits_to_words

        words = pack_bits_to_words(jnp.where(mask, bits, 0))
        pad = c.padded_dim - words.shape[-1]
        return jnp.pad(words, ((0, 0), (0, pad)))

    pad = c.padded_dim - vf.shape[-1]
    vf = jnp.pad(vf, ((0, 0), (0, pad)))
    if c.quantization is IndexQuantization.INT8:
        return quantize_int8_for_index(vf)
    if c.vec_type is VectorType.INT8:
        return v.astype(jnp.int8) if pad == 0 else jnp.pad(
            v.astype(jnp.int8), ((0, 0), (0, pad))
        )
    return vf


# Queries use the identical transform.
prepare_queries = prepare_vectors
