"""tpuvec — a device-resident vector index-and-query framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
brianmacy/sqlite-vec-hnsw (a SQLite ``vec0`` virtual table with persistent
HNSW indexing; see /root/reference). The reference's shadow-table store
becomes a device-resident columnar store; its simsimd SIMD distance
kernels become batched matmul-form kernels; its pointer-chasing HNSW becomes
fixed-iteration batched beam search over padded adjacency arrays; the
brute-force fallback becomes tiled matmul + top-k; partition keys map to
mesh shards with all-gather top-k merge.

Public surface:
    tpuvec.types      -- VectorType / DistanceMetric / IndexQuantization / errors
    tpuvec.codec      -- JSON <-> little-endian blob codecs (reference parity)
    tpuvec.quantize   -- int8 / binary quantizers (reference parity)
    tpuvec.ops        -- batched distance + top-k kernels
    tpuvec.index      -- HnswIndex (build/search/delete/rebuild) + brute force
    tpuvec.store      -- VecTable columnar store + snapshot/restore
    tpuvec.sql        -- vec0 SQL dialect: Database, vec_* scalar functions
    tpuvec.parallel   -- partitioned/sharded indexes over a device mesh
"""

from tpuvec.types import (
    DistanceMetric,
    IndexQuantization,
    VectorType,
    TpuVecError,
    DimensionMismatch,
    InvalidVectorFormat,
    InvalidVectorType,
    InvalidDistanceMetric,
    InvalidParameter,
    InvalidState,
)

__version__ = "0.1.0"

__all__ = [
    "DistanceMetric",
    "IndexQuantization",
    "VectorType",
    "TpuVecError",
    "DimensionMismatch",
    "InvalidVectorFormat",
    "InvalidVectorType",
    "InvalidDistanceMetric",
    "InvalidParameter",
    "InvalidState",
    "__version__",
]
