"""The vec_* scalar function set.

Function-for-function parity with the reference's SQL layer
(src/sql_functions.rs:13-534), implemented over tpuvec.codec /
tpuvec.quantize, and registerable on any stdlib ``sqlite3.Connection`` via
``register_all`` (the reference registers on rusqlite, src/lib.rs:26-34).

Semantics notes mirrored from the reference:
* constructors accept JSON text or raw LE blobs and return canonical blobs;
* vec_length / vec_type / vec_to_json sniff the type (f32 -> int8 -> bit,
  src/sql_functions.rs:217-275);
* vec_add/sub/normalize/slice/quantize_* take f32 blobs
  (src/sql_functions.rs:277-416);
* vec_version returns "<name> <version>" (src/sql_functions.rs:418-427);
* vec_debug exists but is unimplemented in the reference
  (src/sql_functions.rs:429-434) — ours reports runtime info instead.
"""

from __future__ import annotations

import json
from typing import Any

from tpuvec import __version__
from tpuvec.codec import Vector
from tpuvec.quantize import quantize_binary_np, quantize_int8_np
from tpuvec.types import DistanceMetric, InvalidVectorFormat, VectorType

__all__ = [
    "vec_f32", "vec_int8", "vec_bit",
    "vec_distance_l2", "vec_distance_l1", "vec_distance_cosine",
    "vec_distance_hamming",
    "vec_length", "vec_type", "vec_to_json",
    "vec_add", "vec_sub", "vec_normalize", "vec_slice",
    "vec_quantize_int8", "vec_quantize_binary",
    "vec_version", "vec_debug",
    "register_all",
]


def _vector_from_sql(value: Any, vec_type: VectorType) -> Vector:
    return Vector.from_sql_value(value, vec_type)


def _sniff(value: Any) -> Vector:
    """Try f32 -> int8 -> bit, like the reference (sql_functions.rs:217-229)."""
    last = None
    for vt in (VectorType.FLOAT32, VectorType.INT8, VectorType.BIT):
        try:
            return _vector_from_sql(value, vt)
        except Exception as e:  # noqa: BLE001 — mirror or_else chain
            last = e
    raise last


def _f32_blob(value: Any) -> Vector:
    if not isinstance(value, (bytes, bytearray, memoryview)):
        raise InvalidVectorFormat("expected a float32 blob")
    return Vector.from_blob(bytes(value), VectorType.FLOAT32)


# -- constructors -----------------------------------------------------------


def vec_f32(value) -> bytes:
    return _vector_from_sql(value, VectorType.FLOAT32).as_bytes()


def vec_int8(value) -> bytes:
    return _vector_from_sql(value, VectorType.INT8).as_bytes()


def vec_bit(value) -> bytes:
    return _vector_from_sql(value, VectorType.BIT).as_bytes()


# -- distances --------------------------------------------------------------


def _dist(a, b, vec_type: VectorType, metric: DistanceMetric) -> float:
    import numpy as np

    va = _vector_from_sql(a, vec_type)
    vb = _vector_from_sql(b, vec_type)
    if va.dimensions != vb.dimensions:
        from tpuvec.types import DimensionMismatch

        raise DimensionMismatch(va.dimensions, vb.dimensions)
    x, y = va.to_numpy(), vb.to_numpy()
    if metric is DistanceMetric.L2:
        return float(np.sqrt(((x.astype(np.float64) - y.astype(np.float64)) ** 2).sum()))
    if metric is DistanceMetric.L1:
        return float(np.abs(x.astype(np.float64) - y.astype(np.float64)).sum())
    if metric is DistanceMetric.COSINE:
        xf, yf = x.astype(np.float64), y.astype(np.float64)
        na, nb_ = np.linalg.norm(xf), np.linalg.norm(yf)
        if na == 0 or nb_ == 0:
            return 1.0
        return float(1.0 - (xf @ yf) / (na * nb_))
    return float((x != y).sum())  # HAMMING over unpacked bits


def vec_distance_l2(a, b) -> float:
    return _dist(a, b, VectorType.FLOAT32, DistanceMetric.L2)


def vec_distance_l1(a, b) -> float:
    return _dist(a, b, VectorType.FLOAT32, DistanceMetric.L1)


def vec_distance_cosine(a, b) -> float:
    return _dist(a, b, VectorType.FLOAT32, DistanceMetric.COSINE)


def vec_distance_hamming(a, b) -> float:
    return _dist(a, b, VectorType.BIT, DistanceMetric.HAMMING)


# -- introspection ----------------------------------------------------------


def vec_length(value) -> int:
    return _sniff(value).dimensions


def vec_type(value) -> str:
    return _sniff(value).vec_type.value


def vec_to_json(value) -> str:
    return _sniff(value).to_json()


# -- math -------------------------------------------------------------------


def vec_add(a, b) -> bytes:
    return _f32_blob(a).add(_f32_blob(b)).as_bytes()


def vec_sub(a, b) -> bytes:
    return _f32_blob(a).sub(_f32_blob(b)).as_bytes()


def vec_normalize(a) -> bytes:
    return _f32_blob(a).normalize().as_bytes()


def vec_slice(a, start: int, end: int) -> bytes:
    return _f32_blob(a).slice(int(start), int(end)).as_bytes()


# -- quantization -----------------------------------------------------------


def vec_quantize_int8(a) -> bytes:
    return Vector.from_i8(quantize_int8_np(_f32_blob(a).as_f32())).as_bytes()


def vec_quantize_binary(a) -> bytes:
    return Vector.from_bits(quantize_binary_np(_f32_blob(a).as_f32())).as_bytes()


# -- metadata ---------------------------------------------------------------


def vec_version() -> str:
    return f"tpuvec {__version__}"


def vec_debug() -> str:
    """Runtime info (the reference's vec_debug is a TODO)."""
    import jax

    return json.dumps(
        {
            "version": __version__,
            "backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "devices": [str(d) for d in jax.devices()],
        }
    )


_REGISTRY = [
    ("vec_f32", 1, vec_f32),
    ("vec_int8", 1, vec_int8),
    ("vec_bit", 1, vec_bit),
    ("vec_distance_l2", 2, vec_distance_l2),
    ("vec_distance_l1", 2, vec_distance_l1),
    ("vec_distance_cosine", 2, vec_distance_cosine),
    ("vec_distance_hamming", 2, vec_distance_hamming),
    ("vec_length", 1, vec_length),
    ("vec_type", 1, vec_type),
    ("vec_to_json", 1, vec_to_json),
    ("vec_add", 2, vec_add),
    ("vec_sub", 2, vec_sub),
    ("vec_normalize", 1, vec_normalize),
    ("vec_slice", 3, vec_slice),
    ("vec_quantize_int8", 1, vec_quantize_int8),
    ("vec_quantize_binary", 1, vec_quantize_binary),
    ("vec_version", 0, vec_version),
    ("vec_debug", 0, vec_debug),
]


def register_all(conn) -> None:
    """Register every vec_* function on a stdlib sqlite3 connection
    (reference register_all, src/sql_functions.rs:13-48). vec_rebuild_hnsw
    is registered by the Database facade, which owns the table registry
    (the reference needs a forked Context::get_connection for it)."""
    for name, nargs, fn in _REGISTRY:
        conn.create_function(name, nargs, fn, deterministic=True)
