"""Storage byte accounting — the device-resident analogue of the reference's
tests/test_storage_format.rs (shadow-table size breakdown) and the
north-star "equal memory" constraint (BASELINE.md).

The reference measures bytes/vector through SQLite's dbstat (10,309
B/vec at 768D f32, M=32 ef_c=400 — PARITY_STATUS.md:35-54). Here the
authoritative store is the device SoA (index/graph.py) and the
persistence tier is the snapshot file (store/snapshot.py), so the
accounting covers both: per-slot device cost of every graph array, and
on-disk snapshot bytes per vector.
"""

import os
import sys

import numpy as np

from tpuvec.index.params import HnswParams
from tpuvec.store import ColumnSpec, VecTable
from tpuvec.store.snapshot import load, save
from tpuvec.types import DistanceMetric
from tpuvec.utils.data import synthetic_embeddings

# the reference's measured footprint for the same workload shape
# (768D f32; PARITY_STATUS.md:35-54 via SURVEY.md §6)
REFERENCE_BYTES_PER_VEC = 10_309
RAW_BYTES_PER_VEC = 768 * 4

PARAMS = HnswParams(m=16, max_m0=32, ef_construction=64, ef_search=64)


def _graph_bytes_per_slot(vc):
    """Per-slot cost of the device graph arrays (full-capacity cost:
    fair against the reference's per-row dbstat numbers because every
    slot is usable)."""
    st = vc.state
    cap = vc.config.cap
    total = 0
    rows = {}
    for name in (
        "vectors", "adj0", "adj0_dist", "levels", "upper_slot",
        "upper_nodes", "upper_adj", "upper_dist",
    ):
        a = getattr(st, name)
        total += a.size * a.dtype.itemsize
        rows[name] = a.size * a.dtype.itemsize
    return total / cap, rows


def test_storage_breakdown_float32(tmp_path):
    n, d = 300, 768
    x = synthetic_embeddings(n, d, intrinsic_dim=32, n_clusters=16, seed=4)
    t = VecTable(
        "vectors",
        [
            ColumnSpec.vector(
                "embedding", d, metric=DistanceMetric.L2, params=PARAMS
            )
        ],
        initial_cap=n,
    )
    t.insert_many([{"embedding": v} for v in x])
    vc = t.vector_cols["embedding"]

    per_slot, rows = _graph_bytes_per_slot(vc)
    print("\n=== Storage Format Analysis (300 vectors, 768D f32) ===",
          file=sys.stderr)
    for name, b in rows.items():
        print(f"  {name}: {b} bytes ({b / vc.config.cap:.0f} B/slot)",
              file=sys.stderr)
    print(f"  device total: {per_slot:.0f} B/slot "
          f"(raw vector data {RAW_BYTES_PER_VEC} B, "
          f"reference {REFERENCE_BYTES_PER_VEC} B/vec)", file=sys.stderr)

    # equal-memory north star: the device graph must not exceed the
    # reference's measured on-disk footprint for the same workload
    assert per_slot <= REFERENCE_BYTES_PER_VEC, per_slot
    # ... and overhead over raw vectors stays bounded (padded fixed-degree
    # adjacency is the main cost: M0 i32 ids + M0 f32 distances)
    assert per_slot <= 2.0 * RAW_BYTES_PER_VEC, per_slot

    # persistence tier: snapshot bytes per stored vector
    for engine in ("npz", "native"):
        path = str(tmp_path / f"store_{engine}.bin")
        save(t, path, engine=engine)
        size = os.path.getsize(path)
        print(f"  snapshot[{engine}]: {size} bytes ({size / n:.0f} B/vec)",
              file=sys.stderr)
        assert size / n <= REFERENCE_BYTES_PER_VEC, (engine, size / n)
        t2 = load(path)
        assert len(t2) == n


def test_int8_quantized_index_is_smaller():
    """index_quantization=int8 must shrink the device vector array ~4x
    (the reference measures 1.88x whole-file; the vector payload itself
    is exactly 4x, src/vector.rs:554-575)."""
    from tpuvec.types import IndexQuantization

    n, d = 128, 256
    x = synthetic_embeddings(n, d, intrinsic_dim=16, n_clusters=8, seed=5)

    def vec_bytes(quant):
        t = VecTable(
            "q",
            [
                ColumnSpec.vector(
                    "e", d, metric=DistanceMetric.L2, params=PARAMS,
                    quantization=quant,
                )
            ],
            initial_cap=n,
        )
        t.insert_many([{"e": v} for v in x])
        a = t.vector_cols["e"].state.vectors
        return a.size * a.dtype.itemsize

    f32_b = vec_bytes(None)
    i8_b = vec_bytes(IndexQuantization.INT8)
    assert i8_b * 4 <= f32_b * 1.01, (f32_b, i8_b)


def test_snapshot_row_accounting(tmp_path):
    """Analogue of test_unified_storage_inspection (row counts in _data):
    the snapshot must carry exactly the live rows and restore them."""
    n, d = 200, 64
    x = synthetic_embeddings(n, d, intrinsic_dim=16, n_clusters=8, seed=6)
    t = VecTable(
        "acct",
        [ColumnSpec.vector("e", d, metric=DistanceMetric.L2, params=PARAMS),
         ColumnSpec.metadata("tag")],
        initial_cap=256,
    )
    for i, v in enumerate(x):
        t.insert({"e": v, "tag": i})
    for rid in range(1, 51):  # delete a quarter
        t.delete(rid)
    path = str(tmp_path / "acct.npz")
    save(t, path, engine="npz")
    t2 = load(path)
    assert len(t2) == n - 50
    assert t2.row(51)["tag"] == 50
    got = {r.rowid for r in t2.knn("e", x[60], k=5)}
    assert 61 in got
