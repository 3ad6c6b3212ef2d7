"""Snapshot / restore: host-side persistence of a VecTable.

The reference's checkpoint story is "the SQLite file IS the checkpoint"
(shadow tables persist nodes/edges/meta, src/shadow.rs:192-257; resume =
reopen, tests/test_disk_persistence.rs). Here the authoritative state
lives in device memory, so persistence is an explicit snapshot: device arrays are
pulled to host and written as one .npz archive plus a JSON schema record;
restore is a jax.device_put of the arrays.

When the native runtime is built (csrc/), the same logical format is
written through the C++ storage engine (mmap + CRC); this module is the
always-available fallback and the format definition.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from tpuvec.index.graph import GraphState
from tpuvec.index.params import HnswParams
from tpuvec.store.table import ColumnSpec, VecTable, _MeshVectorColumn
from tpuvec.types import (
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidState,
    VectorType,
)

__all__ = ["save", "load", "FORMAT_VERSION"]

# v1: original layout (upper_adj/upper_dist were [cap_u, LU, M] 3D early on,
#     later flattened to [cap_u, LU*M] without a bump — load() reshapes).
# v2: upper arrays are always 2D [cap_u, LU*M].
FORMAT_VERSION = 2
_READABLE_VERSIONS = (1, 2)

_GRAPH_FIELDS = [
    "vectors",
    "adj0",
    "adj0_dist",
    "levels",
    "upper_slot",
    "upper_nodes",
    "upper_adj",
    "upper_dist",
    "entry_point",
    "entry_level",
    "count",
    "upper_count",
]


def _spec_to_json(spec: ColumnSpec) -> dict:
    d = {
        "name": spec.name,
        "kind": spec.kind,
        "dimensions": spec.dimensions,
        "metric": spec.metric.value,
        "hnsw": spec.hnsw,
        "quantization": spec.quantization.value,
    }
    if spec.vec_type is not None:
        d["vec_type"] = spec.vec_type.value
    if spec.params is not None:
        d["params"] = dataclasses.asdict(spec.params)
    return d


def _spec_from_json(d: dict) -> ColumnSpec:
    return ColumnSpec(
        name=d["name"],
        kind=d["kind"],
        vec_type=VectorType.parse(d["vec_type"]) if "vec_type" in d else None,
        dimensions=d.get("dimensions", 0),
        metric=DistanceMetric.parse(d.get("metric", "cosine")),
        hnsw=d.get("hnsw", False),
        params=HnswParams(**d["params"]) if "params" in d else None,
        quantization=IndexQuantization.parse(d.get("quantization", "none")),
    )


def save(table: VecTable, path: str, *, engine: str = "auto") -> None:
    """Write a snapshot atomically (tmp file + rename).

    engine: "auto" uses the native C++ tvstore (mmap + CRC, csrc/) when the
    library is available and the path doesn't end in .npz; "npz" forces the
    numpy fallback; "native" requires tvstore.
    """
    table.flush()
    if engine == "auto":
        from tpuvec import native

        engine = (
            "native"
            if native.available() and not path.endswith(".npz")
            else "npz"
        )
    meta = {
        "format_version": FORMAT_VERSION,
        "name": table.name,
        "index_type": table.index_type.value,
        "columns": [_spec_to_json(c) for c in table.columns],
        "rowid_to_slot": {str(k): v for k, v in table._rowid_to_slot.items()},
        "max_rowid": table._max_rowid,
        "next_slot": table._next_slot,
        "free_slots": table._free_slots,
        "scalar_data": {
            cname: {
                str(rid): sc.get(slot)
                for rid, slot in table._rowid_to_slot.items()
                if sc.get(slot) is not None
            }
            for cname, sc in table._scalars.items()
        },
    }
    if table.mesh is not None:
        vc = next(iter(table.vector_cols.values()))
        meta["mesh"] = {
            "n_shards": vc.idx.n_shards,
            "counts": vc.idx._counts.tolist(),
            "free": [list(f) for f in vc.idx._free],
            "rr": vc.idx._rr,
            "table_rr": table._rr,
        }
    try:
        meta_json = json.dumps(meta)
    except TypeError as e:
        raise InvalidState(
            "snapshot requires JSON-serializable scalar column values "
            f"(int/float/str/bool/None): {e}"
        ) from None
    arrays: dict[str, np.ndarray] = {}
    for cname, vc in table.vector_cols.items():
        arrays[f"raw::{cname}"] = vc.raw
        state = vc.idx.stacked if isinstance(vc, _MeshVectorColumn) else vc.state
        for f in _GRAPH_FIELDS:
            arrays[f"graph::{cname}::{f}"] = np.asarray(getattr(state, f))
    arrays["__meta__"] = np.frombuffer(meta_json.encode("utf-8"), dtype=np.uint8)

    if engine == "native":
        from tpuvec.native import TvsWriter

        w = TvsWriter(path)
        try:
            for name, arr in arrays.items():
                w.add(name, arr)
            w.finish()
        except BaseException:
            w.abort()
            raise
        return

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _open_archive(path: str):
    """Return a dict-like of arrays, sniffing tvstore vs npz."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"TPVS":
        from tpuvec.native import TvsReader

        r = TvsReader(path)
        try:
            return r.read_all()
        finally:
            r.close()
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load(path: str, mesh=None) -> VecTable:
    """Restore a VecTable from a snapshot file (tvstore or npz).

    Mesh-backed snapshots need a ``mesh`` with the same shard count."""
    z = _open_archive(path)
    meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
    if meta.get("format_version") not in _READABLE_VERSIONS:
        raise InvalidState(
            f"unsupported snapshot format {meta.get('format_version')}"
        )
    # v1 snapshots written before the upper-array flattening carry
    # [cap_u, LU, M] arrays; the runtime layout is [cap_u, LU*M]. Mesh
    # snapshots stack a leading shard axis, so the expected rank is 2
    # (+1 when mesh) and a one-higher rank means "pre-flattening v1".
    expect_ndim = 2 if meta.get("mesh") is None else 3
    for key in list(z):
        if key.endswith("::upper_adj") or key.endswith("::upper_dist"):
            if z[key].ndim == expect_ndim + 1:
                z[key] = z[key].reshape(*z[key].shape[: expect_ndim - 1], -1)
    columns = [_spec_from_json(c) for c in meta["columns"]]
    mesh_meta = meta.get("mesh")
    if mesh_meta is not None:
        if mesh is None:
            raise InvalidState(
                "snapshot is mesh-backed: pass load(path, mesh=...) with "
                f"{mesh_meta['n_shards']} devices"
            )
        if mesh.devices.size != mesh_meta["n_shards"]:
            raise InvalidState(
                f"snapshot has {mesh_meta['n_shards']} shards, mesh has "
                f"{mesh.devices.size}"
            )
    table = VecTable(
        meta["name"],
        columns,
        index_type=IndexType.parse(meta["index_type"]),
        initial_cap=128 if mesh_meta is None else 1,
        mesh=mesh if mesh_meta is not None else None,
    )
    table._rowid_to_slot = {int(k): v for k, v in meta["rowid_to_slot"].items()}
    table._slot_to_rowid = {v: k for k, v in table._rowid_to_slot.items()}
    table._max_rowid = meta["max_rowid"]
    table._next_slot = meta["next_slot"]
    table._free_slots = list(meta["free_slots"])
    table._grow_host(
        max(max(table._slot_to_rowid, default=0) + 1, table._next_slot, 1)
    )
    for slot in table._slot_to_rowid:
        table._live[slot] = True
    for cname, vals in meta["scalar_data"].items():
        sc = table._scalars[cname]
        for rid_s, v in vals.items():
            sc.set(table._rowid_to_slot[int(rid_s)], v)
    for cname, vc in table.vector_cols.items():
        raw = z[f"raw::{cname}"]
        if isinstance(vc, _MeshVectorColumn):
            from jax.sharding import NamedSharding, PartitionSpec as P

            cap = int(z[f"graph::{cname}::vectors"].shape[1])
            if cap != vc.config.cap:
                vc.config = dataclasses.replace(
                    vc.config,
                    cap=cap,
                    cap_u=int(z[f"graph::{cname}::upper_nodes"].shape[1]),
                )
                vc.idx.config = vc.config
            vc.raw = raw.copy()
            sharding = NamedSharding(mesh, P(vc.idx.axis))
            fields = {
                f: jax.device_put(jnp.asarray(z[f"graph::{cname}::{f}"]), sharding)
                for f in _GRAPH_FIELDS
            }
            vc.idx.stacked = GraphState(**fields)
            vc.idx._counts = np.asarray(mesh_meta["counts"], dtype=np.int64)
            vc.idx._free = [list(f) for f in mesh_meta["free"]]
            vc.idx._rr = mesh_meta["rr"]
            table._rr = mesh_meta["table_rr"]
            vc.idx._part_codes = np.full(
                (vc.idx.n_shards, cap), -1, dtype=np.int32
            )
            if table.partition_col is not None:
                # rebuild the index-side partition codes from the table's
                # scalar column (single source of truth)
                sc = table._scalars[table.partition_col]
                for rid, slot in table._rowid_to_slot.items():
                    v = sc.get(slot)
                    if v is not None:
                        s, sl = divmod(slot, cap)
                        vc.idx._part_codes[s, sl] = vc.idx._intern_partition(v)
            continue
        cap = raw.shape[0]
        if cap != vc.config.cap:
            vc.config = dataclasses.replace(
                vc.config,
                cap=cap,
                cap_u=z[f"graph::{cname}::upper_nodes"].shape[0],
            )
        vc.raw = raw.copy()
        fields = {
            f: jnp.asarray(z[f"graph::{cname}::{f}"]) for f in _GRAPH_FIELDS
        }
        vc.state = GraphState(**fields)
        vc.refresh_shadow()  # device rerank copy follows the originals
    # host slot arrays (_live, scalar columns) must cover the FULL slot
    # capacity, not just the high-water slot: exact-scan paths reshape
    # the live mask against cap, and clamped gathers against a short
    # mask silently mis-filter (advisor round 2, high)
    table._grow_host(table.cap)
    return table
