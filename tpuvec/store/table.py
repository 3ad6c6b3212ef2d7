"""VecTable: the vec0 virtual table re-designed as a device-resident store.

Capability parity with the reference's Vec0Tab (src/vtab.rs:628-2647) and
its shadow-table storage (src/shadow.rs:105-900):

* column classes: vector (with optional per-column HNSW index + per-column
  distance metric + index quantization), metadata, auxiliary (+col),
  partition key (src/vtab.rs:854-885);
* rowids: explicit or auto-assigned (next_rowid, src/shadow.rs:888-900);
* main storage keeps ORIGINAL vector precision; the HNSW index keeps its
  own normalized/quantized copy (src/vtab.rs:2341-2482 reads originals);
* insert / update (same-rowid, src/vtab.rs:1700-1704) / delete with HNSW
  maintenance; knn(k) search per vector column; ENN brute force when the
  column has no HNSW index or the table is type=enn;
* integrity_check (entry-point validation, src/vtab.rs:1264-1322) and
  rebuild (vec_rebuild_hnsw, src/sql_functions.rs:436-534).

Differences by design (device-first):
* rows live at dense internal slots in device arrays; a host-side dict maps
  user rowids to slots (the reference's B-tree keying);
* inserts buffer host-side and flush to the device in padded power-of-two
  mini-batches (the reference's transaction batching, amortizing jit
  shapes); every read path flushes first;
* partition-key filtering and metadata filtering ARE implemented (the
  reference parses partition keys but returns NULL, README.md:467 /
  src/vtab.rs:2479-2480) — as masks applied to exact search and
  post-filtering for HNSW search.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Iterable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpuvec.codec import Vector, pack_bits
from tpuvec.index.build import build_graph, delete_ids, insert_batch
from tpuvec.index.bruteforce import bruteforce_knn_internal
from tpuvec.index.graph import (
    GraphState,
    allocate,
    config_for,
    prepare_vectors,
)
from tpuvec.index.params import HnswParams
from tpuvec.index.search import search_graph
from tpuvec.ops.distance import internal_to_output
from tpuvec.types import (
    DimensionMismatch,
    DistanceMetric,
    IndexQuantization,
    IndexType,
    InvalidParameter,
    InvalidState,
    InvalidVectorFormat,
    VectorType,
)
from tpuvec.utils.device import device_share
from tpuvec.utils.prng import sample_levels_np
from tpuvec.utils import timing

__all__ = ["VecTable", "ColumnSpec", "QueryResult"]

_FLUSH_THRESHOLD = 256


def _shadow_budget_bytes() -> int:
    """Device budget for the f32 rerank shadow: 6/16 of the card's memory
    limit, 6 GB where the backend reports none. TPUVEC_SHADOW_BUDGET_MB
    overrides it."""
    import os

    env = os.environ.get("TPUVEC_SHADOW_BUDGET_MB")
    if env is not None:
        return int(env) * (1 << 20)
    return device_share(6 / 16, 6144 * (1 << 20))


@jax.jit
def _shadow_scatter(shadow, ids, vals):
    return shadow.at[ids].set(vals, mode="drop")


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One column declaration (reference ColumnDef, src/vtab.rs)."""

    name: str
    kind: str  # "vector" | "metadata" | "aux" | "partition"
    # vector-only fields
    vec_type: VectorType | None = None
    dimensions: int = 0
    metric: DistanceMetric = DistanceMetric.COSINE  # vtab default, vtab.rs:240-249
    hnsw: bool = False
    params: HnswParams | None = None
    quantization: IndexQuantization = IndexQuantization.NONE

    @classmethod
    def vector(
        cls,
        name: str,
        dimensions: int,
        *,
        vec_type: VectorType = VectorType.FLOAT32,
        metric: DistanceMetric = DistanceMetric.COSINE,
        hnsw: bool = True,
        params: HnswParams | None = None,
        quantization: IndexQuantization = IndexQuantization.NONE,
    ) -> "ColumnSpec":
        return cls(
            name=name,
            kind="vector",
            vec_type=vec_type,
            dimensions=dimensions,
            metric=metric,
            hnsw=hnsw,
            params=params,
            quantization=quantization,
        )

    @classmethod
    def metadata(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="metadata")

    @classmethod
    def aux(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="aux")

    @classmethod
    def partition_key(cls, name: str) -> "ColumnSpec":
        return cls(name=name, kind="partition")


@dataclasses.dataclass
class QueryResult:
    rowid: int
    distance: float
    values: dict[str, Any]


class _ScalarColumn:
    """Columnar scalar storage: values interned to int32 codes per slot.

    Equality filters (partition keys, metadata) become ONE vectorized
    compare over the codes array — the device-mask design SURVEY §7 step 8
    prescribes — instead of a per-rowid Python loop. Values must be
    hashable (the reference's metadata columns hold SQL scalars,
    src/vtab.rs:854-885).
    """

    def __init__(self, cap: int):
        self.codes = np.full(cap, -1, dtype=np.int32)  # -1 = NULL/absent
        self.values: list[Any] = []
        self._code_of: dict[Any, int] = {}

    def set(self, slot: int, value) -> None:
        if value is None:
            self.codes[slot] = -1
            return
        try:
            code = self._code_of.get(value)
        except TypeError:
            raise InvalidParameter(
                f"scalar column values must be hashable, got {type(value).__name__}"
            ) from None
        if code is None:
            code = len(self.values)
            self.values.append(value)
            self._code_of[value] = code
        self.codes[slot] = code

    def get(self, slot: int):
        c = self.codes[slot]
        return None if c < 0 else self.values[c]

    def clear(self, slot: int) -> None:
        self.codes[slot] = -1

    def mask_eq(self, value) -> np.ndarray:
        """Vectorized equality mask over all slots."""
        if value is None:
            return self.codes == -1
        try:
            code = self._code_of.get(value, -2)  # unseen value matches nothing
        except TypeError:
            return np.zeros_like(self.codes, dtype=bool)
        return self.codes == code

    def grow(self, new_cap: int) -> None:
        codes = np.full(new_cap, -1, dtype=np.int32)
        codes[: self.codes.shape[0]] = self.codes
        self.codes = codes


class _VectorColumn:
    """Device-side state for one vector column."""

    def __init__(self, spec: ColumnSpec, cap: int, index_type: IndexType):
        self.spec = spec
        self.params = spec.params or HnswParams()
        self.has_hnsw = spec.hnsw and index_type is IndexType.HNSW
        self.config = config_for(
            spec.dimensions,
            metric=spec.metric,
            vec_type=spec.vec_type or VectorType.FLOAT32,
            quantization=spec.quantization,
            params=self.params,
            cap=cap,
        )
        # main store keeps originals (padded); graph keeps the index copy
        self.raw = np.zeros(
            (self.config.cap, _raw_width(spec)), dtype=_raw_dtype(spec)
        )
        self.state: GraphState = allocate(self.config)
        # device-resident originals for exact rerank after a coarse
        # quantized search (ops/rerank.py) — only when the f32 copy fits
        # the device budget; otherwise rerank falls back to the host path
        self.shadow: jnp.ndarray | None = None
        if (
            spec.quantization is IndexQuantization.BINARY
            and spec.vec_type is VectorType.FLOAT32
            and self.config.cap * spec.dimensions * 4 <= _shadow_budget_bytes()
        ):
            self.shadow = jnp.zeros(
                (self.config.cap, spec.dimensions), jnp.float32
            )

    @property
    def slots_cap(self) -> int:
        return self.config.cap

    def refresh_shadow(self) -> None:
        """(Re)build the rerank shadow from the host originals, or drop it
        if the column no longer qualifies / fits the budget."""
        if (
            self.spec.quantization is IndexQuantization.BINARY
            and self.spec.vec_type is VectorType.FLOAT32
            and self.config.cap * self.spec.dimensions * 4
            <= _shadow_budget_bytes()
        ):
            self.shadow = jnp.asarray(self.raw, dtype=jnp.float32)
        else:
            self.shadow = None

    def update_shadow(self, slots: np.ndarray, raws: np.ndarray) -> None:
        """Scatter freshly-inserted originals into the device shadow.
        Rows are padded to a power of two to bound jit shapes."""
        if self.shadow is None:
            return
        n = len(slots)
        p = 1 << max(n - 1, 0).bit_length()
        ids = np.full(p, self.config.cap, dtype=np.int32)  # pad rows dropped
        ids[:n] = slots
        vals = np.zeros((p, raws.shape[1]), dtype=np.float32)
        vals[:n] = raws
        self.shadow = _shadow_scatter(
            self.shadow, jnp.asarray(ids), jnp.asarray(vals)
        )

    def grow(self, new_cap: int) -> None:
        """Double capacity: re-pad every array; graph state carries over
        (adjacency/ids are slot indices, unaffected by a larger cap)."""
        old = self.config
        self.config = dataclasses.replace(
            self.config, cap=new_cap, cap_u=max(new_cap // 8, 128)
        )
        c = self.config
        raw = np.zeros((c.cap, self.raw.shape[1]), dtype=self.raw.dtype)
        raw[: self.raw.shape[0]] = self.raw
        self.raw = raw
        s = self.state

        def pad_rows(a, rows, fill):
            out = jnp.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
            return out.at[: a.shape[0]].set(a)

        self.state = GraphState(
            vectors=pad_rows(s.vectors, c.cap, 0),
            adj0=pad_rows(s.adj0, c.cap, -1),
            adj0_dist=pad_rows(s.adj0_dist, c.cap, jnp.inf),
            levels=pad_rows(s.levels, c.cap, -1),
            upper_slot=pad_rows(s.upper_slot, c.cap, -1),
            upper_nodes=pad_rows(s.upper_nodes, c.cap_u, -1),
            upper_adj=pad_rows(s.upper_adj, c.cap_u, -1),
            upper_dist=pad_rows(s.upper_dist, c.cap_u, jnp.inf),
            entry_point=s.entry_point,
            entry_level=s.entry_level,
            count=s.count,
            upper_count=s.upper_count,
        )
        del old
        if self.shadow is not None:
            self.shadow = None  # free the old copy before re-padding
            self.refresh_shadow()


class _MeshVectorColumn:
    """Device-mesh-backed vector column: the sub-index per shard design
    (tpuvec/parallel/sharding.py) behind the VecTable product surface.

    Table slots ARE the sharded index's global ids (shard * cap + local),
    so the host-side live mask / scalar code arrays reshape to [S, cap]
    per-shard masks for filtered and exact sharded search.
    """

    def __init__(self, spec: ColumnSpec, total_cap: int, index_type: IndexType, mesh):
        from tpuvec.parallel.sharding import ShardedHnsw

        self.spec = spec
        self.params = spec.params or HnswParams()
        self.has_hnsw = spec.hnsw and index_type is IndexType.HNSW
        self.mesh = mesh
        n_shards = mesh.devices.size
        self.idx = ShardedHnsw(
            mesh,
            spec.dimensions,
            metric=spec.metric,
            params=self.params,
            cap_per_shard=max(-(-total_cap // n_shards), 128),
            quantization=spec.quantization,
            vec_type=spec.vec_type or VectorType.FLOAT32,
        )
        self.config = self.idx.config
        self.raw = np.zeros(
            (self.slots_cap, _raw_width(spec)), dtype=_raw_dtype(spec)
        )

    @property
    def slots_cap(self) -> int:
        return self.idx.n_shards * self.config.cap

    def grow(self, new_total_cap: int) -> None:
        """Grow per-shard capacity in place (sub-graphs carry over). The
        caller (VecTable._grow_mesh) must remap global slot ids:
        old (s, sl) -> s * new_cap + sl."""
        old_cap = self.config.cap
        self.idx.grow(-(-new_total_cap // self.idx.n_shards))
        self.config = self.idx.config
        new_cap = self.config.cap
        if new_cap == old_cap:
            return
        s_n, w = self.idx.n_shards, self.raw.shape[1]
        raw = np.zeros((s_n * new_cap, w), dtype=self.raw.dtype)
        raw.reshape(s_n, new_cap, w)[:, :old_cap] = self.raw.reshape(
            s_n, old_cap, w
        )
        self.raw = raw

    # --- allocation (delegated to the sharded index) ------------------- #

    def alloc_slot(self, part_value, rr: int) -> int:
        if part_value is not None:
            shard = self.idx.shard_of_partition(part_value)
        else:
            shard = rr % self.idx.n_shards
        local = self.idx._alloc_slot(shard)
        if part_value is not None:
            self.idx._part_codes[shard, local] = self.idx._intern_partition(
                part_value
            )
        return shard * self.config.cap + local

    def free_slot_count(self) -> int:
        return sum(len(f) for f in self.idx._free)

    # --- data paths ----------------------------------------------------- #

    def insert_prepared(
        self, slots: np.ndarray, prepared: np.ndarray, batch: int, start: int = 1
    ):
        cap = self.config.cap
        per_shard: list[list[int]] = [[] for _ in range(self.idx.n_shards)]
        local = np.empty(len(slots), dtype=np.int64)
        for row, g in enumerate(slots):
            s, sl = divmod(int(g), cap)
            per_shard[s].append(row)
            local[row] = sl
        self.idx._insert_rows(per_shard, local, prepared, batch, start=start)

    def delete_slots(self, slots) -> None:
        self.idx.delete(np.asarray(slots, dtype=np.int64))

    def exact(self, qp, k, valid: np.ndarray):
        from tpuvec.parallel.sharding import _sharded_exact

        v = jnp.asarray(valid.reshape(self.idx.n_shards, self.config.cap))
        return _sharded_exact(
            self.config, self.mesh, self.idx.stacked, qp, v, k=k
        )

    def hnsw(self, qp, k, ef, mask: np.ndarray | None):
        from tpuvec.parallel.sharding import _sharded_search

        m = (
            None
            if mask is None
            else jnp.asarray(mask.reshape(self.idx.n_shards, self.config.cap))
        )
        return _sharded_search(
            self.config, self.mesh, self.idx.stacked, qp, k=k, ef=ef, mask=m
        )


def _raw_dtype(spec: ColumnSpec):
    vt = spec.vec_type
    if vt is VectorType.FLOAT32:
        return np.float32
    if vt is VectorType.INT8:
        return np.int8
    return np.uint8  # BIT: packed bytes


def _raw_width(spec: ColumnSpec) -> int:
    if spec.vec_type is VectorType.BIT:
        return (spec.dimensions + 7) // 8
    return spec.dimensions


class VecTable:
    """A typed vector table with per-column HNSW indexes.

    >>> t = VecTable("docs", [ColumnSpec.vector("emb", 128, metric=DistanceMetric.L2)])
    >>> t.insert({"emb": [0.0] * 128})
    1
    >>> t.knn("emb", [0.0] * 128, k=1)[0].rowid
    1
    """

    def __init__(
        self,
        name: str,
        columns: Sequence[ColumnSpec],
        *,
        index_type: IndexType = IndexType.HNSW,
        initial_cap: int = 1024,
        mesh=None,
        autosave_path: str | None = None,
        autosave_every: int = 16,
    ):
        if not any(c.kind == "vector" for c in columns):
            raise InvalidParameter("vec0 table requires at least one vector column")
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise InvalidParameter("duplicate column name")
        self.name = name
        self.columns = list(columns)
        self.index_type = index_type
        self.mesh = mesh
        if mesh is not None:
            vcols = [c for c in columns if c.kind == "vector"]
            if len(vcols) != 1:
                raise InvalidParameter(
                    "mesh-backed tables support exactly one vector column"
                )
            self.vector_cols = {
                vcols[0].name: _MeshVectorColumn(
                    vcols[0], initial_cap, index_type, mesh
                )
            }
        else:
            self.vector_cols = {
                c.name: _VectorColumn(c, initial_cap, index_type)
                for c in columns
                if c.kind == "vector"
            }
        self._rr = 0  # round-robin shard pointer (mesh mode)
        self.scalar_cols = [c for c in columns if c.kind != "vector"]
        self.partition_col = next(
            (c.name for c in columns if c.kind == "partition"), None
        )
        # host-side row storage
        self._rowid_to_slot: dict[int, int] = {}
        self._slot_to_rowid: dict[int, int] = {}
        self._scalars: dict[str, _ScalarColumn] = {
            c.name: _ScalarColumn(self.cap) for c in self.scalar_cols
        }
        self._live = np.zeros(self.cap, dtype=bool)  # slot occupancy
        self._version = 0  # bumped on every mutation (SQL mirror cache key)
        self._next_slot = 0
        self._free_slots: list[int] = []
        self._max_rowid = 0
        self._pending: list[tuple[int, int, dict[str, Vector]]] = []
        self._lock = threading.RLock()
        # opt-in durability: write-behind atomic snapshot every N flushes
        # (the reference persists every committed insert via SQLite shadow
        # tables, src/shadow.rs:192-257; here device memory is authoritative and the
        # snapshot is the crash-consistency tier — a kill -9 loses at most
        # the rows since the last completed autosave)
        self.autosave_path = autosave_path
        self.autosave_every = max(1, int(autosave_every))
        self._flushes_since_save = 0
        self._autosave_thread: threading.Thread | None = None
        # device-side copies of the live mask / scalar code arrays, keyed
        # by (_version, cap): repeated filtered queries reuse one upload
        # instead of transferring a fresh host mask per call (the
        # host-to-device copy dominates single-tenant lookups otherwise)
        self._dev_cache: dict[Any, tuple[tuple[int, int], jnp.ndarray]] = {}

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #

    @property
    def cap(self) -> int:
        return next(iter(self.vector_cols.values())).slots_cap

    def __len__(self) -> int:
        with self._lock:
            return len(self._rowid_to_slot)  # pending rows are mapped already

    def next_rowid(self) -> int:
        """Auto rowid = max + 1 (reference src/shadow.rs:888-900)."""
        return self._max_rowid + 1

    def _decode_vector(self, col: ColumnSpec, value) -> Vector:
        if isinstance(value, Vector):
            v = value
        elif isinstance(value, (list, tuple, np.ndarray)):
            arr = np.asarray(value)
            if col.vec_type is VectorType.FLOAT32:
                v = Vector.from_f32(arr)
            elif col.vec_type is VectorType.INT8:
                v = Vector.from_i8(arr)
            else:
                v = Vector.from_bits(arr)
        else:
            v = Vector.from_sql_value(value, col.vec_type)
        if v.dimensions != col.dimensions:
            raise DimensionMismatch(col.dimensions, v.dimensions)
        if v.vec_type is not col.vec_type:
            raise InvalidVectorFormat(
                f"column '{col.name}' expects {col.vec_type.value}, got {v.vec_type.value}"
            )
        return v

    def _alloc_slot(self, part_value=None) -> int:
        if self.mesh is not None:
            from tpuvec.parallel.sharding import ShardFullError

            vc = next(iter(self.vector_cols.values()))
            try:
                slot = vc.alloc_slot(part_value, self._rr)
            except ShardFullError:
                self._grow_mesh()
                slot = vc.alloc_slot(part_value, self._rr)
            if part_value is None:
                self._rr += 1
            return slot
        if self._free_slots:
            return self._free_slots.pop()
        s = self._next_slot
        self._next_slot += 1
        return s

    def _grow_mesh(self) -> None:
        """Double a mesh-backed table's capacity in place. Per-shard
        sub-graphs carry over (adjacency is local-slot-indexed); global
        slot ids change meaning (shard * cap + slot), so every host-side
        slot reference is remapped here."""
        vc = next(iter(self.vector_cols.values()))
        s_n = vc.idx.n_shards
        old_cap = vc.config.cap
        vc.grow(self.cap * 2)
        new_cap = vc.config.cap
        if new_cap == old_cap:
            raise InvalidState("mesh capacity growth failed to enlarge")

        def remap(g: int) -> int:
            s, sl = divmod(int(g), old_cap)
            return s * new_cap + sl

        self._rowid_to_slot = {
            r: remap(g) for r, g in self._rowid_to_slot.items()
        }
        self._slot_to_rowid = {v: k for k, v in self._rowid_to_slot.items()}
        self._free_slots = [remap(g) for g in self._free_slots]
        self._pending = [
            (rid, remap(slot), vecs) for rid, slot, vecs in self._pending
        ]
        live = np.zeros(s_n * new_cap, dtype=bool)
        live.reshape(s_n, new_cap)[:, :old_cap] = self._live[
            : s_n * old_cap
        ].reshape(s_n, old_cap)
        self._live = live
        for sc in self._scalars.values():
            codes = np.full(s_n * new_cap, -1, dtype=np.int32)
            codes.reshape(s_n, new_cap)[:, :old_cap] = sc.codes[
                : s_n * old_cap
            ].reshape(s_n, old_cap)
            sc.codes = codes

    def _grow_host(self, needed: int) -> None:
        """Grow host-side slot arrays (live mask, scalar columns)."""
        size = self._live.shape[0]
        if needed <= size:
            return
        while size < needed:
            size *= 2
        live = np.zeros(size, dtype=bool)
        live[: self._live.shape[0]] = self._live
        self._live = live
        for sc in self._scalars.values():
            sc.grow(size)

    def _ensure_capacity(self) -> None:
        needed = self._next_slot
        cap = self.cap
        if needed < cap:
            return
        new_cap = cap
        while new_cap <= needed:
            new_cap *= 2
        for vc in self.vector_cols.values():
            vc.grow(new_cap)
        self._grow_host(new_cap)

    # ------------------------------------------------------------------ #
    # write path (reference src/vtab.rs:1409-2016)
    # ------------------------------------------------------------------ #

    def insert(self, values: Mapping[str, Any], rowid: int | None = None) -> int:
        """Insert one row; returns its rowid."""
        with self._lock:
            if rowid is None:
                rowid = self.next_rowid()
            rowid = int(rowid)
            if rowid in self._rowid_to_slot or any(
                p[0] == rowid for p in self._pending
            ):
                raise InvalidState(f"rowid {rowid} already exists")

            vecs: dict[str, Vector] = {}
            for cname, vc in self.vector_cols.items():
                if cname not in values or values[cname] is None:
                    raise InvalidParameter(f"missing vector for column '{cname}'")
                vecs[cname] = self._decode_vector(vc.spec, values[cname])

            part = (
                values.get(self.partition_col)
                if self.partition_col is not None
                else None
            )
            slot = self._alloc_slot(part)
            if slot >= self._live.shape[0]:
                self._grow_host(slot + 1)
            for c in self.scalar_cols:
                if c.name in values:
                    self._scalars[c.name].set(slot, values[c.name])
            self._live[slot] = True
            self._version += 1
            self._pending.append((rowid, slot, vecs))
            self._rowid_to_slot[rowid] = slot
            self._slot_to_rowid[slot] = rowid
            self._max_rowid = max(self._max_rowid, rowid)
            if len(self._pending) >= _FLUSH_THRESHOLD:
                self.flush()
            return rowid

    def insert_many(
        self, rows: Iterable[Mapping[str, Any]], rowids: Sequence[int] | None = None
    ) -> list[int]:
        out = []
        for i, row in enumerate(rows):
            rid = None if rowids is None else rowids[i]
            out.append(self.insert(row, rowid=rid))
        self.flush()
        return out

    def flush(self) -> None:
        """Push buffered inserts into the device indexes.

        Inserts go in mini-batches no larger than the graph they land in
        (doubling schedule — batch members don't see each other, so an
        unbounded batch into a small graph would leave nodes isolated),
        padded to one of two fixed shapes (16 / _FLUSH_THRESHOLD) so jit
        compiles at most two insert programs per config."""
        with self._lock, timing.timer("table.flush"):
            if not self._pending:
                return
            pend = self._pending
            self._pending = []
            self._ensure_capacity()
            slots = np.array([p[1] for p in pend], dtype=np.int32)
            graph_size = len(self._rowid_to_slot) - len(pend)
            for cname, vc in self.vector_cols.items():
                raws = np.stack([p[2][cname].to_numpy() for p in pend])
                if vc.spec.vec_type is VectorType.BIT:
                    raws = pack_bits(raws)
                vc.raw[slots] = raws
                if isinstance(vc, _VectorColumn):
                    vc.update_shadow(slots, raws)
                prepared = self._prepare_batch(vc, pend)
                if isinstance(vc, _MeshVectorColumn):
                    vc.insert_prepared(
                        slots,
                        prepared,
                        batch=_FLUSH_THRESHOLD,
                        start=max(1, graph_size // vc.idx.n_shards),
                    )
                    continue
                pos, size = 0, graph_size
                while pos < len(pend):
                    take = min(max(size, 1), _FLUSH_THRESHOLD, len(pend) - pos)
                    nb = 16 if take <= 16 else _FLUSH_THRESHOLD
                    ids = np.full(nb, -1, dtype=np.int32)
                    ids[:take] = slots[pos : pos + take]
                    pv = np.zeros((nb, prepared.shape[1]), dtype=prepared.dtype)
                    pv[:take] = prepared[pos : pos + take]
                    levels = sample_levels_np(
                        np.maximum(ids, 0),
                        vc.config.rng_seed,
                        vc.config.level_factor,
                        vc.config.lu,
                    )
                    vc.state = insert_batch(
                        vc.config,
                        vc.state,
                        jnp.asarray(ids),
                        jnp.asarray(pv),
                        jnp.asarray(levels),
                    )
                    pos += take
                    size += take
            if self.autosave_path is not None:
                self._flushes_since_save += 1
                if self._flushes_since_save >= self.autosave_every:
                    self._maybe_autosave()

    def _maybe_autosave(self) -> None:
        """Write-behind snapshot: a daemon thread takes the table lock and
        writes the atomic snapshot (tmp + rename, so a crash mid-save keeps
        the previous one). If a save is already in flight this trigger
        folds into the next — loss bound stays ~N flushes + one save."""
        t = self._autosave_thread
        if t is not None and t.is_alive():
            return
        self._flushes_since_save = 0

        def run():
            from tpuvec.store import snapshot

            with self._lock:
                snapshot.save(self, self.autosave_path)

        t = threading.Thread(
            target=run, daemon=True, name=f"tpuvec-autosave-{self.name}"
        )
        self._autosave_thread = t
        t.start()

    def wait_autosave(self) -> None:
        """Block until any in-flight autosave completes (tests/shutdown)."""
        t = self._autosave_thread
        if t is not None:
            t.join()

    def _prepare_batch(self, vc: _VectorColumn, pend) -> np.ndarray:
        c = vc.config
        if vc.spec.vec_type is VectorType.BIT:
            words_w = -(-c.dim // 32)
            words = np.zeros((len(pend), words_w), dtype=np.uint32)
            for i, (_, _, vecs) in enumerate(pend):
                bits = vecs[vc.spec.name].as_bits()
                padded = np.zeros(words_w * 32, dtype=np.uint8)
                padded[: bits.size] = bits
                words[i] = np.asarray(
                    pack_bits(padded).view(np.uint8)
                ).view("<u4")
            return np.asarray(prepare_vectors(c, jnp.asarray(words)))
        arr = np.stack([p[2][vc.spec.name].to_numpy() for p in pend]).astype(
            np.float32 if vc.spec.vec_type is VectorType.FLOAT32 else np.int8
        )
        return np.asarray(prepare_vectors(c, jnp.asarray(arr)))

    def delete(self, rowid: int) -> None:
        self.delete_many([rowid])

    def delete_many(self, rowids: Sequence[int]) -> None:
        with self._lock:
            self.flush()
            slots = []
            for rid in rowids:
                rid = int(rid)
                if rid not in self._rowid_to_slot:
                    raise InvalidState(f"rowid {rid} not found")
                s = self._rowid_to_slot.pop(rid)
                del self._slot_to_rowid[s]
                for col in self._scalars.values():
                    col.clear(s)
                self._live[s] = False
                self._version += 1
                slots.append(s)
                if self.mesh is None:
                    self._free_slots.append(s)
            if not slots:
                return
            if self.mesh is not None:
                for vc in self.vector_cols.values():
                    vc.delete_slots(slots)
                return
            nb = 16 if len(slots) <= 16 else -(-len(slots) // 256) * 256
            ids = np.full(nb, -1, dtype=np.int32)
            ids[: len(slots)] = slots
            for vc in self.vector_cols.values():
                vc.state = delete_ids(vc.config, vc.state, jnp.asarray(ids))

    def update(self, rowid: int, values: Mapping[str, Any]) -> None:
        """Update vector and/or scalar columns for an existing rowid
        (reference: delete node + re-insert, src/vtab.rs:1860-2016)."""
        self.update_many([rowid], [values])

    def update_many(
        self, rowids: Sequence[int], values_list: Sequence[Mapping[str, Any]]
    ) -> None:
        """Bulk update: ONE batched delete dispatch + batched re-inserts
        (per-row update would cost a delete-program + insert-program per
        row; the reference batches the same way inside a transaction)."""
        if len(rowids) != len(values_list):
            raise InvalidParameter("rowids/values length mismatch")
        if not rowids:
            return
        with self._lock:
            self.flush()
            rids = [int(r) for r in rowids]
            merged = []
            for rid, values in zip(rids, values_list):
                if rid not in self._rowid_to_slot:
                    raise InvalidState(f"rowid {rid} not found")
                old = self.row(rid)
                merged.append({**old, **dict(values)})
            self.delete_many(rids)
            self.insert_many(merged, rowids=rids)

    # ------------------------------------------------------------------ #
    # read path (reference src/vtab.rs:2084-2482)
    # ------------------------------------------------------------------ #

    def row(self, rowid: int) -> dict[str, Any]:
        """Read one row's stored values (originals, like column()
        reading from _data, src/vtab.rs:2341-2482)."""
        with self._lock:
            self.flush()
            rowid = int(rowid)
            if rowid not in self._rowid_to_slot:
                raise InvalidState(f"rowid {rowid} not found")
            slot = self._rowid_to_slot[rowid]
            out: dict[str, Any] = {}
            for cname, vc in self.vector_cols.items():
                raw = vc.raw[slot]
                if vc.spec.vec_type is VectorType.BIT:
                    out[cname] = Vector.from_blob(
                        raw.tobytes(), VectorType.BIT, vc.spec.dimensions
                    )
                elif vc.spec.vec_type is VectorType.INT8:
                    out[cname] = Vector.from_i8(raw[: vc.spec.dimensions])
                else:
                    out[cname] = Vector.from_f32(raw[: vc.spec.dimensions])
            for c in self.scalar_cols:
                out[c.name] = self._scalars[c.name].get(slot)
            return out

    def _filter_mask(
        self, partition=None, predicate=None, filters=None
    ) -> np.ndarray | None:
        """Validity mask over slots from partition / metadata filters.

        Partition and equality ``filters`` are single vectorized compares
        over the interned code arrays (no per-row Python); an arbitrary
        ``predicate`` callable falls back to a loop over live rows only.
        """
        if partition is None and predicate is None and not filters:
            return None
        cap = self.cap
        mask = self._live[:cap].copy()
        if partition is not None:
            if self.partition_col is None:
                raise InvalidParameter("table has no partition key column")
            mask &= self._scalars[self.partition_col].mask_eq(partition)[:cap]
        if filters:
            for col, val in filters.items():
                if col not in self._scalars:
                    raise InvalidParameter(f"'{col}' is not a scalar column")
                mask &= self._scalars[col].mask_eq(val)[:cap]
        if predicate is not None:
            for slot in np.nonzero(mask)[0]:
                rid = self._slot_to_rowid[int(slot)]
                vals = {
                    c.name: self._scalars[c.name].get(int(slot))
                    for c in self.scalar_cols
                }
                if not predicate(rid, vals):
                    mask[slot] = False
        return mask

    def knn(
        self,
        column: str,
        query,
        *,
        k: int,
        ef: int | None = None,
        partition=None,
        predicate=None,
        filters: Mapping[str, Any] | None = None,
        exact: bool | None = None,
        coarse_k: int | None = None,
        expand: bool | None = None,
    ) -> list[QueryResult]:
        """k nearest neighbors on a vector column.

        Equivalent of `WHERE col MATCH ? AND k = ?` (src/vtab.rs:2084-2330).
        `exact=True` forces the ENN brute-force scan; default follows the
        column's index type. `partition` / `filters` (vectorized equality)
        / `predicate` (arbitrary callable) filter results — the capability
        the reference's PARTITION KEY parser promises but never implements
        (src/vtab.rs:2479-2480).
        """
        return self.knn_many(
            column,
            [query],
            k=k,
            ef=ef,
            partition=partition,
            predicate=predicate,
            filters=filters,
            exact=exact,
            coarse_k=coarse_k,
            expand=expand,
        )[0]

    def knn_many(
        self,
        column: str,
        queries: Sequence,
        *,
        k: int,
        ef: int | None = None,
        partition=None,
        predicate=None,
        filters: Mapping[str, Any] | None = None,
        exact: bool | None = None,
        coarse_k: int | None = None,
        expand: bool | None = None,
    ) -> list[list[QueryResult]]:
        """Batched k-NN: B queries in one device dispatch.

        The device search is batched end to end; this is the table-level
        surface for it.
        Queries are padded to a power-of-two batch so jit compiles one
        program per bucket.

        `partition` may also be a sequence of length ``len(queries)`` —
        one partition value PER QUERY — which runs all B single-tenant
        lookups as one device dispatch (multi-tenant serving shape). The
        per-query form always uses the exact masked scan: at typical
        tenant selectivity (corpus/tenants rows each) that is the plan the
        scalar path would pick anyway, and the in-kernel code compare is
        cheap beside the distance tile.
        """
        with self._lock, timing.timer("table.knn"):
            self.flush()
            if column not in self.vector_cols:
                raise InvalidParameter(f"'{column}' is not a vector column")
            vc = self.vector_cols[column]
            if k <= 0:
                raise InvalidParameter("k must be positive")
            nq = len(queries)
            if nq == 0:
                return []
            qvs = [self._decode_vector(vc.spec, q) for q in queries]
            qp = self._prepare_query_batch(vc, qvs)

            if (
                partition is not None
                and isinstance(partition, (list, tuple, np.ndarray))
                and not isinstance(partition, (str, bytes))
                and len(partition) == nq
            ):
                if self.partition_col is None:
                    raise InvalidParameter(
                        "table has no partition key column"
                    )
                if isinstance(vc, _MeshVectorColumn):
                    raise InvalidParameter(
                        "per-query partitions are not supported on "
                        "mesh-backed tables; loop over knn(partition=...)"
                    )
                if (
                    vc.spec.quantization is IndexQuantization.BINARY
                    and vc.spec.vec_type is VectorType.FLOAT32
                ):
                    raise InvalidParameter(
                        "per-query partitions are not supported on "
                        "binary+rerank columns; loop over knn(partition=...)"
                    )
                mask = self._filter_mask(None, predicate, filters)
                d, i = self._exact_coded(vc, qp, k, partition, mask)
                return self._collect_results(d, i, nq, k)

            if (
                partition is not None
                and predicate is None
                and not filters
                and not isinstance(vc, _MeshVectorColumn)
                and not (
                    vc.spec.quantization is IndexQuantization.BINARY
                    and vc.spec.vec_type is VectorType.FLOAT32
                )
            ):
                # scalar-partition fast path: selective tenants go through
                # the in-kernel code compare with version-cached device
                # arrays — per call only the query batch and a B-int code
                # vector go to the device (vs a fresh cap-size mask upload
                # per call)
                if self.partition_col is None:
                    raise InvalidParameter(
                        "table has no partition key column"
                    )
                sc = self._scalars[self.partition_col]
                pm = sc.mask_eq(partition)[: self.cap]
                n_match = int(np.count_nonzero(pm & self._live[: self.cap]))
                want_exact = exact if exact is not None else not vc.has_hnsw
                if want_exact or n_match <= 50 * k:
                    d, i = self._exact_coded(
                        vc, qp, k, [partition] * nq, None
                    )
                    return self._collect_results(d, i, nq, k)

            mask = self._filter_mask(partition, predicate, filters)
            use_exact = exact if exact is not None else not vc.has_hnsw

            if (
                vc.spec.quantization is IndexQuantization.BINARY
                and vc.spec.vec_type is VectorType.FLOAT32
            ):
                d, i = self._binary_rerank(
                    vc, qvs, qp, k, mask, use_exact, coarse_k, expand
                )
            elif use_exact or mask is not None and not vc.has_hnsw:
                d, i = self._exact(vc, qp, k, mask)
            elif mask is not None:
                # HNSW + filter: in-beam filtered search (the beam
                # traverses the full graph; a device-side result buffer
                # collects mask-passing nodes). Very selective filters go
                # straight to the exact masked scan — the beam would visit
                # too few matches to fill k anyway.
                n_match = int(mask.sum())
                if n_match <= 50 * k:
                    d, i = self._exact(vc, qp, k, mask)
                else:
                    d, i = self._hnsw(vc, qp, k, ef, mask)
                    if (np.asarray(i)[:nq] >= 0).sum(axis=1).min() < min(
                        k, n_match
                    ):
                        d, i = self._exact(vc, qp, k, mask)
            else:
                d, i = self._hnsw(vc, qp, k, ef)

            return self._collect_results(d, i, nq, k)

    def _collect_results(self, d, i, nq: int, k: int):
        dn, inn = np.asarray(d), np.asarray(i)
        results: list[list[QueryResult]] = []
        for b in range(nq):
            out = []
            for dist, slot in zip(dn[b], inn[b]):
                if slot < 0 or not np.isfinite(dist):
                    continue
                rid = self._slot_to_rowid.get(int(slot))
                if rid is None:
                    continue
                out.append(QueryResult(rid, float(dist), {}))
                if len(out) >= k:
                    break
            results.append(out)
        return results

    def _prepare_query_batch(
        self, vc: _VectorColumn, qvs: Sequence[Vector]
    ) -> jnp.ndarray:
        """Decode + prepare B queries, padded to a power-of-two batch
        (bounded set of jit shapes; padding rows are zeros)."""
        c = vc.config
        b = len(qvs)
        bp = 1 << max(b - 1, 0).bit_length()
        if vc.spec.vec_type is VectorType.BIT:
            words_w = -(-c.dim // 32)
            words = np.zeros((bp, words_w), dtype=np.uint32)
            for i, qv in enumerate(qvs):
                bits = qv.as_bits()
                padded = np.zeros(words_w * 32, dtype=np.uint8)
                padded[: bits.size] = bits
                words[i] = np.asarray(pack_bits(padded)).view("<u4")
            return prepare_vectors(c, jnp.asarray(words))
        arr = np.zeros(
            (bp, c.dim),
            dtype=np.float32 if vc.spec.vec_type is VectorType.FLOAT32 else np.int8,
        )
        for i, qv in enumerate(qvs):
            arr[i] = qv.to_numpy()
        return prepare_vectors(c, jnp.asarray(arr))

    def _dev_cached(self, key, builder) -> jnp.ndarray:
        """Version-keyed device copy of a host array (one upload per
        mutation epoch instead of one per query)."""
        tag = (self._version, self.cap)
        ent = self._dev_cache.get(key)
        if ent is None or ent[0] != tag:
            arr = builder()
            self._dev_cache[key] = (tag, arr)
            return arr
        return ent[1]

    def _exact(self, vc, qp, k, mask):
        c = vc.config
        if isinstance(vc, _MeshVectorColumn):
            valid = self._live[: self.cap]
            if mask is not None:
                valid = valid & mask
            d, i = vc.exact(qp, k, np.asarray(valid))
        else:
            if mask is None:
                valid_dev = self._dev_cached(
                    "live", lambda: jnp.asarray(self._live[: self.cap])
                )
            else:
                valid_dev = jnp.asarray(self._live[: self.cap] & mask)
            d, i = bruteforce_knn_internal(
                qp,
                vc.state.vectors,
                valid_dev,
                metric=c.graph_metric,
                k=k,
                normalized=c.normalized,
            )
        out = internal_to_output(c.metric, d, normalized=c.normalized)
        return jnp.where(jnp.isfinite(d), out, jnp.inf), i

    def _exact_coded(self, vc, qp, k, partitions, mask):
        """Per-query partition-filtered exact scan, one device dispatch.

        Tenant values are interned to int codes host-side; the [B, chunk]
        eligibility compare happens in-kernel against the slot-code array,
        so B different single-tenant lookups cost one batched matmul scan
        (the reference parses PARTITION KEY but never filters,
        src/vtab.rs:2479-2480)."""
        c = vc.config
        sc = self._scalars[self.partition_col]
        qcodes = np.full(qp.shape[0], -2, dtype=np.int32)  # pad rows: none
        for b, v in enumerate(partitions):
            if v is None:
                qcodes[b] = -1  # rows with no partition value
            else:
                try:
                    qcodes[b] = sc._code_of.get(v, -2)  # unseen: none
                except TypeError:
                    qcodes[b] = -2
        if mask is None:
            valid_dev = self._dev_cached(
                "live", lambda: jnp.asarray(self._live[: self.cap])
            )
        else:
            valid_dev = jnp.asarray(self._live[: self.cap] & mask)
        d, i = bruteforce_knn_internal(
            qp,
            vc.state.vectors,
            valid_dev,
            metric=c.graph_metric,
            k=k,
            normalized=c.normalized,
            slot_codes=self._dev_cached(
                ("codes", self.partition_col),
                lambda: jnp.asarray(sc.codes[: self.cap].astype(np.int32)),
            ),
            q_codes=jnp.asarray(qcodes),
        )
        out = internal_to_output(c.metric, d, normalized=c.normalized)
        return jnp.where(jnp.isfinite(d), out, jnp.inf), i

    def _hnsw(self, vc, qp, k, ef, mask=None):
        c = vc.config
        if isinstance(vc, _MeshVectorColumn):
            d, i = vc.hnsw(qp, k, ef, mask)
        else:
            fm = None if mask is None else jnp.asarray(mask)
            d, i = search_graph(c, vc.state, qp, k=k, ef=ef, filter_mask=fm)
        out = internal_to_output(c.metric, d, normalized=c.normalized)
        return jnp.where(jnp.isfinite(d), out, jnp.inf), i

    def _binary_rerank(
        self, vc: _VectorColumn, qvs, qp, k, mask, use_exact, coarse_k=None,
        expand=None,
    ):
        """Binary Hamming coarse search + exact f32 rerank, batched.

        The composition the reference has all the pieces for (bit vectors +
        Hamming + vec_quantize_binary) but never assembles (SURVEY.md §7
        step 7): the index stores mean-threshold sign bits; a Hamming
        search over-fetches `coarse_k` candidates; stored f32 originals
        rerank them in the user metric — all B queries at once.

        ``expand`` adds the candidates' level-0 graph neighbors to the
        rerank pool (ops/rerank.py expand_rerank_topk) — the default when
        the graph + device shadow are available, because Hamming ranking
        hits a recall ceiling the one-hop expansion recovers cheaply.
        """
        # rerank budget: wider coarse_k trades QPS for recall through the
        # Hamming quantization ceiling; callers tune it per query. Default
        # sized so the stock surface clears recall@10 0.95 at 1M x 1024:
        # with the one-hop expansion below, C=96/ef=128 measured 0.9637
        # (without expand the same budget is ~0.85 and C=192 only reaches
        # 0.936 — the expansion is what closes it)
        coarse_k = int(coarse_k) if coarse_k else max(10 * k, 96)
        graph_used = not (
            use_exact
            or not vc.has_hnsw
            or (mask is not None and int(mask.sum()) <= 8 * coarse_k)
        )
        if graph_used:
            d, i = self._hnsw(vc, qp, coarse_k, None, mask)
        else:
            d, i = self._exact(vc, qp, coarse_k, mask)
        nq = len(qvs)
        if getattr(vc, "shadow", None) is not None:
            # device path: candidates never leave the device (ops/rerank.py)
            from tpuvec.ops.rerank import expand_rerank_topk, rerank_topk

            ok_dev = i >= 0
            if mask is not None:
                mdev = jnp.asarray(mask)
                ok_dev = jnp.logical_and(
                    ok_dev, mdev[jnp.clip(i, 0, mask.size - 1)]
                )
            qf_dev = jnp.zeros((i.shape[0], vc.spec.dimensions), jnp.float32)
            qf_dev = qf_dev.at[:nq].set(
                np.stack([qv.as_f32().astype(np.float32) for qv in qvs])
            )
            do_expand = (
                graph_used
                and not isinstance(vc, _MeshVectorColumn)
                if expand is None
                else bool(expand) and not isinstance(vc, _MeshVectorColumn)
            )
            if do_expand:
                fm = self._live[: vc.slots_cap]
                if mask is not None:
                    fm = fm & mask
                out_d, out_i = expand_rerank_topk(
                    vc.shadow, vc.state.adj0, i, ok_dev, qf_dev,
                    metric=vc.spec.metric, k=k,
                    filter_mask=jnp.asarray(fm),
                )
            else:
                out_d, out_i = rerank_topk(
                    vc.shadow, i, ok_dev, qf_dev, metric=vc.spec.metric, k=k
                )
            return np.asarray(out_d)[:nq], np.asarray(out_i)[:nq]
        slots = np.asarray(i)[:nq]  # [nq, C]
        ok = slots >= 0
        if mask is not None:
            ok &= mask[np.clip(slots, 0, mask.size - 1)]
        safe = np.clip(slots, 0, vc.raw.shape[0] - 1)
        # exact rerank on stored originals (vectorized gather; nq x C rows)
        corpus = vc.raw[safe].astype(np.float32)  # [nq, C, D]
        qf = np.stack([qv.as_f32().astype(np.float32) for qv in qvs])  # [nq, D]
        metric = vc.spec.metric
        if metric is DistanceMetric.L2:
            dd = np.sqrt(((corpus - qf[:, None, :]) ** 2).sum(-1))
        elif metric is DistanceMetric.L1:
            dd = np.abs(corpus - qf[:, None, :]).sum(-1)
        else:  # cosine
            cn = np.linalg.norm(corpus, axis=-1)
            qn = np.linalg.norm(qf, axis=-1)[:, None]
            denom = np.maximum(cn * qn, 1e-30)
            dd = 1.0 - np.einsum("bcd,bd->bc", corpus, qf) / denom
        dd = np.where(ok, dd, np.inf)
        order = np.argsort(dd, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(dd, order, 1).astype(np.float32)
        out_i = np.take_along_axis(slots, order, 1).astype(np.int32)
        out_i = np.where(np.isfinite(out_d), out_i, -1)
        return out_d, out_i

    # ------------------------------------------------------------------ #
    # maintenance (reference integrity/rebuild)
    # ------------------------------------------------------------------ #

    def integrity_check(self) -> list[str]:
        """Validate index invariants (reference xIntegrity,
        src/vtab.rs:1264-1322). Returns a list of problems (empty = OK)."""
        with self._lock:
            self.flush()
            problems = []
            n_live = len(self._rowid_to_slot)
            for cname, vc in self.vector_cols.items():
                if isinstance(vc, _MeshVectorColumn):
                    st = vc.idx.stacked
                    counts = np.asarray(st.count)
                    eps = np.asarray(st.entry_point)
                    lv = np.asarray(st.levels)
                    if int(counts.sum()) != n_live:
                        problems.append(
                            f"{cname}: node count {int(counts.sum())} != live rows {n_live}"
                        )
                    for s in range(vc.idx.n_shards):
                        if counts[s] > 0:
                            if eps[s] < 0:
                                problems.append(
                                    f"{cname}: shard {s} missing entry point"
                                )
                            elif lv[s][eps[s]] < 0:
                                problems.append(
                                    f"{cname}: shard {s} entry point {int(eps[s])} is not live"
                                )
                        elif eps[s] >= 0:
                            problems.append(
                                f"{cname}: shard {s} entry point set on empty index"
                            )
                    continue
                st = vc.state
                count = int(st.count)
                if count != n_live:
                    problems.append(
                        f"{cname}: node count {count} != live rows {n_live}"
                    )
                ep = int(st.entry_point)
                if n_live > 0:
                    if ep < 0:
                        problems.append(f"{cname}: missing entry point")
                    elif int(np.asarray(st.levels)[ep]) < 0:
                        problems.append(f"{cname}: entry point {ep} is not live")
                elif ep >= 0:
                    problems.append(f"{cname}: entry point set on empty index")
            return problems

    def rebuild(self, column: str, params: HnswParams | None = None) -> None:
        """Rebuild one column's HNSW index from stored originals
        (reference vec_rebuild_hnsw, src/sql_functions.rs:436-534 and
        rebuild_hnsw_index, src/hnsw/rebuild.rs:20-76)."""
        with self._lock:
            self.flush()
            vc = self.vector_cols[column]
            if params is not None:
                params.validate()
                vc.params = params
            slots = np.array(sorted(self._slot_to_rowid), dtype=np.int32)
            if isinstance(vc, _MeshVectorColumn):
                # fresh sharded index with the same allocation state, then
                # re-insert every live row at its existing slot
                from tpuvec.parallel.sharding import ShardedHnsw

                old = vc.idx
                vc.idx = ShardedHnsw(
                    vc.mesh,
                    vc.spec.dimensions,
                    metric=vc.spec.metric,
                    params=vc.params,
                    cap_per_shard=vc.config.cap,
                    quantization=vc.spec.quantization,
                    vec_type=vc.spec.vec_type or VectorType.FLOAT32,
                )
                vc.config = vc.idx.config
                vc.idx._counts = old._counts
                vc.idx._free = old._free
                vc.idx._part_codes = old._part_codes
                vc.idx._part_list = old._part_list
                vc.idx._part_code_of = old._part_code_of
                vc.idx._rr = old._rr
                if slots.size == 0:
                    return
                pend = [
                    (
                        self._slot_to_rowid[int(s)],
                        int(s),
                        {vc.spec.name: self.row(self._slot_to_rowid[int(s)])[vc.spec.name]},
                    )
                    for s in slots
                ]
                prepared = self._prepare_batch(vc, pend)
                vc.insert_prepared(slots, prepared, batch=_FLUSH_THRESHOLD)
                return
            if params is not None:
                vc.config = config_for(
                    vc.spec.dimensions,
                    metric=vc.spec.metric,
                    vec_type=vc.spec.vec_type,
                    quantization=vc.spec.quantization,
                    params=params,
                    cap=vc.config.cap,
                )
            if slots.size == 0:
                vc.state = allocate(vc.config)
                return
            pend = []
            for s in slots:
                rid = self._slot_to_rowid[int(s)]
                row = self.row(rid)
                pend.append((rid, int(s), {vc.spec.name: row[vc.spec.name]}))
            prepared = self._prepare_batch(vc, pend)
            vc.state = build_graph(vc.config, prepared, ids=slots)
