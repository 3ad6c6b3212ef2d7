"""Corpus sharding over a device mesh.

The reference is single-node: its only sharding concepts are partition keys
(parsed but unimplemented, src/vtab.rs:854-859 + README.md:467) and
thread-per-connection WAL concurrency (tests/test_multithread_stress.rs).
Here the scale-out axis is the device mesh:

* every device holds an independent HNSW sub-index over its slice of the
  corpus (GraphState leaves stacked with a leading shard dim, laid out with
  NamedSharding(P("shard")) so each shard's arrays live on its device);
* inserts route to shards (partition-key affinity when a partition column
  exists — one tenant's rows co-locate, so a filtered query touches one
  shard — otherwise round-robin) and run as one shard_map'd insert_batch:
  every device builds its sub-graph in the same SPMD program;
* queries replicate across the mesh, each shard runs the batched beam
  search locally, and the per-shard top-k merge is a single jnp.top_k over
  the shard axis — XLA lowers the re-layout to an all-gather, which
  runs as an NCCL collective over NVLink between the cards of one host.

Local slot ids map to global ids as shard * cap + slot.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpuvec.index.build import insert_batch, plan_batch_sizes
from tpuvec.index.graph import (
    GraphState,
    HnswConfig,
    allocate,
    config_for,
    prepare_vectors,
)
from tpuvec.index.params import HnswParams
from tpuvec.index.search import search_graph
from tpuvec.ops.distance import internal_to_output
from tpuvec.ops.topk import topk_smallest
from tpuvec.utils.prng import sample_levels, sample_levels_np

__all__ = [
    "ShardedHnsw",
    "ShardFullError",
    "make_mesh",
    "save_sharded",
    "load_sharded",
]

_INF = jnp.float32(jnp.inf)


class ShardFullError(RuntimeError):
    """A shard's slot capacity is exhausted; grow() or raise cap_per_shard."""


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _stack_states(states: list[GraphState]) -> GraphState:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@partial(jax.jit, static_argnames=("config", "mesh", "k", "ef", "n_expand"))
def _sharded_search(
    config: HnswConfig,
    mesh: Mesh,
    stacked: GraphState,
    q: jnp.ndarray,
    *,
    k: int,
    ef: int | None,
    n_expand: int = 1,
    mask: jnp.ndarray | None = None,  # [S, cap] bool, optional filter
):
    """All-shard search + top-k merge. q [B, Dp] replicated."""

    def local(state_s: GraphState, q_l: jnp.ndarray, *mask_s):
        state = jax.tree.map(lambda a: a[0], state_s)  # drop local shard dim
        fm = mask_s[0][0] if mask_s else None
        d, i = search_graph(
            config, state, q_l, k=k, ef=ef, n_expand=n_expand, filter_mask=fm
        )
        shard = jax.lax.axis_index("shard").astype(jnp.int32)
        gi = jnp.where(i >= 0, shard * config.cap + i, -1)
        return d[None], gi[None]

    in_specs = (P("shard"), P()) + ((P("shard"),) if mask is not None else ())
    args = (stacked, q) + ((mask,) if mask is not None else ())
    d, gi = shard_map(
        local,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P("shard"),
        check_vma=False,  # while_loop carries are legitimately unvarying
    )(*args)
    # d, gi: [S, B, k] -> merge over shards (XLA all-gathers via NCCL)
    s, b, _ = d.shape
    d_all = jnp.transpose(d, (1, 0, 2)).reshape(b, s * k)
    i_all = jnp.transpose(gi, (1, 0, 2)).reshape(b, s * k)
    return topk_smallest(d_all, i_all, k)


@partial(jax.jit, static_argnames=("config", "mesh", "k"))
def _sharded_exact(
    config: HnswConfig,
    mesh: Mesh,
    stacked: GraphState,
    q: jnp.ndarray,
    valid: jnp.ndarray,  # [S, cap] bool
    *,
    k: int,
):
    """Exact sharded scan: per-shard tiled-matmul brute force + global
    top-k merge (the ENN path scaled over the mesh, SURVEY §2)."""
    from tpuvec.index.bruteforce import bruteforce_knn_internal

    def local(state_s: GraphState, q_l: jnp.ndarray, valid_s: jnp.ndarray):
        state = jax.tree.map(lambda a: a[0], state_s)
        d, i = bruteforce_knn_internal(
            q_l,
            state.vectors,
            valid_s[0],
            metric=config.graph_metric,
            k=k,
            normalized=config.normalized,
        )
        shard = jax.lax.axis_index("shard").astype(jnp.int32)
        gi = jnp.where(i >= 0, shard * config.cap + i, -1)
        return d[None], gi[None]

    d, gi = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard"), P(), P("shard")),
        out_specs=P("shard"),
        check_vma=False,
    )(stacked, q, valid)
    s, b, _ = d.shape
    d_all = jnp.transpose(d, (1, 0, 2)).reshape(b, s * k)
    i_all = jnp.transpose(gi, (1, 0, 2)).reshape(b, s * k)
    return topk_smallest(d_all, i_all, k)


@partial(jax.jit, static_argnames=("config", "mesh"), donate_argnames=("stacked",))
def _sharded_insert(
    config: HnswConfig,
    mesh: Mesh,
    stacked: GraphState,
    ids: jnp.ndarray,     # [S, nb] local slot ids, -1 pad
    vecs: jnp.ndarray,    # [S, nb, Dp]
    levels: jnp.ndarray,  # [S, nb]
) -> GraphState:
    def local(state_s, ids_l, vecs_l, lv_l):
        state = jax.tree.map(lambda a: a[0], state_s)
        out = insert_batch(config, state, ids_l[0], vecs_l[0], lv_l[0])
        return jax.tree.map(lambda a: a[None], out)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
        out_specs=P("shard"),
        check_vma=False,
    )(stacked, ids, vecs, levels)


@partial(jax.jit, static_argnames=("config", "mesh"), donate_argnames=("stacked",))
def _sharded_delete(
    config: HnswConfig,
    mesh: Mesh,
    stacked: GraphState,
    ids: jnp.ndarray,  # [S, nb] local slot ids, -1 pad
) -> GraphState:
    """shard_map'd delete_ids: every shard scrubs its own sub-graph
    (inbound-edge scrub + entry reselection, index/build.py delete_ids)."""
    from tpuvec.index.build import delete_ids

    def local(state_s, ids_l):
        state = jax.tree.map(lambda a: a[0], state_s)
        out = delete_ids(config, state, ids_l[0])
        return jax.tree.map(lambda a: a[None], out)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard"), P("shard")),
        out_specs=P("shard"),
        check_vma=False,
    )(stacked, ids)


class ShardedHnsw:
    """A partitioned HNSW index across a device mesh.

    >>> mesh = make_mesh()
    >>> idx = ShardedHnsw(mesh, dim=64, metric=DistanceMetric.L2)
    >>> idx.add(vectors, partitions=tenant_ids)
    >>> dists, global_ids = idx.search(queries, k=10)
    """

    def __init__(
        self,
        mesh: Mesh,
        dim: int,
        *,
        metric,
        params: HnswParams | None = None,
        cap_per_shard: int = 4096,
        quantization=None,
        vec_type=None,
    ):
        from tpuvec.types import IndexQuantization, VectorType

        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.devices.size
        self.config = config_for(
            dim,
            metric=metric,
            vec_type=vec_type or VectorType.FLOAT32,
            quantization=quantization or IndexQuantization.NONE,
            params=params,
            cap=cap_per_shard,
        )
        states = [allocate(self.config) for _ in range(self.n_shards)]
        stacked = _stack_states(states)
        sharding = NamedSharding(mesh, P(self.axis))
        self.stacked = jax.tree.map(
            lambda a: jax.device_put(
                a, sharding if a.ndim >= 1 else NamedSharding(mesh, P())
            ),
            stacked,
        )
        self._counts = np.zeros(self.n_shards, dtype=np.int64)  # high-water
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._rr = 0  # round-robin pointer
        # partition value per (shard, slot), interned to int32 codes so a
        # partition filter is one vectorized compare (several tenants can
        # hash to one shard; queries still filter exactly within it)
        self._part_codes = np.full(
            (self.n_shards, self.config.cap), -1, dtype=np.int32
        )
        self._part_list: list = []
        self._part_code_of: dict = {}

    # ---------------------------------------------------------------- #

    def __len__(self) -> int:
        return int(self._counts.sum()) - sum(len(f) for f in self._free)

    def shard_of_partition(self, partition) -> int:
        # stable across processes (Python's hash() is salted per run)
        import zlib

        return zlib.crc32(repr(partition).encode()) % self.n_shards

    def _intern_partition(self, value) -> int:
        code = self._part_code_of.get(value)
        if code is None:
            code = len(self._part_list)
            self._part_list.append(value)
            self._part_code_of[value] = code
        return code

    def _assign(self, n: int, partitions) -> np.ndarray:
        if partitions is not None:
            return np.array(
                [self.shard_of_partition(p) for p in partitions], dtype=np.int64
            )
        out = (np.arange(n) + self._rr) % self.n_shards
        self._rr = int((self._rr + n) % self.n_shards)
        return out

    def _alloc_slot(self, s: int) -> int:
        if self._free[s]:
            return self._free[s].pop()
        slot = int(self._counts[s])
        if slot >= self.config.cap:
            raise ShardFullError(
                f"shard {s} over capacity ({self.config.cap}); "
                "raise cap_per_shard or call grow()"
            )
        self._counts[s] += 1
        return slot

    def grow(self, new_cap_per_shard: int) -> None:
        """Grow per-shard capacity in place: pad every per-shard array
        along the slot axis. Sub-graphs carry over untouched (adjacency
        stores LOCAL slot ids). Global ids change meaning (shard * cap +
        slot): callers holding old global ids must remap them as
        ``(g // old_cap) * new_cap + g % old_cap`` (VecTable does).
        """
        import dataclasses as _dc

        from tpuvec.index.graph import _ceil_to

        old = self.config
        new_cap = max(_ceil_to(new_cap_per_shard, 128), 128)
        if new_cap <= old.cap:
            return
        self.config = _dc.replace(
            self.config,
            cap=new_cap,
            cap_u=max(_ceil_to(new_cap // 8, 128), 128),
        )
        c = self.config
        sharding = NamedSharding(self.mesh, P(self.axis))

        def pad1(a, n, fill):
            ext = jnp.full(
                (a.shape[0], n - a.shape[1]) + a.shape[2:], fill, dtype=a.dtype
            )
            return jax.device_put(jnp.concatenate([a, ext], axis=1), sharding)

        s = self.stacked
        self.stacked = GraphState(
            vectors=pad1(s.vectors, c.cap, 0),
            adj0=pad1(s.adj0, c.cap, -1),
            adj0_dist=pad1(s.adj0_dist, c.cap, jnp.inf),
            levels=pad1(s.levels, c.cap, -1),
            upper_slot=pad1(s.upper_slot, c.cap, -1),
            upper_nodes=pad1(s.upper_nodes, c.cap_u, -1),
            upper_adj=pad1(s.upper_adj, c.cap_u, -1),
            upper_dist=pad1(s.upper_dist, c.cap_u, jnp.inf),
            entry_point=s.entry_point,
            entry_level=s.entry_level,
            count=s.count,
            upper_count=s.upper_count,
        )
        codes = np.full((self.n_shards, c.cap), -1, dtype=np.int32)
        codes[:, : old.cap] = self._part_codes
        self._part_codes = codes

    def add(
        self,
        vectors: np.ndarray,
        *,
        partitions=None,
        batch: int = 256,
    ) -> np.ndarray:
        """Insert vectors; returns global ids [n]. Vectors are raw (will be
        prepared); partitions optionally routes rows to shards."""
        n = vectors.shape[0]
        shard_ix = self._assign(n, partitions)
        prepared = np.asarray(prepare_vectors(self.config, jnp.asarray(vectors)))
        slots = np.empty(n, dtype=np.int64)
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for row, s in enumerate(shard_ix):
            slots[row] = self._alloc_slot(int(s))
            per_shard[s].append(row)
            if partitions is not None:
                self._part_codes[s, slots[row]] = self._intern_partition(
                    partitions[row]
                )
        self._insert_rows(per_shard, slots, prepared, batch)
        return shard_ix * self.config.cap + slots

    def _insert_rows(self, per_shard, slots, prepared, batch: int, start: int = 1) -> None:
        """Interleave per-shard rows into fixed-shape SPMD insert rounds
        (same schedule on every shard; -1 padding where a shard is idle).
        ``start`` seeds the doubling schedule with the current per-shard
        graph size so warm incremental flushes skip the tiny rounds."""
        max_rows = max((len(rows) for rows in per_shard), default=0)
        pos = [0] * self.n_shards
        for take in plan_batch_sizes(max_rows, batch, start=start):
            ids = np.full((self.n_shards, batch), -1, dtype=np.int32)
            vecs = np.zeros(
                (self.n_shards, batch, prepared.shape[1]), dtype=prepared.dtype
            )
            for s in range(self.n_shards):
                rows = per_shard[s][pos[s] : pos[s] + take]
                pos[s] += len(rows)
                for j, row in enumerate(rows):
                    ids[s, j] = slots[row]
                    vecs[s, j] = prepared[row]
            levels = sample_levels_np(
                np.maximum(ids, 0).astype(np.int32).ravel(),
                self.config.rng_seed,
                self.config.level_factor,
                self.config.lu,
            ).reshape(ids.shape)
            self.stacked = _sharded_insert(
                self.config,
                self.mesh,
                self.stacked,
                jnp.asarray(ids),
                jnp.asarray(vecs),
                jnp.asarray(levels),
            )

    def delete(self, global_ids) -> None:
        """Delete by global id (mirrors VecTable.delete_many semantics:
        edge scrub + per-shard entry reselection). Slots are recycled."""
        gids = np.asarray(global_ids, dtype=np.int64).ravel()
        if gids.size == 0:
            return
        shard = gids // self.config.cap
        slot = gids % self.config.cap
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for s, sl in zip(shard, slot):
            s, sl = int(s), int(sl)
            if sl in self._free[s] or sl >= self._counts[s]:
                raise KeyError(f"global id {s * self.config.cap + sl} not live")
            per_shard[s].append(sl)
        nb_max = max(len(p) for p in per_shard)
        nb = 16 if nb_max <= 16 else -(-nb_max // 256) * 256
        ids = np.full((self.n_shards, nb), -1, dtype=np.int32)
        for s, sl_list in enumerate(per_shard):
            ids[s, : len(sl_list)] = sl_list
            self._free[s].extend(sl_list)
            self._part_codes[s, sl_list] = -1
        self.stacked = _sharded_delete(
            self.config, self.mesh, self.stacked, jnp.asarray(ids)
        )

    def update(self, global_ids, vectors, *, partitions=None, batch: int = 256) -> None:
        """Replace vectors in place (delete + re-insert at the same slots,
        the reference's update semantics, src/vtab.rs:1860-2016): global
        ids stay stable."""
        gids = np.asarray(global_ids, dtype=np.int64).ravel()
        shard = gids // self.config.cap
        slot = gids % self.config.cap
        # delete() clears _part_codes; keep the old codes so an update
        # without an explicit `partitions` preserves tenant membership
        old_codes = [
            int(self._part_codes[int(s), int(sl)]) for s, sl in zip(shard, slot)
        ]
        self.delete(gids)
        prepared = np.asarray(prepare_vectors(self.config, jnp.asarray(vectors)))
        per_shard: list[list[int]] = [[] for _ in range(self.n_shards)]
        for row, (s, sl) in enumerate(zip(shard, slot)):
            s, sl = int(s), int(sl)
            self._free[s].remove(sl)
            per_shard[s].append(row)
            if partitions is not None:
                self._part_codes[s, sl] = self._intern_partition(partitions[row])
            else:
                self._part_codes[s, sl] = old_codes[row]
        self._insert_rows(per_shard, slot, prepared, batch)

    def search(
        self,
        queries: np.ndarray,
        *,
        k: int,
        ef: int | None = None,
        n_expand: int = 1,
        partition=None,
    ):
        """KNN across all shards (or one shard when partition is given).

        Returns (dists [B, k] user metric, global_ids [B, k])."""
        qp = prepare_vectors(self.config, jnp.asarray(queries))
        if partition is not None:
            s = self.shard_of_partition(partition)
            state = jax.tree.map(lambda a: a[s], self.stacked)
            # partition-affinity routing: the tenant lives on one shard;
            # filter to the exact partition with an in-beam device mask
            # (tenants can share a shard). Small tenants go straight to
            # the exact masked scan; underfill also falls back to it.
            code = self._part_code_of.get(partition, -2)
            member = self._part_codes[s] == code
            n_member = int(member.sum())
            d = i = None
            if n_member > 50 * k:
                d, i = search_graph(
                    self.config,
                    state,
                    qp,
                    k=k,
                    ef=ef,
                    n_expand=n_expand,
                    filter_mask=jnp.asarray(member),
                )
                if (np.asarray(i) >= 0).sum(axis=1).min() < min(k, n_member):
                    d = i = None
            if d is None:
                from tpuvec.index.bruteforce import bruteforce_knn_internal

                d, i = bruteforce_knn_internal(
                    qp,
                    state.vectors,
                    jnp.asarray(member),
                    metric=self.config.graph_metric,
                    k=k,
                    normalized=self.config.normalized,
                )
            gi = jnp.where(i >= 0, s * self.config.cap + i, -1)
        else:
            d, gi = _sharded_search(
                self.config, self.mesh, self.stacked, qp, k=k, ef=ef, n_expand=n_expand
            )
        out = internal_to_output(
            self.config.metric, d, normalized=self.config.normalized
        )
        return jnp.where(jnp.isfinite(d), out, _INF), gi


# ---------------------------------------------------------------------- #
# persistence (mirrors store.snapshot for the sharded index)
# ---------------------------------------------------------------------- #

_SHARD_GRAPH_FIELDS = [
    "vectors", "adj0", "adj0_dist", "levels", "upper_slot", "upper_nodes",
    "upper_adj", "upper_dist", "entry_point", "entry_level", "count",
    "upper_count",
]


def save_sharded(idx: ShardedHnsw, path: str) -> None:
    """Snapshot a ShardedHnsw to one .npz (host-side, atomic rename)."""
    import json as _json
    import os as _os
    import tempfile as _tempfile
    import dataclasses as _dc

    meta = {
        "version": 2,
        "n_shards": idx.n_shards,
        "axis": idx.axis,
        "counts": idx._counts.tolist(),
        "free": [list(f) for f in idx._free],
        "rr": idx._rr,
        "config": {
            f.name: (
                getattr(idx.config, f.name).value
                if hasattr(getattr(idx.config, f.name), "value")
                else getattr(idx.config, f.name)
            )
            for f in _dc.fields(idx.config)
        },
        # interned partition values, serialized as JSON (validated below);
        # codes ride as an array
        "part_values": idx._part_list,
    }
    try:
        meta_json = _json.dumps(meta)
    except TypeError as e:
        raise ValueError(
            "save_sharded requires JSON-serializable partition values "
            f"(int/float/str/bool/None): {e}"
        ) from None
    arrays = {
        f: np.asarray(getattr(idx.stacked, f)) for f in _SHARD_GRAPH_FIELDS
    }
    arrays["__part_codes__"] = idx._part_codes
    arrays["__meta__"] = np.frombuffer(meta_json.encode(), dtype=np.uint8)
    d = _os.path.dirname(_os.path.abspath(path)) or "."
    fd, tmp = _tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with _os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        _os.replace(tmp, path)
    except BaseException:
        if _os.path.exists(tmp):
            _os.unlink(tmp)
        raise


def load_sharded(path: str, mesh: Mesh) -> ShardedHnsw:
    """Restore a ShardedHnsw onto a mesh with the same shard count."""
    import json as _json

    from tpuvec.types import DistanceMetric, IndexQuantization, VectorType

    with np.load(path, allow_pickle=False) as z:
        meta = _json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != 2:
            raise ValueError(
                f"unsupported sharded-snapshot version {meta.get('version')}"
            )
        cfgd = dict(meta["config"])
        if mesh.devices.size != meta["n_shards"]:
            raise ValueError(
                f"snapshot has {meta['n_shards']} shards, mesh has {mesh.devices.size}"
            )
        idx = ShardedHnsw(
            mesh,
            cfgd["dim"],
            metric=DistanceMetric.parse(cfgd["metric"]),
            params=HnswParams(
                m=cfgd["m"], max_m0=cfgd["max_m0"],
                ef_construction=cfgd["ef_construction"],
                ef_search=cfgd["ef_search"],
                rng_seed=cfgd["rng_seed"],
                simple_prune=cfgd["simple_prune"],
            ),
            cap_per_shard=cfgd["cap"],
            quantization=IndexQuantization.parse(cfgd["quantization"]),
            vec_type=VectorType.parse(cfgd["vec_type"]),
        )
        sharding = NamedSharding(mesh, P(idx.axis))
        # every stacked leaf (including the [S] scalar stacks) shards on axis 0
        fields = {
            f: jax.device_put(jnp.asarray(z[f]), sharding)
            for f in _SHARD_GRAPH_FIELDS
        }
        idx.stacked = GraphState(**fields)
        idx._counts = np.asarray(meta["counts"], dtype=np.int64)
        idx._free = [list(f) for f in meta["free"]]
        idx._rr = meta["rr"]
        idx._part_codes = np.asarray(z["__part_codes__"], dtype=np.int32)
        idx._part_list = list(meta["part_values"])
        idx._part_code_of = {v: c for c, v in enumerate(idx._part_list)}
    return idx
