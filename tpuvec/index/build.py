"""Batched HNSW construction, deletion and rebuild.

Batched recast of the reference's per-row insert path
(insert_hnsw, src/hnsw/insert.rs:279-532). Differences by design:

* Inserts land in mini-batches. A whole batch runs the candidate beam
  search together; batch members don't see each other in the level-0 graph
  (the build driver keeps batch size <= current graph size, so staleness
  stays bounded — the same spirit as the reference tolerating
  cross-connection staleness via refresh_entry_point, mod.rs:386-424).
* Upper-level (>= 1) neighbor selection is *exact*: only ~1/M of nodes
  reach level 1, so a chunked matmul over all upper nodes beats graph
  traversal and improves on the reference's beam there.
* Forward-edge selection uses the RNG diversity heuristic (the reference
  ships it behind simple_prune=false); reverse edges land through one
  vectorized sort-based pass (_reverse_pass) that keeps the closest
  entries per stored edge distance (the reference's prune semantics,
  insert.rs:144-221) in the suffix beyond an eviction-protected prefix.
* Level sampling is a deterministic pure function of the node id
  (utils/prng.py) instead of the reference's time-seeded hash
  (insert.rs:114-137).
"""

from __future__ import annotations

import dataclasses

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuvec.index.bruteforce import bruteforce_knn_internal
from tpuvec.index.graph import GraphState, HnswConfig, allocate
from tpuvec.index.search import (
    beam_search_level0,
    default_max_iters,
    descend_to_level1,
)
from tpuvec.ops.sort import bitonic_smallest
from tpuvec.utils.device import device_share
from tpuvec.utils.prng import sample_levels

__all__ = ["insert_batch", "build_graph", "delete_ids", "plan_batch_sizes"]

_INF = jnp.float32(jnp.inf)


def _pairwise_cands(config: HnswConfig, cvecs: jnp.ndarray) -> jnp.ndarray:
    """Pairwise *internal-metric* distances among candidates:
    [nb, C, Dp] -> [nb, C, C].

    Must match the units of the beam's cand_d (config.graph_metric):
    heuristic_select compares `cand_d[:, j] < mind[:, j]` directly, so a
    mismatched scale (e.g. L2^2 here vs 1-sim in cand_d for raw-cosine
    int8 graphs) silently degenerates the diversity test."""
    from tpuvec.types import DistanceMetric

    metric = config.graph_metric
    if metric is DistanceMetric.HAMMING:
        # +-1 expansion (see ops/distance.hamming_pairwise): one int8
        # batched matmul instead of the [nb, C, C, W] XOR+popcount cube
        from tpuvec.ops.distance import unpack_pm1

        s = unpack_pm1(cvecs)  # [nb, C, Dp] int8
        dot = jnp.einsum(
            "bcd,bed->bce", s, s, preferred_element_type=jnp.int32
        )
        dp = cvecs.shape[-1] * 32
        return ((dp - dot) >> 1).astype(jnp.float32)
    ci = cvecs.astype(jnp.float32)
    if metric is DistanceMetric.L1:
        # broadcast-reduce; XLA fuses to the [nb, C, C] output without
        # materializing [nb, C, C, D]. C is bounded (<=192) by the caller.
        return jnp.sum(jnp.abs(ci[:, :, None, :] - ci[:, None, :, :]), axis=-1)
    dots = jnp.einsum(
        "bcd,bed->bce", ci, ci, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric is DistanceMetric.COSINE and not config.normalized:
        # raw cosine (int8 graphs): internal distance is 1 - sim
        norms = jnp.sqrt(jnp.sum(ci * ci, axis=-1))
        denom = norms[:, :, None] * norms[:, None, :]
        sim = jnp.where(denom > 0, dots / jnp.where(denom > 0, denom, 1.0), 0.0)
        return 1.0 - sim
    # L2 / normalized cosine: squared L2
    norms = jnp.sum(ci * ci, axis=-1)
    return jnp.maximum(norms[:, :, None] + norms[:, None, :] - 2.0 * dots, 0.0)


def heuristic_select(
    config: HnswConfig,
    cand_d: jnp.ndarray,   # [nb, C] ascending (inf = invalid)
    cand_i: jnp.ndarray,   # [nb, C]
    cvecs: jnp.ndarray,    # [nb, C, Dp]
    max_conn: int,
):
    """RNG diversity neighbor selection, batched.

    The classic HNSW heuristic (the reference carries it behind
    simple_prune=false, src/hnsw/mod.rs:29-32 / FINDINGS.md:350-398):
    walk candidates in distance order, keep c only if it is closer to the
    new node than to every already-kept neighbor; then fill remaining
    slots with the closest rejected candidates (keep-pruned-connections).
    Runs as a next-survivor fori_loop of max_conn steps (not C steps) over
    [nb, C] masks with a precomputed candidate-pairwise distance matrix
    (one einsum). Equivalence to the canonical per-candidate scan: kept
    positions strictly increase, every candidate before the next survivor
    is rejected against a mind[] that only shrinks afterwards (so the
    rejection is permanent), and the survivor itself passes against
    exactly the kept set that precedes it. max_conn steps of [nb, C] work
    replace C steps — measured as the bulk of the connect stage at C=192.
    """
    nb, c = cand_d.shape
    pair = _pairwise_cands(config, cvecs)  # [nb, C, C]
    valid = jnp.isfinite(cand_d)
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (nb, c), 1)

    def body(_, carry):
        mask, mind = carry
        alive = jnp.logical_and(
            jnp.logical_and(valid, cand_d < mind), jnp.logical_not(mask)
        )
        p = jnp.min(jnp.where(alive, iota_c, c), axis=1)  # first alive
        has = p < c
        pc = jnp.minimum(p, c - 1)
        mask = jnp.logical_or(
            mask, jnp.logical_and(has[:, None], iota_c == pc[:, None])
        )
        prow = jnp.take_along_axis(pair, pc[:, None, None], axis=1)[:, 0, :]
        mind = jnp.where(has[:, None], jnp.minimum(mind, prow), mind)
        return mask, mind

    mask0 = jnp.zeros((nb, c), dtype=jnp.bool_)
    mind0 = jnp.full((nb, c), _INF, dtype=jnp.float32)
    mask, _ = jax.lax.fori_loop(
        0, min(max_conn, c), body, (mask0, mind0)
    )

    # order: kept (by distance) first, then rejected (by distance); invalid
    # last. The composite key is < 3*C + C <= 2^24, exact in f32, so the
    # selection runs on the bitonic network (ops/sort.py)
    group = jnp.where(mask, 0, jnp.where(valid, 1, 2)).astype(jnp.int32)
    key = group * c + jax.lax.broadcasted_iota(jnp.int32, (nb, c), 1)
    _, sel_d, sel_i = bitonic_smallest(
        key.astype(jnp.float32), cand_d, cand_i, k=max_conn
    )
    sel_i = jnp.where(jnp.isfinite(sel_d), sel_i, -1)
    return sel_d, sel_i


@partial(jax.jit, static_argnames=("config",), donate_argnames=("state",))
def _stage_write(
    config: HnswConfig,
    state: GraphState,
    new_ids: jnp.ndarray,
    new_vecs: jnp.ndarray,
    new_levels: jnp.ndarray,
) -> GraphState:
    """Stage 1: write vectors + levels, allocate compact upper slots."""
    c = config
    ok_new = new_ids >= 0
    new_levels = jnp.where(ok_new, jnp.minimum(new_levels, c.lu), -1)

    tgt = jnp.where(ok_new, new_ids, c.cap)
    vectors = state.vectors.at[tgt].set(new_vecs, mode="drop")

    is_up = jnp.logical_and(ok_new, new_levels >= 1)
    slot_off = jnp.cumsum(is_up.astype(jnp.int32)) - 1
    slot = jnp.where(is_up, state.upper_count + slot_off, -1)
    overflow = slot >= c.cap_u
    slot = jnp.where(overflow, -1, slot)
    # overflowing nodes are demoted to level 0
    new_levels = jnp.where(overflow, 0, new_levels)
    levels = state.levels.at[tgt].set(jnp.maximum(new_levels, 0), mode="drop")
    upper_slot = state.upper_slot.at[tgt].set(slot, mode="drop")
    upper_nodes = state.upper_nodes.at[
        jnp.where(slot >= 0, slot, c.cap_u)
    ].set(new_ids, mode="drop")
    upper_count = state.upper_count + jnp.sum(
        jnp.logical_and(is_up, jnp.logical_not(overflow)).astype(jnp.int32)
    )
    return dataclasses.replace(
        state,
        vectors=vectors,
        levels=levels,
        upper_slot=upper_slot,
        upper_nodes=upper_nodes,
        upper_count=upper_count,
    )


def _batch_levels(config: HnswConfig, state: GraphState, new_ids: jnp.ndarray):
    """Recover the (possibly demoted) levels of this batch from state."""
    ok_new = new_ids >= 0
    return jnp.where(ok_new, state.levels[jnp.maximum(new_ids, 0)], -1)


def _build_iter_budget(cap: int, efc: int, n_expand: int) -> int:
    """Construction-beam iteration budget.

    The generic default (1.5*ef/E + 8 = 158 at efc=200) over-runs what
    the graph needs: at 1M x 768 the candidate id-sets at 96 and 158
    iterations agree 1.0000 (measured on real tail-of-build batches),
    and the construction beam is the largest single line in the insert
    budget. Navigation work scales
    with graph DEPTH, so the budget scales with ln(cap):
    ceil(7*ln(cap)) + 8 = 57 at 1K, 89 at 100K, 105 at 1M, 121 at 10M.
    (Round-3 lesson baked in: a flat 64-iteration cap tuned at 100K
    starved 1M graph quality — iteration caps must grow with ln N.)
    """
    depth_budget = int(np.ceil(7.0 * np.log(max(cap, 2)))) + 8
    return min(default_max_iters(efc, n_expand), depth_budget)


@partial(jax.jit, static_argnames=("config",))
def _stage_candidates(config: HnswConfig, state: GraphState, new_vecs: jnp.ndarray):
    """Stage 2: level-0 candidate beam over the pre-batch graph
    (ef_construction, insert.rs:410-418)."""
    c = config
    seed_ids, seed_d = descend_to_level1(config, state, new_vecs)
    efc = max(c.ef_construction, c.max_m0)
    cand_d, cand_i, _ = beam_search_level0(
        config,
        state,
        new_vecs,
        seed_ids,
        seed_d,
        ef=efc,
        max_iters=c.build_max_iters or _build_iter_budget(c.cap, efc, 2),
        n_expand=2,
        # the construction beam always runs its full iteration budget (the
        # early-exit needs ~ef/E expansions to fire, and the budget is
        # 1.5x that), so per-iteration cost is everything: at this wide
        # shape (EF=256) the O(S log S) bitonic network does far fewer
        # compares than the O(S^2) rank merge, with bit-identical output
        merge="bitonic",
    )
    return cand_d, cand_i


@partial(jax.jit, static_argnames=("config",), donate_argnames=("state",))
def _stage_upper(
    config: HnswConfig,
    state: GraphState,
    new_ids: jnp.ndarray,
    new_vecs: jnp.ndarray,
) -> GraphState:
    """Stage 3: upper-level edges — exact matmul selection over the compact
    upper pool + reverse prune."""
    c = config
    nb = new_ids.shape[0]
    ok_new = new_ids >= 0
    new_levels = _batch_levels(config, state, new_ids)

    # Compact the batch to its level>=1 members before the pool scan.
    # Only ~nb/m rows reach level 1 (P = 1/m per node), yet the exact
    # pool-selection matmul + top-k below would otherwise run for the
    # whole batch. K = 4x the expected count (mean nb/16, so K >= mean + 24 sigma:
    # overflow probability is negligible); overflowing rows keep their
    # level but get no upper out-edges (still reachable at level 0).
    k_up = nb if nb <= 256 else max(256, nb // 4)
    up = jnp.logical_and(ok_new, new_levels >= 1)
    order = jnp.argsort(jnp.logical_not(up).astype(jnp.int32), stable=True)
    sub = order[:k_up]
    sub_up = up[sub]
    new_ids = jnp.where(sub_up, new_ids[sub], -1)
    new_vecs = new_vecs[sub]
    new_levels = jnp.where(sub_up, new_levels[sub], -1)
    ok_new = new_ids >= 0
    slot = jnp.where(ok_new, state.upper_slot[jnp.maximum(new_ids, 0)], -1)

    pool_vecs = state.vectors[jnp.maximum(state.upper_nodes, 0)]  # [cap_u, Dp]
    pool_levels = jnp.where(
        state.upper_nodes >= 0, state.levels[jnp.maximum(state.upper_nodes, 0)], -1
    )
    # one loop body for all levels (a Python loop would unroll lu copies
    # of the pool scan + selection + reverse pass and multiply compile
    # time); level `lev` owns adjacency columns [(lev-1)*m, lev*m)
    def level(lev, carry):
        at_lev = jnp.logical_and(ok_new, new_levels >= lev)

        def do_level(upper_adj, upper_dist):
            pool_ok = pool_levels >= lev
            # exact top candidates from the pool, then drop self
            heur = not c.simple_prune
            kc = (2 * c.m + 1) if heur else (c.m + 1)
            d_sel, slot_sel = bruteforce_knn_internal(
                new_vecs,
                pool_vecs,
                pool_ok,
                metric=c.graph_metric,
                k=kc,
                normalized=c.normalized,
            )  # ids are *slot* indices
            nbr_ids = jnp.where(
                slot_sel >= 0, state.upper_nodes[jnp.maximum(slot_sel, 0)], -1
            )
            is_self = nbr_ids == new_ids[:, None]
            d_sel = jnp.where(is_self, _INF, d_sel)
            nbr_ids = jnp.where(is_self, -1, nbr_ids)
            if heur:
                cvecs = state.vectors[jnp.maximum(nbr_ids, 0)]
                sel_d, sel_i = heuristic_select(
                    config, d_sel, nbr_ids, cvecs, c.m
                )
            else:
                sel_d, sel_i = bitonic_smallest(d_sel, nbr_ids, k=c.m)
                sel_i = jnp.where(jnp.isfinite(sel_d), sel_i, -1)

            # forward edges
            row_tgt = jnp.where(at_lev, slot, c.cap_u)
            lo = (lev - 1) * c.m
            adj_l = jax.lax.dynamic_slice_in_dim(upper_adj, lo, c.m, axis=1)
            dist_l = jax.lax.dynamic_slice_in_dim(upper_dist, lo, c.m, axis=1)
            adj_l = adj_l.at[row_tgt].set(sel_i, mode="drop")
            dist_l = dist_l.at[row_tgt].set(sel_d, mode="drop")

            # reverse edges with prune — one vectorized sort-based pass
            # over all (neighbor slot <- new id) pairs (same machinery as
            # level 0; keep-smallest-K is order-independent, so this is
            # equivalent to the per-entrant sequential scan it replaced,
            # minus nb sequential dependency steps per level)
            s_slots = jnp.where(
                sel_i >= 0, state.upper_slot[jnp.maximum(sel_i, 0)], -1
            )
            adj_l, dist_l = _reverse_pass(
                adj_l, dist_l, new_ids, s_slots, sel_d, at_lev,
                c.cap_u, c.m, protect=0,
            )
            upper_adj = jax.lax.dynamic_update_slice_in_dim(
                upper_adj, adj_l, lo, axis=1
            )
            upper_dist = jax.lax.dynamic_update_slice_in_dim(
                upper_dist, dist_l, lo, axis=1
            )
            return upper_adj, upper_dist

        # most batches have no member at higher levels — skip the matmul
        return jax.lax.cond(
            jnp.any(at_lev), do_level, lambda a, d: (a, d), *carry
        )

    upper_adj, upper_dist = state.upper_adj, state.upper_dist
    if c.lu:  # max_level=0 graphs have no upper columns to slice
        upper_adj, upper_dist = jax.lax.fori_loop(
            1, c.lu + 1, level, (upper_adj, upper_dist)
        )

    return dataclasses.replace(state, upper_adj=upper_adj, upper_dist=upper_dist)


def _reverse_compute(adj, adj_dist, new_ids, fwd_i, fwd_d, ok_new, cap, max_conn, protect):
    """Vectorized reverse-edge insertion with protected-prefix pruning.

    The first `protect` slots of each row hold the row owner's
    heuristic-selected forward edges and are never evicted by
    reverse-edge churn. Without this, closest-only reverse pruning
    gradually replaces every row with its local kNN set, deleting the
    diverse bridge edges and shattering level 0 into micro-components
    (measured at 100K x 768: only 0.6% of nodes BFS-reachable from the
    entry point; recall ceiling 0.69). hnswlib prevents the same decay by
    running the diversity heuristic on shrink; slot protection is the
    cheap batched equivalent.

    Replaces a sequential per-node scan (nb steps) with one sort-based
    pass. For every (neighbor s <- new u) pair, group pairs by s (stable
    double argsort: by distance, then by s), rank entrants within each
    group (cumulative-max group starts), cap at the suffix width (farthest
    entrants beyond capacity can never survive), and let each group's
    *leader* rewrite s's suffix as top-K of (old suffix ∪ its entrant
    window). Leaders have unique s, so the scatter is conflict-free.

    Equivalent to inserting entrants one at a time with keep-smallest-K
    pruning: keep-top-K is order-independent.
    """
    nb, m0 = fwd_i.shape
    keep = max_conn - protect
    p_n = nb * m0

    s = fwd_i.reshape(p_n)
    u = jnp.repeat(new_ids, m0)
    d = fwd_d.reshape(p_n)
    ok = jnp.logical_and(
        jnp.logical_and(s >= 0, jnp.isfinite(d)), jnp.repeat(ok_new, m0)
    )
    big = jnp.int32(cap + 1)
    s_key = jnp.where(ok, s, big)

    # stable group-by (s, then d): ONE multi-key lax.sort instead of the
    # previous double argsort + two gathers (each a full generic sort)
    s_s, d_s, u_s = jax.lax.sort(
        (s_key, d, u), dimension=0, num_keys=2, is_stable=True
    )

    iota = jnp.arange(p_n, dtype=jnp.int32)
    start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_s[1:] != s_s[:-1]]
    )
    fi = jax.lax.cummax(jnp.where(start, iota, 0))
    occ = iota - fi
    leader = jnp.logical_and(start, s_s < big)

    # entrant window per leader: positions [i, i+keep)
    pos = iota[:, None] + jnp.arange(keep)[None, :]
    win = jnp.minimum(pos, p_n - 1)
    win_same = jnp.logical_and(s_s[win] == s_s[:, None], pos < p_n)
    ent_d = jnp.where(win_same, d_s[win], _INF)
    ent_i = jnp.where(win_same, u_s[win], -1)

    # merge with the old suffix and keep the smallest `keep`
    rows_old = adj[jnp.minimum(s_s, cap - 1)][:, protect:]
    rowsd_old = adj_dist[jnp.minimum(s_s, cap - 1)][:, protect:]
    cat_i = jnp.concatenate([rows_old, ent_i], axis=1)
    cat_d = jnp.concatenate([rowsd_old, ent_d], axis=1)
    new_rowsd, new_rows = bitonic_smallest(cat_d, cat_i, k=keep)
    new_rows = jnp.where(jnp.isfinite(new_rowsd), new_rows, -1)

    tgt = jnp.where(leader, s_s, cap)  # only leaders write; others dropped
    return tgt, new_rows, new_rowsd


@partial(
    jax.jit,
    static_argnames=("protect",),
    donate_argnames=("adj", "adj_dist"),
)
def _apply_rows(adj, adj_dist, tgt, new_rows, new_rowsd, protect: int):
    """Scatter merged suffix rows into the adjacency — its OWN program.

    When this scatter lives inside a build stage that also reads the
    (donated) adjacency, XLA can lower the aliased in-place scatter to a
    SEQUENTIAL while loop over all nb*m0 update rows. In a separate
    write-only program with an optimization_barrier on the buffers, the
    scatter compiles to the vectorized form and donation still keeps the
    update in place (barriers on the *updates* or inside the composed
    read+write program do NOT help).
    """
    adj, adj_dist = jax.lax.optimization_barrier((adj, adj_dist))
    adj = adj.at[tgt, protect:].set(new_rows, mode="drop")
    adj_dist = adj_dist.at[tgt, protect:].set(new_rowsd, mode="drop")
    return adj, adj_dist


@partial(
    jax.jit,
    static_argnames=("protect",),
    donate_argnames=("adj", "adj_dist"),
)
def _apply_rows_dense(adj, adj_dist, tgt, new_rows, new_rowsd, protect: int):
    """Scatter-FREE level-0 reverse apply — the default below the size
    threshold in _apply_rows_impl. Whether it beats the donated scatter
    on a given device is an open A/B (ROADMAP); TPUVEC_REV_APPLY=scatter
    selects the other program.

    Exploits an invariant of _reverse_compute: valid targets (tgt < cap)
    sit at group-leader positions of an s-sorted array, so across the
    update list the valid targets are STRICTLY INCREASING. A running
    cummax (invalid slots carry the previous leader's value) is then
    monotone, and a vectorized binary search maps every graph row to the
    unique update row that targets it — first position where the cummax
    reaches r is exactly r's leader. The row update becomes
    gather + elementwise select + one static-slice store: no scatter HLO
    exists in the program, so there is nothing for XLA to serialize
    (the aliased row scatter lowers to a sequential per-row while loop,
    see _apply_rows). Cost is one full dense rewrite of the suffix
    columns (~0.5 GB of device-memory traffic at [1M, 32]) instead of a
    sparse touch of <=nb*m0 rows — a good trade iff the scatter really
    serializes end-to-end."""
    cap = adj.shape[0]
    p_n = tgt.shape[0]
    valid = tgt < cap
    mono = jax.lax.cummax(jnp.where(valid, tgt, -1))
    rows = jnp.arange(cap, dtype=tgt.dtype)
    pos = jnp.clip(
        jnp.searchsorted(mono, rows, side="left"), 0, p_n - 1
    ).astype(jnp.int32)
    hit = mono[pos] == rows  # cummax first reaches r at r's leader slot
    sfx_i = jnp.where(hit[:, None], new_rows[pos], adj[:, protect:])
    sfx_d = jnp.where(hit[:, None], new_rowsd[pos], adj_dist[:, protect:])
    adj = adj.at[:, protect:].set(sfx_i)
    adj_dist = adj_dist.at[:, protect:].set(sfx_d)
    return adj, adj_dist


def _apply_rows_impl(adj_nbytes: int = 0):
    """Active level-0 reverse-apply program (env-selectable for A/B).

    Default is the scatter-free dense form (see _apply_rows_dense) — but
    ONLY while its [cap, m0] suffix temporaries fit: the dense program
    peaks ~2x the adjacency bytes above the scatter one, which ran a 10M
    binary build out of memory. Above the byte threshold (adjacency +
    distance copies; 1/16 of the card's memory limit, 1 GB where the
    backend reports none; TPUVEC_REV_APPLY_DENSE_MAX_BYTES overrides) the
    donated-scatter program is used instead. TPUVEC_REV_APPLY=scatter|dense
    forces one unconditionally."""
    import os

    forced = os.environ.get("TPUVEC_REV_APPLY")
    if forced == "scatter":
        return _apply_rows
    if forced == "dense":
        return _apply_rows_dense
    env = os.environ.get("TPUVEC_REV_APPLY_DENSE_MAX_BYTES")
    cap_bytes = int(env) if env is not None else device_share(1 / 16, 1 << 30)
    if adj_nbytes * 2 > cap_bytes:
        return _apply_rows
    return _apply_rows_dense


def _reverse_pass(adj, adj_dist, new_ids, fwd_i, fwd_d, ok_new, cap, max_conn, protect):
    """Compute + apply in one trace (used where the caller is already
    inside a jit region, e.g. the per-level upper-graph cond)."""
    tgt, new_rows, new_rowsd = _reverse_compute(
        adj, adj_dist, new_ids, fwd_i, fwd_d, ok_new, cap, max_conn, protect
    )
    adj = adj.at[tgt, protect:].set(new_rows, mode="drop")
    adj_dist = adj_dist.at[tgt, protect:].set(new_rowsd, mode="drop")
    return adj, adj_dist


@partial(jax.jit, static_argnames=("config",), donate_argnames=("state",))
def _stage_connect(
    config: HnswConfig,
    state: GraphState,
    new_ids: jnp.ndarray,
    cand_d: jnp.ndarray,
    cand_i: jnp.ndarray,
) -> tuple[GraphState, tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Stage 4: level-0 forward selection (diversity heuristic), reverse
    prune with protected prefix, entry point + count update.

    Returns the updated state plus the reverse-edge row updates
    (tgt, rows, rowsd) for the caller to scatter via _apply_rows."""
    c = config
    ok_new = new_ids >= 0
    tgt = jnp.where(ok_new, new_ids, c.cap)
    new_levels = _batch_levels(config, state, new_ids)

    # candidates come from the pre-batch graph so self/batch loops cannot
    # occur by construction; the self mask is defense in depth.
    self_hit = cand_i == new_ids[:, None]
    cand_d = jnp.where(self_hit, _INF, cand_d)
    cand_i = jnp.where(self_hit, -1, cand_i)
    # the diversity heuristic is REQUIRED for Hamming too: packed-bit
    # distances tie heavily (D=1024: mean 512, sigma~16), and closest-only
    # selection shatters navigability at scale (measured: 0.92 coarse
    # recall at 4K but ~0.002 at 3.1M; found neighbors at distance ~456
    # when the true top-10 sit at ~424)
    use_heuristic = not c.simple_prune
    if use_heuristic:
        cw = min(cand_d.shape[1], 192)  # bound the pairwise matrix
        cvecs = state.vectors[jnp.maximum(cand_i[:, :cw], 0)]
        fwd_d, fwd_i = heuristic_select(
            config, cand_d[:, :cw], cand_i[:, :cw], cvecs, c.max_m0
        )
    else:
        fwd_d, fwd_i = bitonic_smallest(cand_d, cand_i, k=c.max_m0)
        fwd_i = jnp.where(jnp.isfinite(fwd_d), fwd_i, -1)
    adj0 = state.adj0.at[tgt].set(fwd_i, mode="drop")
    adj0_dist = state.adj0_dist.at[tgt].set(fwd_d, mode="drop")

    # reverse level-0 edges, protected-prefix pruned: COMPUTE only — the
    # row scatter runs in its own program (_apply_rows) because an
    # aliased scatter inside this donated stage serializes (see
    # _apply_rows docstring)
    rev = _reverse_compute(
        adj0,
        adj0_dist,
        new_ids,
        fwd_i,
        fwd_d,
        ok_new,
        c.cap,
        c.max_m0,
        protect=min(c.m, c.max_m0 // 2),
    )

    # entry point + count
    lv_masked = jnp.where(ok_new, new_levels, -1)
    new_max = jnp.max(lv_masked)
    best = new_ids[jnp.argmax(lv_masked)]
    upgrade = new_max > state.entry_level
    entry_point = jnp.where(upgrade, best, state.entry_point)
    entry_level = jnp.where(upgrade, new_max, state.entry_level)
    count = state.count + jnp.sum(ok_new.astype(jnp.int32))

    return dataclasses.replace(
        state,
        adj0=adj0,
        adj0_dist=adj0_dist,
        entry_point=entry_point,
        entry_level=entry_level,
        count=count,
    ), rev


def insert_batch(
    config: HnswConfig,
    state: GraphState,
    new_ids: jnp.ndarray,     # [nb] i32, -1 = padding
    new_vecs: jnp.ndarray,    # [nb, Dp] already prepared (prepare_vectors)
    new_levels: jnp.ndarray,  # [nb] i32 (from sample_levels; ignored for pads)
) -> GraphState:
    """Insert a padded mini-batch of nodes.

    Four separately-jitted stages (write -> candidates -> upper edges ->
    connect): smaller XLA programs compile faster and cache
    independently, at the cost of three extra dispatches per batch. The
    candidate search runs against the pre-batch graph (new upper slots
    exist but have no in-edges yet, so the beam cannot land on them).
    """
    from tpuvec.utils import timing

    with timing.timer("insert.write"):
        state = _stage_write(config, state, new_ids, new_vecs, new_levels)
    with timing.timer("insert.candidates"):
        cand_d, cand_i = _stage_candidates(config, state, new_vecs)
        if timing.enabled():
            cand_i.block_until_ready()
    with timing.timer("insert.upper"):
        state = _stage_upper(config, state, new_ids, new_vecs)
        if timing.enabled():
            state.count.block_until_ready()
    with timing.timer("insert.connect"):
        state, rev = _stage_connect(config, state, new_ids, cand_d, cand_i)
        if timing.enabled():
            state.count.block_until_ready()
    with timing.timer("insert.rev_apply"):
        # the level-0 reverse scatter runs as its own write-only program:
        # inside the donated connect stage XLA can serialize the aliased
        # scatter into a per-row loop (see _apply_rows)
        adj0, adj0_dist = _apply_rows_impl(state.adj0.nbytes)(
            state.adj0,
            state.adj0_dist,
            *rev,
            protect=min(config.m, config.max_m0 // 2),
        )
        state = dataclasses.replace(state, adj0=adj0, adj0_dist=adj0_dist)
        if timing.enabled():
            state.count.block_until_ready()
    return state


@partial(jax.jit, static_argnames=("take", "shape"))
def _slice_pad(vectors: jnp.ndarray, pos, *, take: int, shape: int) -> jnp.ndarray:
    """One program for the per-batch device slice + zero-pad (the eager
    two-op form is two extra dispatches per batch)."""
    blk = jax.lax.dynamic_slice_in_dim(vectors, pos, take, axis=0)
    bv = jnp.zeros((shape, vectors.shape[1]), vectors.dtype)
    return jax.lax.dynamic_update_slice_in_dim(bv, blk, 0, axis=0)


def plan_batch_sizes(total: int, max_batch: int = 1024, start: int = 1) -> list[int]:
    """Doubling schedule of *live* batch sizes: 1, 1, 2, 4, ... so every
    batch is no larger than the graph it is inserted into (bounds
    within-batch staleness). The device batches are all padded to one fixed
    shape (max_batch) so jit compiles the insert program exactly once per
    config. ``start`` seeds the schedule with the current graph size for
    incremental inserts into an existing graph."""
    sizes = []
    done = 0
    b = max(1, min(start, max_batch))
    while done < total:
        take = min(b, total - done)
        sizes.append(take)
        done += take
        b = min(max(b * 2, 1), max_batch)
    return sizes


def build_graph(
    config: HnswConfig,
    vectors_prepared: jnp.ndarray,
    ids: np.ndarray | None = None,
    *,
    max_batch: int = 1024,
    state: GraphState | None = None,
    progress: int = 0,
    start_size: int = 1,
) -> GraphState:
    """Build a graph over prepared vectors [N, Dp] (host driver).

    Equivalent of rebuild_hnsw_index's re-insert-everything loop
    (src/hnsw/rebuild.rs:20-76) but batched. Batch sizes are padded to the
    doubling schedule so jit caches a handful of shapes. ``start_size``
    seeds the schedule with the current graph size when resuming an
    interrupted build into an existing ``state``.
    """
    n = vectors_prepared.shape[0]
    if ids is None:
        ids = np.arange(n, dtype=np.int32)
    state = state if state is not None else allocate(config)
    on_device = isinstance(vectors_prepared, jax.Array)
    if not on_device:
        vectors_prepared = np.asarray(vectors_prepared)
    import sys
    import time as _time

    pos = 0
    t0 = _time.time()
    shape = max_batch  # fixed shape: one jit compile per (config, max_batch)
    for bi_num, take in enumerate(plan_batch_sizes(n, max_batch, start=start_size)):
        batch_ids = np.full(shape, -1, dtype=np.int32)
        batch_ids[:take] = ids[pos : pos + take]
        if on_device:
            # slice + pad on device: no per-batch host->device transfer
            bv = _slice_pad(
                vectors_prepared,
                np.int32(pos),
                take=min(take, n - pos),
                shape=shape,
            )
        else:
            bvh = np.zeros((shape, vectors_prepared.shape[1]), vectors_prepared.dtype)
            bvh[:take] = vectors_prepared[pos : pos + take]
            bv = jnp.asarray(bvh)
        bi = jnp.asarray(batch_ids)
        lv = sample_levels(
            jnp.maximum(bi, 0), config.rng_seed, config.level_factor, config.lu
        )
        state = insert_batch(config, state, bi, bv, lv)
        pos += take
        # bound how far the host enqueues ahead of the device (every 8
        # batches), so queued per-batch inputs do not pile up
        if bi_num % 8 == 0:
            state.count.block_until_ready()
        if progress and (bi_num % progress == 0):
            state.count.block_until_ready()
            rate = pos / max(_time.time() - t0, 1e-9)
            print(
                f"[build] {pos}/{n} ({rate:.0f} vec/s)",
                file=sys.stderr,
                flush=True,
            )
    return state


@partial(jax.jit, static_argnames=("config",), donate_argnames=("state",))
def delete_ids(
    config: HnswConfig, state: GraphState, ids: jnp.ndarray
) -> GraphState:
    """Delete nodes (padded id list, -1 = padding).

    Mirrors Vec0Tab::delete semantics (src/vtab.rs:1326-1407): remove the
    node and *all* edges referencing it, reselect the entry point by max
    level, decrement the count.
    """
    c = config
    ok = ids >= 0
    # node-level bookkeeping
    tgt = jnp.where(ok, ids, c.cap)
    slots = jnp.where(ok, state.upper_slot[jnp.maximum(ids, 0)], -1)
    levels = state.levels.at[tgt].set(-1, mode="drop")
    upper_slot = state.upper_slot.at[tgt].set(-1, mode="drop")
    upper_nodes = state.upper_nodes.at[
        jnp.where(slots >= 0, slots, c.cap_u)
    ].set(-1, mode="drop")
    adj0 = state.adj0.at[tgt].set(-1, mode="drop")
    adj0_dist = state.adj0_dist.at[tgt].set(_INF, mode="drop")
    upper_adj = state.upper_adj.at[
        jnp.where(slots >= 0, slots, c.cap_u)
    ].set(-1, mode="drop")
    upper_dist = state.upper_dist.at[
        jnp.where(slots >= 0, slots, c.cap_u)
    ].set(_INF, mode="drop")

    # scrub inbound edges: any adjacency cell equal to a deleted id -> -1.
    # Membership test via sorted searchsorted (O(cap*M0*log nd) and no
    # [cap, M0, nd] broadcast, so it scales to millions of nodes).
    deleted = jnp.sort(jnp.where(ok, ids, jnp.iinfo(jnp.int32).max))

    def scrub(a, ad):
        pos = jnp.searchsorted(deleted, a)
        found = deleted[jnp.minimum(pos, deleted.shape[0] - 1)] == a
        hit = jnp.logical_and(found, a >= 0)
        return jnp.where(hit, -1, a), jnp.where(hit, _INF, ad)

    adj0, adj0_dist = scrub(adj0, adj0_dist)
    upper_adj, upper_dist = scrub(upper_adj, upper_dist)

    # entry reselection (src/vtab.rs:1364-1392): max level among live nodes
    entry_deleted = jnp.any(jnp.logical_and(ok, ids == state.entry_point))
    live = levels >= 0
    any_live = jnp.any(live)
    cand_level = jnp.where(live, levels, -1)
    new_entry = jnp.argmax(cand_level).astype(jnp.int32)
    new_level = jnp.max(cand_level)
    entry_point = jnp.where(
        entry_deleted,
        jnp.where(any_live, new_entry, -1),
        state.entry_point,
    )
    entry_level = jnp.where(
        entry_deleted,
        jnp.where(any_live, new_level, -1),
        state.entry_level,
    )
    count = state.count - jnp.sum(
        jnp.logical_and(ok, state.levels[jnp.maximum(ids, 0)] >= 0).astype(
            jnp.int32
        )
    )

    return GraphState(
        vectors=state.vectors,
        adj0=adj0,
        adj0_dist=adj0_dist,
        levels=levels,
        upper_slot=upper_slot,
        upper_nodes=upper_nodes,
        upper_adj=upper_adj,
        upper_dist=upper_dist,
        entry_point=entry_point,
        entry_level=entry_level,
        count=count,
        upper_count=state.upper_count,
    )
