"""Batched HNSW search: greedy upper-level descent + level-0 beam.

Batched recast of the reference's search_hnsw / search_layer
(src/hnsw/search.rs:267-533). The reference walks the graph one node at a
time, issuing a cached SQLite statement per edge-list fetch and 1-64 point
queries per neighbor batch; here a whole batch of queries advances in
lock-step inside one jit region:

* the candidate/result heaps (search.rs:192-250) become one fixed-width
  sorted beam buffer [B, EF] merged by O(S^2) rank computation
  (rank_topk_merge_sorted, tpuvec/ops/sort.py): two big parallel
  compare/select-reduces with no sequential stages, in place of
  lax.top_k / lax.sort or a bitonic network's 28 dependent
  compare-exchange stages;
* the HybridVisited set (search.rs:19-52) is GONE: because the beam only
  ever improves, an evicted node can never re-qualify, so membership in
  the current beam is a complete visited test. Dedup is a chunked
  equality sweep against the beam — no scatter and no [B, cap] state at
  all;
* the per-node FFI fetches become two XLA gathers (adjacency row, then
  neighbor vectors) + one fused distance einsum;
* the data-dependent traversal loop becomes a lax.while_loop with a
  static trip bound (`max_iters`) and per-query active masks.

``n_expand`` (E) expands the E best unexpanded candidates per iteration
(same beam semantics, ~E x fewer sequential iterations). ``ef`` rounds up
to a power of two (the bitonic network needs it; a slightly wider beam
only helps recall).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpuvec.index.graph import GraphState, HnswConfig
from tpuvec.ops.distance import gathered_internal, internal_to_output
from tpuvec.ops.sort import rank_topk_merge_sorted

__all__ = ["search_graph", "search", "descend_to_level1", "default_max_iters"]

_INF = jnp.float32(jnp.inf)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _gather_vecs(state: GraphState, ids: jnp.ndarray) -> jnp.ndarray:
    """vectors[ids] with ids possibly -1 (caller masks distances)."""
    return state.vectors[jnp.maximum(ids, 0)]


def _node_dist(config: HnswConfig, state: GraphState, q: jnp.ndarray, ids: jnp.ndarray):
    """Internal distance q[b] -> node ids[b, ...]; invalid ids -> inf."""
    vecs = _gather_vecs(state, ids)
    if ids.ndim == 1:
        d = gathered_internal(
            config.graph_metric, q, vecs[:, None, :], normalized=config.normalized
        )[:, 0]
    else:
        d = gathered_internal(
            config.graph_metric, q, vecs, normalized=config.normalized
        )
    return jnp.where(ids >= 0, d, _INF)


# --------------------------------------------------------------------------
# Greedy descent over upper levels (ef = 1), reference search.rs:318-323
# --------------------------------------------------------------------------


def descend_to_level1(
    config: HnswConfig,
    state: GraphState,
    q: jnp.ndarray,
    *,
    max_steps: int = 64,
):
    """Greedy-descend every query from the entry point down to level 1.

    Returns (cur [B] i32, cur_d [B] f32): the best node found per query,
    used to seed the level-0 beam. Works when entry_level == 0 too (no-op).
    """
    b = q.shape[0]
    entry = state.entry_point
    cur = jnp.full((b,), entry, dtype=jnp.int32)
    cur_d = _node_dist(config, state, q, cur)

    def run_level(lev: int, cur, cur_d):
        def cond(carry):
            _, _, moved, it = carry
            return jnp.logical_and(moved, it < max_steps)

        def body(carry):
            cur, cur_d, _, it = carry
            slots = state.upper_slot[jnp.maximum(cur, 0)]          # [B]
            m = config.m
            nbrs = state.upper_adj[jnp.maximum(slots, 0)][
                :, (lev - 1) * m : lev * m
            ]  # [B, M]
            nbrs = jnp.where(slots[:, None] >= 0, nbrs, -1)
            nd = _node_dist(config, state, q, nbrs)                 # [B, M]
            best = jnp.argmin(nd, axis=-1)
            bd = jnp.min(nd, axis=-1)
            move = bd < cur_d
            new_cur = jnp.where(
                move, jnp.take_along_axis(nbrs, best[:, None], 1)[:, 0], cur
            )
            new_d = jnp.where(move, bd, cur_d)
            return new_cur, new_d, jnp.any(move), it + 1

        cur, cur_d, _, _ = jax.lax.while_loop(
            cond, body, (cur, cur_d, jnp.bool_(True), jnp.int32(0))
        )
        return cur, cur_d

    for lev in range(config.lu, 0, -1):
        cur, cur_d = jax.lax.cond(
            state.entry_level >= lev,
            lambda c, d, lev=lev: run_level(lev, c, d),
            lambda c, d: (c, d),
            cur,
            cur_d,
        )
    return cur, cur_d


# --------------------------------------------------------------------------
# Level-0 beam (visited-free, bitonic merge)
# --------------------------------------------------------------------------


def _chunked_membership(nbrs: jnp.ndarray, beam_i: jnp.ndarray, chunk: int = 128):
    """dup[b, w] = nbrs[b, w] in beam_i[b, :], without materializing
    the full [B, W, EF] cube."""
    b, w = nbrs.shape
    ef = beam_i.shape[-1]
    dup = jnp.zeros((b, w), dtype=jnp.bool_)
    for s in range(0, ef, chunk):
        blk = beam_i[:, s : s + chunk]
        dup = jnp.logical_or(
            dup, jnp.any(nbrs[:, :, None] == blk[:, None, :], axis=-1)
        )
    return dup


def _intra_dup(nbrs: jnp.ndarray, chunk: int = 128):
    """dup[b, w] = nbrs[b, w] equals an earlier element of nbrs[b, :]."""
    b, w = nbrs.shape
    dup = jnp.zeros((b, w), dtype=jnp.bool_)
    pos = jnp.arange(w)
    for s in range(0, w, chunk):
        blk = nbrs[:, s : s + chunk]
        eq = nbrs[:, :, None] == blk[:, None, :]
        earlier = pos[None, :, None] > (pos[s : s + chunk])[None, None, :]
        dup = jnp.logical_or(dup, jnp.any(jnp.logical_and(eq, earlier), axis=-1))
    return dup


def beam_search_level0(
    config: HnswConfig,
    state: GraphState,
    q: jnp.ndarray,
    seed_ids: jnp.ndarray,
    seed_dists: jnp.ndarray,
    *,
    ef: int,
    max_iters: int,
    n_expand: int = 1,
    node_mask: jnp.ndarray | None = None,
    k_out: int = 10,
    merge: str = "rank",
):
    """Best-first beam search at level 0.

    q [B, Dp]; seed_ids/seed_dists [B] from the descent. Returns
    (beam_d [B, EF] ascending, beam_i [B, EF], iters) in internal
    distance, with EF = next_pow2(ef).

    ``node_mask`` [cap] bool enables *filtered* search (the reference
    parses partition/metadata filters but never implements them,
    src/vtab.rs:2479-2480): the beam traverses the full graph — filtered
    nodes still route — while a separate result buffer collects the best
    ``k_out`` nodes passing the mask from every expanded window (so it
    sees iters x E x M0 candidates, not just beam survivors). Returns
    (res_d [B, KP], res_i [B, KP], iters) instead.

    ``merge`` selects the beam-merge algorithm: "rank" (O(S^2)
    compare-reduce, no sequential stages — wins at search shapes,
    S ~ 80) or "bitonic" (O(S log S) network — wins at the wide
    construction shape, S = 320: the rank merge's 105M compares/iter
    dominate the per-iteration overhead there).
    """
    b = q.shape[0]
    e = n_expand
    m0 = config.max_m0
    w_raw = e * m0
    efp = _next_pow2(ef)
    use_mask = node_mask is not None
    if merge == "bitonic":
        from tpuvec.ops.sort import bitonic_topk_merge_sorted as _merge
    else:
        _merge = rank_topk_merge_sorted

    beam_d = jnp.full((b, efp), _INF, dtype=jnp.float32)
    beam_i = jnp.full((b, efp), -1, dtype=jnp.int32)
    beam_x = jnp.ones((b, efp), dtype=jnp.bool_)  # expanded (padding = True)
    beam_d = beam_d.at[:, 0].set(jnp.where(seed_ids >= 0, seed_dists, _INF))
    beam_i = beam_i.at[:, 0].set(seed_ids)
    beam_x = beam_x.at[:, 0].set(seed_ids < 0)
    # seed slot must sort first: it does (others are inf)

    if use_mask:
        # 2x over-provision: a node evicted from the beam can be collected
        # twice (deduped post-loop), so a k-wide buffer can end up with
        # fewer than k uniques and force callers into the exact-scan
        # fallback (advisor round 2, low)
        kp = _next_pow2(max(2 * k_out, 4))
        seed_ok = jnp.logical_and(
            seed_ids >= 0, node_mask[jnp.maximum(seed_ids, 0)]
        )
        res_d = jnp.full((b, kp), _INF, dtype=jnp.float32)
        res_i = jnp.full((b, kp), -1, dtype=jnp.int32)
        res_x = jnp.zeros((b, kp), dtype=jnp.bool_)  # carried, unused
        res_d = res_d.at[:, 0].set(jnp.where(seed_ok, seed_dists, _INF))
        res_i = res_i.at[:, 0].set(jnp.where(seed_ok, seed_ids, -1))

    iota_ef = jnp.arange(efp)

    def frontier(beam_d, beam_i, beam_x):
        """Positions of the E best unexpanded candidates (beam is sorted
        ascending, so 'first E unexpanded')."""
        unexp = jnp.logical_and(jnp.logical_not(beam_x), jnp.isfinite(beam_d))
        rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1)
        cd_best = jnp.min(jnp.where(unexp, beam_d, _INF), axis=1)
        worst = beam_d[:, -1]
        active = jnp.logical_and(
            jnp.isfinite(cd_best),
            jnp.logical_or(cd_best <= worst, jnp.logical_not(jnp.isfinite(worst))),
        )
        sel = jnp.logical_and(unexp, rank <= e)  # [B, EF] up to E positions
        sel = jnp.logical_and(sel, active[:, None])
        return sel, active

    def cond(carry):
        # the frontier for the next iteration is computed once at the end
        # of each body and carried — cond is just a flag check
        *_, alive, it = carry
        return jnp.logical_and(alive, it < max_iters)

    def expand(beam_d, beam_i, beam_x, sel):
        """Mark the frontier expanded, gather + dedup its neighbors, and
        compute their distances. Returns (beam_x, nd [B, W], ni [B, W])."""
        beam_x = jnp.logical_or(beam_x, sel)

        # compact the <=E selected positions to [B, E] candidate ids
        selrank = jnp.cumsum(sel.astype(jnp.int32), axis=1)
        cand = jnp.full((b, e), -1, dtype=jnp.int32)
        for j in range(e):
            mask_j = jnp.logical_and(sel, selrank == j + 1)
            pos_j = jnp.argmax(mask_j, axis=1)
            has_j = jnp.any(mask_j, axis=1)
            cid = jnp.take_along_axis(beam_i, pos_j[:, None], 1)[:, 0]
            cand = cand.at[:, j].set(jnp.where(has_j, cid, -1))

        # expand: adjacency rows -> [B, W]
        nbrs = state.adj0[jnp.maximum(cand, 0)]            # [B, E, M0]
        nbrs = jnp.where(cand[:, :, None] >= 0, nbrs, -1).reshape(b, w_raw)
        valid = nbrs >= 0
        dup = _chunked_membership(nbrs, beam_i)
        if e > 1:
            dup = jnp.logical_or(dup, _intra_dup(nbrs))
        fresh = jnp.logical_and(valid, jnp.logical_not(dup))

        nd = _node_dist(config, state, q, jnp.where(fresh, nbrs, -1))  # [B, W]
        ni = jnp.where(fresh, nbrs, -1)
        return beam_x, nd, ni

    def body(carry):
        beam_d, beam_i, beam_x, sel, active, _, it = carry
        beam_x, nd, ni = expand(beam_d, beam_i, beam_x, sel)
        beam_d, beam_i, beam_x = _merge(
            beam_d, beam_i, beam_x, nd, ni
        )
        # padding slots (inf) must never be frontier
        beam_x = jnp.logical_or(beam_x, jnp.logical_not(jnp.isfinite(beam_d)))
        nsel, nactive = frontier(beam_d, beam_i, beam_x)
        return beam_d, beam_i, beam_x, nsel, nactive, jnp.any(nactive), it + 1

    def body_m(carry):
        beam_d, beam_i, beam_x, res_d, res_i, res_x, sel, active, _, it = carry
        beam_x, nd, ni = expand(beam_d, beam_i, beam_x, sel)
        # collect mask-passing nodes from the whole expanded window
        allow = jnp.logical_and(ni >= 0, node_mask[jnp.maximum(ni, 0)])
        res_d, res_i, res_x = rank_topk_merge_sorted(
            res_d,
            res_i,
            res_x,
            jnp.where(allow, nd, _INF),
            jnp.where(allow, ni, -1),
        )
        beam_d, beam_i, beam_x = _merge(
            beam_d, beam_i, beam_x, nd, ni
        )
        beam_x = jnp.logical_or(beam_x, jnp.logical_not(jnp.isfinite(beam_d)))
        nsel, nactive = frontier(beam_d, beam_i, beam_x)
        return (
            beam_d, beam_i, beam_x, res_d, res_i, res_x,
            nsel, nactive, jnp.any(nactive), it + 1,
        )

    sel0, active0 = frontier(beam_d, beam_i, beam_x)
    if use_mask:
        carry = (
            beam_d, beam_i, beam_x, res_d, res_i, res_x,
            sel0, active0, jnp.any(active0), jnp.int32(0),
        )
        out = jax.lax.while_loop(cond, body_m, carry)
        res_d, res_i, iters = out[3], out[4], out[-1]
        # dedup: a node evicted from the beam can be re-encountered later
        # and collected twice; keep the first (sorted) occurrence
        kp = res_d.shape[1]
        eq = res_i[:, :, None] == res_i[:, None, :]
        earlier = (jnp.arange(kp)[:, None] > jnp.arange(kp)[None, :])[None]
        dup = jnp.logical_and(
            jnp.any(jnp.logical_and(eq, earlier), axis=-1), res_i >= 0
        )
        res_d = jnp.where(dup, _INF, res_d)
        res_i = jnp.where(dup, -1, res_i)
        from tpuvec.ops.sort import bitonic_sort

        res_d, res_i = bitonic_sort(res_d, res_i)
        return res_d, res_i, iters

    beam_d, beam_i, beam_x, _, _, _, iters = jax.lax.while_loop(
        cond,
        body,
        (beam_d, beam_i, beam_x, sel0, active0, jnp.any(active0), jnp.int32(0)),
    )
    return beam_d, beam_i, iters


# --------------------------------------------------------------------------
# Full search
# --------------------------------------------------------------------------


def default_max_iters(ef: int, n_expand: int) -> int:
    return -(-3 * ef // (2 * n_expand)) + 8


@partial(
    jax.jit,
    static_argnames=("config", "k", "ef", "max_iters", "n_expand"),
)
def search_graph(
    config: HnswConfig,
    state: GraphState,
    q: jnp.ndarray,
    *,
    k: int,
    ef: int | None = None,
    max_iters: int | None = None,
    n_expand: int = 1,
    filter_mask: jnp.ndarray | None = None,
):
    """Batched k-NN over the graph in *internal* distance space.

    q [B, Dp] must already be prepared (prepare_queries). Returns
    (dists [B, k], ids [B, k]) ascending; empty index -> (inf, -1).
    ef defaults to max(ef_search, k) (reference search.rs:280).
    ``filter_mask`` [cap] bool restricts *results* (not traversal) to
    mask-passing nodes — in-beam filtered search (see beam_search_level0).
    """
    ef = max(ef or config.ef_search, k)
    if max_iters is None:
        max_iters = default_max_iters(ef, n_expand)
    seed_ids, seed_d = descend_to_level1(config, state, q)
    beam_d, beam_i, _ = beam_search_level0(
        config,
        state,
        q,
        seed_ids,
        seed_d,
        ef=ef,
        max_iters=max_iters,
        n_expand=n_expand,
        node_mask=filter_mask,
        k_out=k,
    )
    out_d = beam_d[:, :k]
    out_i = beam_i[:, :k]
    empty = state.entry_point < 0
    out_d = jnp.where(empty, _INF, out_d)
    out_i = jnp.where(empty, -1, out_i)
    return out_d, out_i


def search(
    config: HnswConfig,
    state: GraphState,
    q: jnp.ndarray,
    *,
    k: int,
    ef: int | None = None,
    n_expand: int = 1,
):
    """User-facing search: internal distances converted to the output
    metric (reference search.rs:330-334 + mod.rs:139-146)."""
    d, i = search_graph(config, state, q, k=k, ef=ef, n_expand=n_expand)
    out = internal_to_output(config.metric, d, normalized=config.normalized)
    return jnp.where(jnp.isfinite(d), out, _INF), i
