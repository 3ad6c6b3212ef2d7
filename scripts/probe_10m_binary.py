"""BASELINE config 4: binary[1024] Hamming coarse search + rerank at 10M.

The index stores mean-threshold sign bits (32 packed u32 words/row,
1.28 GB at 10M — the composition the reference has the pieces for:
bit vectors + Hamming + vec_quantize_binary, reference
src/vector.rs:579-608) and reranks the coarse top-C on device against an
int8 shadow of the originals (10.2 GB; per-row scale cancels in cosine,
so plain symmetric int8 is exact enough to recover f32-level ordering).

Ground truth is FULL-f32 cosine, streamed in chunks (40 GB never lives
on the device; the same pass builds the int8 shadow).

Phases are idempotent and checkpointed to .scratch/ in the checkout, so
an interrupted run resumes at the current segment:
  prepare: packed bit vectors -> .scratch/tpuvec_10m_bin_vectors_v2_N.npy
  build:   graph arrays       -> .scratch/tpuvec_10m_bin_ckpt_v2_N.npz (+ .json)
  search:  GT + sweeps (no checkpoint; reruns are cheap)

Runs on one GPU; refuses any other platform.
"""

import dataclasses
import json
from functools import partial
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np
import jax
import jax.numpy as jnp

from tpuvec.index import HnswParams
from tpuvec.index.build import build_graph
from tpuvec.index.graph import GraphState, allocate, config_for, prepare_vectors
from tpuvec.index.search import search_graph
from tpuvec.ops.rerank import rerank_topk
from tpuvec.types import DistanceMetric, IndexQuantization
from tpuvec.utils.data import synthetic_embeddings

N = int(os.environ.get("TPUVEC_BIN_N", 10_000_000))
D, K, QN, REPS = 1024, 10, 256, 3
SEG = int(os.environ.get("TPUVEC_10M_SEG", 262_144))
# packed bits are always prepared at 10M and sliced: smaller-N runs
# (TPUVEC_BIN_N) reuse the same corpus prefix
SCRATCH = os.path.join(_ROOT, ".scratch")
VEC_NPY = os.path.join(SCRATCH, f"tpuvec_10m_bin_vectors_v2_{N}.npy")
CKPT = os.path.join(SCRATCH, f"tpuvec_10m_bin_ckpt_v2_{N}.npz")
SIDE = CKPT + ".json"
GEN_CHUNK = 250_000  # f32 rows per streamed chunk (1 GB)
_CKPT_FIELDS = [
    "adj0", "adj0_dist", "levels", "upper_slot", "upper_nodes",
    "upper_adj", "upper_dist", "entry_point", "entry_level", "count",
    "upper_count",
]


def log(*a):
    print(*a, flush=True)


def get_cfg():
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    return config_for(
        D, metric=DistanceMetric.COSINE,
        quantization=IndexQuantization.BINARY, params=params, cap=N,
    )


def gen_chunk(start: int, rows: int, extra: int = 0) -> np.ndarray:
    """Deterministic data rows [start, start+rows) (+extra for queries).

    synthetic_embeddings is seeded per call; generating the full 10M in
    one call costs 40 GB of host RAM, so rows are derived from a
    per-chunk seed instead — chunk boundaries are fixed, so the same
    (start, rows) always yields the same data.
    """
    # structure_seed: ALL chunks must share one manifold (basis/centers)
    # or nearest neighbors across chunks are meaningless
    return synthetic_embeddings(
        rows + extra, D, n_clusters=1024,
        seed=10_000 + start // GEN_CHUNK, structure_seed=77,
    )


def queries():
    return gen_chunk(N, GEN_CHUNK)[: QN * (REPS + 1)]


def phase_prepare(cfg) -> np.ndarray:
    if os.path.exists(VEC_NPY):
        log("prepare: cached")
        return np.load(VEC_NPY, mmap_mode="r")[:N]
    words = -(-D // 32)
    out = np.empty((N, cfg.padded_dim), dtype=np.uint32)
    t0 = time.time()
    for start in range(0, N, GEN_CHUNK):
        rows = min(GEN_CHUNK, N - start)
        x = gen_chunk(start, rows)
        for i in range(0, rows, 32768):
            blk = prepare_vectors(cfg, jnp.asarray(x[i : i + 32768]))
            out[start + i : start + i + blk.shape[0]] = np.asarray(blk)
        log(f"prepare: {start + rows}/{N} ({time.time() - t0:.0f}s)")
    np.save(VEC_NPY, out)
    assert out.shape[1] == words or out.shape[1] >= words
    return out


def phase_build(cfg, packed: np.ndarray) -> GraphState:
    from tpuvec.utils.transfer import to_device_chunked

    xp_dev = to_device_chunked(np.ascontiguousarray(packed))
    state, pos, secs = None, 0, 0.0
    if os.path.exists(CKPT) and os.path.exists(SIDE):
        with open(SIDE) as f:
            side = json.load(f)
        z = np.load(CKPT)
        pos, secs = int(side["pos"]), float(side["secs"])
        fields = {f: jnp.asarray(z[f]) for f in _CKPT_FIELDS}
        mask = (np.arange(N) < pos)[:, None]
        fields["vectors"] = jnp.where(jnp.asarray(mask), xp_dev, 0)
        state = GraphState(**fields)
        log(f"build: resumed at {pos}/{N} ({secs:.0f}s spent)")
    if state is None:
        state = allocate(cfg)
    while pos < N:
        take = min(SEG, N - pos)
        t0 = time.time()
        state = build_graph(
            cfg, xp_dev[pos : pos + take],
            ids=np.arange(pos, pos + take, dtype=np.int32),
            max_batch=1024, state=state, start_size=max(pos, 1),
        )
        state.count.block_until_ready()
        secs += time.time() - t0
        pos += take
        arrays = {f: np.asarray(getattr(state, f)) for f in _CKPT_FIELDS}
        np.savez(CKPT + ".tmp.npz", **arrays)
        os.replace(CKPT + ".tmp.npz", CKPT)
        with open(SIDE + ".tmp", "w") as f:
            json.dump({"pos": pos, "secs": secs}, f)
        os.replace(SIDE + ".tmp", SIDE)
        log(f"build: {pos}/{N} ({pos / max(secs, 1e-9):.0f} vec/s)")
    log(f"build: stopped at {pos} ({pos / max(secs, 1e-9):.0f} vec/s over {secs:.0f}s)")
    del xp_dev
    return state, pos


@jax.jit
def _chunk_gt(qf, chunk):
    cn = jnp.linalg.norm(chunk, axis=-1)
    dots = jnp.einsum(
        "qd,nd->qn", qf, chunk, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    qd = jnp.linalg.norm(qf, axis=-1)[:, None]
    sim = dots / jnp.maximum(qd * cn[None, :], 1e-30)
    d = 1.0 - sim
    negd, ii = jax.lax.top_k(-d, K)
    return -negd, ii


@jax.jit
def _quant_int8(chunk):
    scale = jnp.max(jnp.abs(chunk), axis=-1, keepdims=True)
    return jnp.round(chunk / jnp.maximum(scale, 1e-30) * 127).astype(jnp.int8)


@partial(jax.jit, donate_argnames=("shadow",))
def _shadow_write(shadow, blk, start):
    return jax.lax.dynamic_update_slice(shadow, blk, (start, 0))


def phase_search(cfg, state, built_n: int) -> list:
    """Measure coarse + reranked search; returns [(label, recall, qps)]
    rows (consumed by scripts/bench_suite.py config 4)."""
    qpool = queries()
    qf = jnp.asarray(qpool[:QN])
    # one streamed pass over the BUILT prefix: full-f32 ground truth +
    # int8 shadow (written in place via donation — a concat would
    # transiently need 2x 10 GB).
    gt_d = np.full((QN, K), np.inf, np.float32)
    gt_i = np.full((QN, K), -1, np.int64)
    shadow = jnp.zeros((N, D), jnp.int8)
    t0 = time.time()
    for start in range(0, built_n, GEN_CHUNK):
        rows = min(GEN_CHUNK, built_n - start)
        x = gen_chunk(start, rows)
        for i in range(0, rows, 125_000):
            blk = jnp.asarray(x[i : i + 125_000])
            shadow = _shadow_write(shadow, _quant_int8(blk), start + i)
            d_c, i_c = _chunk_gt(qf, blk)
            d_c = np.asarray(d_c)
            i_c = np.asarray(i_c) + start + i
            alld = np.concatenate([gt_d, d_c], axis=1)
            alli = np.concatenate([gt_i, i_c], axis=1)
            sel = np.argsort(alld, axis=1, kind="stable")[:, :K]
            gt_d = np.take_along_axis(alld, sel, 1)
            gt_i = np.take_along_axis(alli, sel, 1)
        log(f"gt+shadow: {start + rows}/{built_n} ({time.time() - t0:.0f}s)")
    shadow.block_until_ready()
    return _phase_search_sweeps(cfg, state, built_n, gt_i, shadow, qpool, qf)


def _phase_search_sweeps(cfg, state, built_n, gt_i, shadow, qpool, qf) -> list:
    results = []
    log(f"shadow on device: {shadow.nbytes / 2**30:.1f} GiB")

    def recall(found):
        return sum(
            len(set(found[b].tolist()) & set(gt_i[b].tolist()))
            for b in range(QN)
        ) / (QN * K)

    qp = prepare_vectors(cfg, jnp.asarray(qpool[:QN]))
    rep_q = [
        (
            prepare_vectors(
                cfg, jnp.asarray(qpool[(i + 1) * QN : (i + 2) * QN])
            ),
            jnp.asarray(qpool[(i + 1) * QN : (i + 2) * QN]),
        )
        for i in range(REPS)
    ]
    jax.block_until_ready(rep_q)

    log("--- coarse Hamming only ---")
    for ef, mi in ((64, 64), (128, None)):
        d_h, i_h = search_graph(cfg, state, qp, k=K, ef=ef, max_iters=mi)
        i_h.block_until_ready()
        t0 = time.time()
        outs = [
            search_graph(cfg, state, rq, k=K, ef=ef, max_iters=mi)[1]
            for rq, _ in rep_q
        ]
        jax.block_until_ready(outs)
        dt = (time.time() - t0) / REPS
        r = recall(np.asarray(i_h))
        results.append((f"coarse Hamming ef={ef}", r, QN / dt))
        log(
            f"ef={ef} iters={mi} recall={r:.4f} "
            f"{dt * 1e3:.1f} ms/batch {QN / dt:.0f} QPS"
        )

    log("--- Hamming coarse + device int8 rerank ---")
    for ef, mi, c in ((64, 64, 48), (128, None, 96), (256, None, 192)):
        def run(qq, qqf):
            _, ii = search_graph(cfg, state, qq, k=c, ef=ef, max_iters=mi)
            return rerank_topk(
                shadow, ii, ii >= 0, qqf, metric=DistanceMetric.COSINE, k=K
            )
        d_h, i_h = run(qp, qf)
        i_h.block_until_ready()
        t0 = time.time()
        outs = [run(rq, rqf)[1] for rq, rqf in rep_q]
        jax.block_until_ready(outs)
        dt = (time.time() - t0) / REPS
        r = recall(np.asarray(i_h))
        results.append((f"Hamming + int8 rerank ef={ef} C={c}", r, QN / dt))
        log(
            f"ef={ef} iters={mi} C={c} recall={r:.4f} "
            f"{dt * 1e3:.1f} ms/batch {QN / dt:.0f} QPS"
        )

    log("--- Hamming coarse + one-hop expansion + int8 rerank ---")
    # the coarse beam ranks in Hamming space, so true neighbors just
    # outside the top-C are usually graph-adjacent to ones inside it:
    # reranking C*(M0+1) expanded candidates recovers them far cheaper
    # than a deeper beam (ops/rerank.py expand_rerank_topk)
    from tpuvec.ops.rerank import expand_rerank_topk

    live = jnp.asarray(np.arange(N) < built_n)
    for ef, mi, c in ((64, 64, 24), (64, 64, 48), (128, None, 96)):
        def run_x(qq, qqf):
            _, ii = search_graph(cfg, state, qq, k=c, ef=ef, max_iters=mi)
            return expand_rerank_topk(
                shadow, state.adj0, ii, ii >= 0, qqf,
                metric=DistanceMetric.COSINE, k=K, filter_mask=live,
            )
        d_h, i_h = run_x(qp, qf)
        i_h.block_until_ready()
        t0 = time.time()
        outs = [run_x(rq, rqf)[1] for rq, rqf in rep_q]
        jax.block_until_ready(outs)
        dt = (time.time() - t0) / REPS
        r = recall(np.asarray(i_h))
        results.append(
            (f"Hamming + 1-hop expand + int8 rerank ef={ef} C={c}", r, QN / dt)
        )
        log(
            f"ef={ef} iters={mi} C={c} EXPAND recall={r:.4f} "
            f"{dt * 1e3:.1f} ms/batch {QN / dt:.0f} QPS"
        )
    return results


def main():
    from tpuvec.utils.device import card_info, require_gpu
    from tpuvec.utils.safecache import configure_compilation_cache

    devs = require_gpu()
    log(f"card: {card_info()[0]}; jax: {devs[0].device_kind} x{len(devs)}")
    configure_compilation_cache()
    os.makedirs(SCRATCH, exist_ok=True)
    cfg = get_cfg()
    log(f"config 4: {N}x{D} binary, cap_u={cfg.cap_u}")
    packed = phase_prepare(cfg)
    state, built_n = phase_build(cfg, packed)
    del packed
    if os.environ.get("TPUVEC_10M_BUILD_ONLY") == "1":
        log("build-only run: skipping search phase")
        return []
    # free what search never reads: adj0_dist (1.28 GB of reverse-prune
    # bookkeeping only the build uses)
    state = dataclasses.replace(state, adj0_dist=jnp.zeros((1, 1)))
    return phase_search(cfg, state, built_n)


if __name__ == "__main__":
    main()
