"""Smoke run of tpuvec's main path on one GPU: the quickest proof that the
system starts and answers correctly on the card.

Drives the user entry points (``VecTable`` and ``tpuvec.sql.connect``) at
BASELINE config 2's width — 100K x 768 cosine, the reference's envelope
"query 2-5 ms k=10 @100K x 768D" (reference CHANGELOG.md:92-96) — and
holds every answer to a plain numpy reference computed on the host:

  1. device    JAX's first device must be a GPU; prints the card
  2. main      100K x 768 f32 HNSW table with 1,024 tenants: insert_many,
               knn_many recall@10 >= 0.95, partition-filtered purity 1.0
  3. exact     the ENN scan over the same rows against float64 numpy
  4. quant     int8 index + device f32 rerank, binary Hamming + rerank
               (1024-d), and the integer products bit-exact vs int64 numpy
  5. sql       vec0 INSERT / MATCH / UPDATE / DELETE / BEGIN..ROLLBACK
  6. snapshot  save + load of the phase-2 table, identical query ids
  7. determinism  two builds of one table, adjacency compared (reported)
  8. memory    compiled memory_analysis of the search step and one insert
               stage, peak device bytes after phase 2

Any failed check raises, so the script exits non-zero; the last line of
stdout is one JSON object naming the device, printed only on success.

Usage (from the repository root):
    python chip_smoke.py           # one GPU, phases 1-8
    python chip_smoke.py --multi   # four GPUs: the mesh-backed table only
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from tpuvec.index.params import HnswParams
from tpuvec.store import ColumnSpec, VecTable
from tpuvec.types import DistanceMetric, IndexQuantization

# f32 products in the library run at Precision.HIGHEST (full f32, not
# TF32), so the exact scan agrees with float64 numpy to f32 rounding:
# rtol 1e-5, plus an absolute 1e-6 — eight f32 ulps of the unit-norm
# terms of |q|^2 + |x|^2 - 2 q.x, whose cancellation leaves that much
# absolute error on small distances (TF32 would be ~1e-3)
EXACT_RTOL = 1e-5
EXACT_ATOL = 1e-6
# a returned id may differ from the reference's only where its true
# distance is this close to the reference's k-th distance (a tie)
TIE_GAP = 1e-5

_ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(_ROOT, ".scratch")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths are the configs' own; row counts are the cut listed in the
    output as ``reduced`` (config 3 and 4 run at 20K rows, not 1M/10M)."""

    n: int = 100_000          # config 2 rows
    d: int = 768              # config 2 width
    tenants: int = 1024       # config 5 tenant count
    queries: int = 256
    filtered: int = 32
    reps: int = 3             # timed query batches after the first
    k: int = 10
    ef: int = 64
    quant_n: int = 20_000     # configs 3/4 rows (cut from 1M / 10M)
    quant_d: int = 1024       # configs 3/4 width
    coarse_k: int = 96        # int8 candidates reranked in f32
    product_q: int = 64       # queries in the exact integer-product check
    sql_n: int = 2_000
    det_n: int = 20_000
    multi_n: int = 16_384
    params: HnswParams = HnswParams(
        m=16, max_m0=32, ef_construction=200, ef_search=64
    )


class CompileClock:
    """Sums JAX's compile-stage durations (trace, lowering, XLA backend
    compile) reported through jax.monitoring while it is registered."""

    _EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        self.by_program: dict[str, float] = {}

    def __call__(self, event, duration, fun_name="?", **_):
        if event in self._EVENTS:
            self.seconds += duration
            name = fun_name.removeprefix("jit(").removesuffix(")")
            self.by_program[name] = self.by_program.get(name, 0.0) + duration

    def top(self, n: int = 8) -> str:
        worst = sorted(self.by_program.items(), key=lambda kv: -kv[1])[:n]
        return ", ".join(f"{k} {v:.1f}s" for k, v in worst)

    def __enter__(self):
        jax.monitoring.register_event_duration_secs_listener(self)
        return self

    def __exit__(self, *exc):
        jax.monitoring.unregister_event_duration_listener(self)


@dataclasses.dataclass
class Ctx:
    sizes: Sizes
    card: str = "card not read"
    clock: CompileClock = dataclasses.field(default_factory=CompileClock)

    def out(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}", flush=True)

    def timed(self, phase: str, what: str, seconds: float) -> None:
        self.out(phase, f"{what}: {seconds:.3f} s [{self.card}]")


class SmokeFailure(AssertionError):
    """A phase's result disagrees with its reference."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ #
# plain host references (numpy only, independent of tpuvec.ops)
# ------------------------------------------------------------------ #


def cosine_dists_np(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Exact cosine distance [B, N] in float64."""
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    return 1.0 - qn @ xn.T


def topk_np(dist: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Smallest k per row, ascending (stable on ties)."""
    part = np.argpartition(dist, k - 1, axis=1)[:, :k]
    d = np.take_along_axis(dist, part, 1)
    order = np.lexsort((part, d), axis=1)
    ids = np.take_along_axis(part, order, 1)
    return np.take_along_axis(dist, ids, 1), ids


def recall_np(found: np.ndarray, truth: np.ndarray) -> float:
    hits = sum(
        len(set(f[f >= 0].tolist()) & set(t.tolist()))
        for f, t in zip(found, truth)
    )
    return hits / truth.size


def filtered_recall_np(found: np.ndarray, dist: np.ndarray, k: int) -> float:
    """recall@k against the exact top-k of ``dist`` (inf = filtered out),
    counting only reference entries that pass the filter."""
    d, ref = topk_np(dist, k)
    hits = total = 0
    for f, r, dd in zip(found, ref, d):
        truth = set(r[np.isfinite(dd)].tolist())
        hits += len(truth & set(f.tolist()))
        total += len(truth)
    return hits / max(total, 1)


def tie_aware_mismatch(found: np.ndarray, ref_ids: np.ndarray,
                       dist: np.ndarray) -> int:
    """Count returned ids absent from the reference top-k whose true
    distance is NOT within TIE_GAP of the reference's k-th distance."""
    bad = 0
    for b in range(found.shape[0]):
        kth = dist[b, ref_ids[b, -1]]
        for i in set(found[b].tolist()) - set(ref_ids[b].tolist()):
            if i < 0 or abs(dist[b, i] - kth) >= TIE_GAP:
                bad += 1
    return bad


def popcount_u32_np(w: np.ndarray) -> np.ndarray:
    """Bits set per uint32 word, as int64."""
    b = np.unpackbits(np.ascontiguousarray(w).view(np.uint8).reshape(*w.shape, 4), axis=-1)
    return b.sum(axis=-1, dtype=np.int64)


def ids_of(results) -> np.ndarray:
    """knn_many results -> [B, k] rowids (-1 where fewer came back)."""
    k = max((len(r) for r in results), default=0)
    out = np.full((len(results), max(k, 1)), -1, dtype=np.int64)
    for b, r in enumerate(results):
        out[b, : len(r)] = [x.rowid for x in r]
    return out


def dists_of(results) -> np.ndarray:
    k = max((len(r) for r in results), default=0)
    out = np.full((len(results), max(k, 1)), np.inf)
    for b, r in enumerate(results):
        out[b, : len(r)] = [x.distance for x in r]
    return out


def _data(sz: Sizes, n: int, d: int, seed: int):
    from tpuvec.utils.data import synthetic_embeddings

    pool = sz.queries * (1 + sz.reps)
    a = synthetic_embeddings(n + pool, d, seed=seed)
    return a[:n], a[n:]


# ------------------------------------------------------------------ #
# phases
# ------------------------------------------------------------------ #


def phase_device(ctx: Ctx, n_devices: int = 1) -> list:
    from tpuvec.utils.device import card_info, require_gpu

    devs = require_gpu()
    ctx.out("device", f"jax: platform={devs[0].platform} "
            f"kind={devs[0].device_kind} count={len(devs)}")
    check(len(devs) >= n_devices,
          f"needs {n_devices} GPUs, JAX found {len(devs)}")
    cards = card_info()
    for line in cards:
        ctx.out("device", f"nvidia-smi name,power.limit: {line}")
    ctx.card = cards[0]
    return devs


def phase_main(ctx: Ctx) -> dict:
    """f32 HNSW table through insert_many / knn_many, recall and filtered
    purity against float64 numpy."""
    sz = ctx.sizes
    x, qpool = _data(sz, sz.n, sz.d, seed=0)
    tenant = np.random.default_rng(1).integers(0, sz.tenants, sz.n)
    t = VecTable(
        "docs",
        [
            ColumnSpec.vector("emb", sz.d, metric=DistanceMetric.COSINE,
                              params=sz.params),
            ColumnSpec.partition_key("tenant"),
            ColumnSpec.metadata("label"),
        ],
        initial_cap=sz.n,
    )
    c0 = ctx.clock.seconds
    t0 = time.perf_counter()
    t.insert_many(
        [{"emb": x[i], "tenant": int(tenant[i]), "label": f"l{i % 16}"}
         for i in range(sz.n)],
        rowids=range(sz.n),
    )
    jax.block_until_ready(t.vector_cols["emb"].state.count)
    ctx.timed("main", f"build wall, {sz.n}x{sz.d} insert_many "
              "(compiles included)", time.perf_counter() - t0)
    ctx.timed("main", "build compile", ctx.clock.seconds - c0)
    check(len(t) == sz.n and t.integrity_check() == [],
          f"table holds {len(t)} rows, integrity {t.integrity_check()}")

    q = qpool[: sz.queries]
    c0 = ctx.clock.seconds
    t0 = time.perf_counter()
    res = t.knn_many("emb", list(q), k=sz.k, ef=sz.ef)
    first = time.perf_counter() - t0
    ctx.timed("main", "search compile", ctx.clock.seconds - c0)
    ctx.timed("main", f"first knn_many batch of {sz.queries} "
              "(compile included)", first)
    steady = []
    for r in range(sz.reps):
        qr = qpool[(r + 1) * sz.queries : (r + 2) * sz.queries]
        t0 = time.perf_counter()
        t.knn_many("emb", list(qr), k=sz.k, ef=sz.ef)
        steady.append(time.perf_counter() - t0)
    ctx.timed("main", f"knn_many batch of {sz.queries}, k={sz.k}, "
              f"ef={sz.ef} (median of {sz.reps}, end to end)",
              statistics.median(steady))

    dist = cosine_dists_np(q, x)
    _, ref = topk_np(dist, sz.k)
    ids = ids_of(res)
    rec = recall_np(ids, ref)
    ctx.out("main", f"recall@{sz.k} = {rec:.4f} at ef={sz.ef} "
            "(vs float64 numpy exact; gate >= 0.95)")
    check(rec >= 0.95, f"recall@{sz.k} {rec:.4f} < 0.95")

    # per-query tenants: one dispatch, each query its own partition
    fq = q[: sz.filtered]
    ft = [int(tenant[(b * 97) % sz.n]) for b in range(sz.filtered)]
    fres = t.knn_many("emb", list(fq), k=sz.k, partition=ft)
    fids = ids_of(fres)
    pure = all(tenant[i] == ft[b] for b, row in enumerate(fids)
               for i in row if i >= 0)
    fd = np.where(tenant[None, :] == np.array(ft)[:, None],
                  dist[: sz.filtered], np.inf)
    frec = filtered_recall_np(fids, fd, sz.k)
    ctx.out("main", f"filtered: {sz.filtered} queries, purity "
            f"{1.0 if pure else 0.0:.1f}, recall@{sz.k} {frec:.4f} vs the "
            "filtered exact answer (gates: purity 1.0, recall >= 0.99)")
    check(pure, "a filtered query returned another tenant's row")
    check(frec >= 0.99, f"filtered recall {frec:.4f} < 0.99")

    stats = jax.devices()[0].memory_stats()
    peak = stats.get("peak_bytes_in_use") if stats else None
    ctx.out("main", "peak_bytes_in_use after phase 2: "
            f"{peak if peak is not None else 'not reported by backend'}")
    return {"table": t, "x": x, "q": q, "dist": dist, "ids": ids}


def phase_exact(ctx: Ctx, main: dict) -> None:
    """The ENN scan (exact=True) over the phase-2 rows against numpy."""
    sz = ctx.sizes
    t, dist = main["table"], main["dist"]
    res = t.knn_many("emb", list(main["q"]), k=sz.k, exact=True)
    ids, got = ids_of(res), dists_of(res)
    _, ref = topk_np(dist, sz.k)
    bad = tie_aware_mismatch(ids, ref, dist)
    true_d = np.take_along_axis(dist, np.maximum(ids, 0), 1)
    aerr = np.abs(got - true_d)
    rerr = np.max(aerr / np.maximum(np.abs(true_d), 1e-30))
    ctx.out("exact", f"{sz.queries} queries over {sz.n}x{sz.d}: {bad} ids "
            f"outside the reference top-{sz.k} beyond a {TIE_GAP:g} tie gap; "
            f"max distance error {np.max(aerr):.2e} absolute, {rerr:.2e} "
            f"relative (gate rtol {EXACT_RTOL:g} + atol {EXACT_ATOL:g}; "
            "f32 products at Precision.HIGHEST)")
    check(bad == 0, f"{bad} exact-scan ids differ from the reference")
    check(np.allclose(got, true_d, rtol=EXACT_RTOL, atol=EXACT_ATOL),
          f"exact-scan distances off by up to {np.max(aerr):.2e}")


def phase_quantized(ctx: Ctx) -> None:
    """int8 and binary index columns at the configs' 1024-d width."""
    from tpuvec.index.build import _pairwise_cands
    from tpuvec.index.graph import prepare_vectors
    from tpuvec.ops.distance import _dot, hamming_pairwise
    from tpuvec.ops.rerank import rerank_topk

    sz = ctx.sizes
    ctx.out("quant", f"reduced: {sz.quant_n} rows per column "
            "(configs 3/4 specify 1M and 10M); width 1024 as specified")
    x, qpool = _data(sz, sz.quant_n, sz.quant_d, seed=3)
    q = qpool[: sz.queries]
    _, ref = topk_np(cosine_dists_np(q, x), sz.k)
    rows = [{"emb": v} for v in x]

    # config 3: int8 index, coarse candidates reranked in f32 on device
    t8 = VecTable("q8", [ColumnSpec.vector(
        "emb", sz.quant_d, metric=DistanceMetric.COSINE, params=sz.params,
        quantization=IndexQuantization.INT8)], initial_cap=sz.quant_n)
    t0 = time.perf_counter()
    t8.insert_many(rows, rowids=range(sz.quant_n))
    ctx.timed("quant", f"int8 build wall, {sz.quant_n}x{sz.quant_d}",
              time.perf_counter() - t0)
    coarse = ids_of(t8.knn_many("emb", list(q), k=sz.coarse_k,
                                ef=max(sz.ef, sz.coarse_k)))
    xf = jnp.asarray(x)
    cand = jnp.asarray(coarse.astype(np.int32))
    _, rr = rerank_topk(xf, cand, cand >= 0, jnp.asarray(q),
                        metric=DistanceMetric.COSINE, k=sz.k)
    rec8 = recall_np(np.asarray(rr), ref)
    ctx.out("quant", f"int8 + device f32 rerank (C={sz.coarse_k}): "
            f"recall@{sz.k} {rec8:.4f} vs f32 exact (gate >= 0.95)")
    check(rec8 >= 0.95, f"int8 + rerank recall {rec8:.4f} < 0.95")

    # s8 x s8 -> s32 products: bit-exact against int64 numpy
    vc8 = t8.vector_cols["emb"]
    x8 = np.asarray(vc8.state.vectors[: sz.quant_n])
    q8 = np.asarray(prepare_vectors(vc8.config, jnp.asarray(q[: sz.product_q])))
    got = np.asarray(jax.jit(lambda a, b: _dot(a, b.T, True))(q8, x8))
    want = q8.astype(np.int64) @ x8.astype(np.int64).T
    check(got.dtype == np.int32 and np.array_equal(got.astype(np.int64), want),
          "int8 dot_general differs from the int64 reference")
    ctx.out("quant", f"int8 dot_general [{sz.product_q}x{x8.shape[1]}] x "
            f"[{x8.shape[1]}x{sz.quant_n}] -> int32: bit-exact vs int64 numpy")

    # config 4: binary index, Hamming coarse search + f32 rerank
    tb = VecTable("qb", [ColumnSpec.vector(
        "emb", sz.quant_d, metric=DistanceMetric.COSINE, params=sz.params,
        quantization=IndexQuantization.BINARY)], initial_cap=sz.quant_n)
    t0 = time.perf_counter()
    tb.insert_many(rows, rowids=range(sz.quant_n))
    ctx.timed("quant", f"binary build wall, {sz.quant_n}x{sz.quant_d}",
              time.perf_counter() - t0)
    vcb = tb.vector_cols["emb"]
    check(vcb.shadow is not None, "binary column has no device f32 shadow")
    recb = recall_np(ids_of(tb.knn_many("emb", list(q), k=sz.k)), ref)
    ctx.out("quant", f"binary Hamming + expand + device f32 rerank: "
            f"recall@{sz.k} {recb:.4f} vs f32 exact (gate >= 0.90)")
    check(recb >= 0.90, f"binary + rerank recall {recb:.4f} < 0.90")

    xw = np.asarray(vcb.state.vectors[: sz.quant_n])
    qw = np.asarray(prepare_vectors(vcb.config, jnp.asarray(q[: sz.product_q])))
    got = np.asarray(jax.jit(hamming_pairwise)(qw, xw))
    want = np.stack([popcount_u32_np(w ^ xw).sum(-1) for w in qw])
    check(np.array_equal(got.astype(np.int64), want),
          "Hamming +-1 matmul differs from the popcount reference")
    cw = xw[: 2 * sz.params.max_m0 * 3][None]  # [1, C, W] candidates
    got = np.asarray(jax.jit(_pairwise_cands, static_argnums=0)(
        vcb.config, jnp.asarray(cw)))
    want = popcount_u32_np(cw[0][:, None, :] ^ cw[0][None, :, :]).sum(-1)
    check(np.array_equal(got[0].astype(np.int64), want),
          "build-time Hamming einsum differs from the popcount reference")
    ctx.out("quant", f"Hamming int8 matmul [{sz.product_q}x{sz.quant_n}] and "
            f"build einsum [{cw.shape[1]}x{cw.shape[1]}]: bit-exact vs numpy")


def phase_sql(ctx: Ctx) -> None:
    """The vec0 SQL surface against VecTable.knn on the same table."""
    from tpuvec.sql import connect

    sz = ctx.sizes
    x, qpool = _data(sz, sz.sql_n, sz.d, seed=5)
    db = connect()
    p = sz.params  # with phase 2's capacity: its insert programs are reused
    check(p.max_m0 == 2 * p.m, "DDL sets max_m0 = 2*M")
    db.execute(
        f"CREATE VIRTUAL TABLE docs USING vec0(emb float[{sz.d}] "
        f"hnsw(M={p.m}, ef_construction={p.ef_construction}, "
        f"ef_search={p.ef_search}, distance=cosine), label TEXT, "
        f"capacity={sz.n})"
    )
    db.executemany(
        "INSERT INTO docs(rowid, emb, label) VALUES (?, ?, ?)",
        [(i + 1, x[i].astype("<f4").tobytes(), f"l{i % 7}")
         for i in range(sz.sql_n)],
    )
    table = db.table("docs")
    check(len(table) == sz.sql_n, f"{len(table)} rows after INSERT")
    match = ("SELECT rowid, distance FROM docs WHERE emb MATCH ? AND k = "
             f"{sz.k} ORDER BY distance")

    def sql_knn(v):
        return db.execute(match, [np.asarray(v, "<f4").tobytes()]).fetchall()

    for v in qpool[:8]:
        rows = sql_knn(v)
        want = [(r.rowid, r.distance) for r in table.knn("emb", v, k=sz.k)]
        check([r[0] for r in rows] == [w[0] for w in want]
              and np.allclose([r[1] for r in rows], [w[1] for w in want]),
              "SQL MATCH rows differ from VecTable.knn")

    db.execute("UPDATE docs SET emb = ? WHERE rowid = ?",
               [qpool[8].astype("<f4").tobytes(), 3])
    top = sql_knn(qpool[8])[0]
    check(top[0] == 3 and top[1] < 1e-5, f"UPDATE not visible: top {top}")
    db.execute("DELETE FROM docs WHERE rowid = ?", [3])
    check(all(r[0] != 3 for r in sql_knn(qpool[8])) and
          len(table) == sz.sql_n - 1, "DELETE not applied")
    db.execute("BEGIN")
    db.execute("INSERT INTO docs(rowid, emb, label) VALUES (?, ?, ?)",
               [sz.sql_n + 10, qpool[9].astype("<f4").tobytes(), "new"])
    db.execute("ROLLBACK")
    check(len(table) == sz.sql_n - 1 and
          all(r[0] != sz.sql_n + 10 for r in sql_knn(qpool[9])),
          "ROLLBACK left the inserted row")
    check(table.integrity_check() == [], "integrity after SQL writes")
    ctx.out("sql", f"vec0 {sz.sql_n}x{sz.d}: INSERT, MATCH k={sz.k} (rows "
            "equal VecTable.knn), UPDATE, DELETE, BEGIN..ROLLBACK ok")


def phase_snapshot(ctx: Ctx, main: dict) -> None:
    """Save the phase-2 table, load it, same queries -> identical ids."""
    from tpuvec import native
    from tpuvec.store import snapshot

    sz = ctx.sizes
    t, q = main["table"], list(main["q"])
    engine = "native tvstore (csrc/tvstore.cpp)" if native.available() \
        else "np.savez fallback"
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "smoke_snapshot.tvs")
    try:
        t0 = time.perf_counter()
        snapshot.save(t, path)
        ctx.timed("snapshot", f"save ({engine})", time.perf_counter() - t0)
        t0 = time.perf_counter()
        t2 = snapshot.load(path)
        ctx.timed("snapshot", "load", time.perf_counter() - t0)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    before = ids_of(t.knn_many("emb", q, k=sz.k, ef=sz.ef))
    after = ids_of(t2.knn_many("emb", q, k=sz.k, ef=sz.ef))
    check(np.array_equal(before, after), "ids differ after snapshot reload")
    ctx.out("snapshot", f"written by the {engine}; {len(q)} queries give "
            "identical ids after reload")


def phase_determinism(ctx: Ctx) -> bool:
    """Build one table twice and compare the graphs (reported only)."""
    sz = ctx.sizes
    x, _ = _data(sz, sz.det_n, sz.d, seed=0)
    graphs = []
    for _ in range(2):
        # phase 2's capacity, so the compiled insert programs are reused
        t = VecTable("det", [ColumnSpec.vector(
            "emb", sz.d, metric=DistanceMetric.COSINE, params=sz.params)],
            initial_cap=sz.n)
        t.insert_many([{"emb": v} for v in x], rowids=range(sz.det_n))
        st = t.vector_cols["emb"].state
        graphs.append([np.asarray(a).tobytes() for a in
                       (st.adj0, st.adj0_dist, st.upper_adj, st.upper_dist)])
    same = graphs[0] == graphs[1]
    ctx.out("determinism", f"two builds of {sz.det_n}x{sz.d}: adjacency "
            f"{'byte-identical' if same else 'DIFFERS'} (reported, not gated)")
    return same


def phase_memory(ctx: Ctx, main: dict) -> None:
    """compiled.memory_analysis() of the search step and one insert stage."""
    from tpuvec.index.build import _stage_candidates
    from tpuvec.index.graph import prepare_vectors
    from tpuvec.index.search import search_graph

    sz = ctx.sizes
    vc = main["table"].vector_cols["emb"]
    qp = prepare_vectors(vc.config, jnp.asarray(main["q"]))
    steps = {
        f"search_graph B={sz.queries} ef={sz.ef}": search_graph.lower(
            vc.config, vc.state, qp, k=sz.k, ef=sz.ef),
        "insert stage 2 (candidates) B=256": _stage_candidates.lower(
            vc.config, vc.state, jnp.zeros((256, vc.config.padded_dim),
                                           jnp.float32)),
    }
    for name, lowered in steps.items():
        m = lowered.compile().memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes", "temp_size_in_bytes",
                  "generated_code_size_in_bytes")
        desc = ", ".join(f"{f}={getattr(m, f, 'n/a')}" for f in fields) \
            if m is not None else "not reported by backend"
        ctx.out("memory", f"{name}: {desc}")


def phase_multi(ctx: Ctx, n_devices: int = 4) -> None:
    """The mesh-backed table on ``n_devices`` cards against the
    single-device exact answer."""
    from tpuvec.index import bruteforce_knn
    from tpuvec.index.graph import config_for, prepare_vectors
    from tpuvec.parallel import make_mesh

    sz = ctx.sizes
    mesh = make_mesh(n_devices)
    x, qpool = _data(sz, sz.multi_n, sz.d, seed=7)
    q = qpool[: sz.queries]
    tenant = np.random.default_rng(2).integers(0, sz.tenants, sz.multi_n)
    t = VecTable("multi", [
        ColumnSpec.vector("emb", sz.d, metric=DistanceMetric.COSINE,
                          params=sz.params),
        ColumnSpec.partition_key("tenant"),
    ], mesh=mesh, initial_cap=2 * sz.multi_n)
    t0 = time.perf_counter()
    t.insert_many([{"emb": x[i], "tenant": int(tenant[i])}
                   for i in range(sz.multi_n)], rowids=range(sz.multi_n))
    ctx.timed("multi", f"partition-routed build wall, {sz.multi_n}x{sz.d} "
              f"over {n_devices} shards", time.perf_counter() - t0)

    vc = t.vector_cols["emb"]
    devs = {s.device for s in vc.idx.stacked.vectors.addressable_shards}
    rows = [s.data.shape[0] for s in vc.idx.stacked.vectors.addressable_shards]
    check(devs == set(mesh.devices.flat) and rows == [1] * n_devices,
          f"shards not one per device: {devs}, rows {rows}")
    ctx.out("multi", f"each shard's arrays on its own device: "
            f"{sorted(str(d) for d in devs)}")

    # the single-device exact answer: one card, the whole corpus
    cfg = config_for(sz.d, metric=DistanceMetric.COSINE, cap=sz.multi_n)
    dev0 = jax.devices()[0]
    xp = jax.device_put(prepare_vectors(cfg, jnp.asarray(x)), dev0)
    qp = jax.device_put(prepare_vectors(cfg, jnp.asarray(q)), dev0)
    sd, si = bruteforce_knn(qp, xp, jnp.ones(sz.multi_n, bool),
                            metric=cfg.graph_metric, k=sz.k,
                            normalized=cfg.normalized)
    single = np.asarray(si)
    dist = cosine_dists_np(q, x)

    t0 = time.perf_counter()
    hres = t.knn_many("emb", list(q), k=sz.k, ef=sz.ef)
    ctx.timed("multi", f"first all-shard knn_many batch of {sz.queries}",
              time.perf_counter() - t0)
    rec = recall_np(ids_of(hres), single)
    ctx.out("multi", f"all-shard HNSW + all-gather merge: recall@{sz.k} "
            f"{rec:.4f} vs the single-device exact answer (gate >= 0.95)")
    check(rec >= 0.95, f"mesh recall {rec:.4f} < 0.95")
    bad = tie_aware_mismatch(
        ids_of(t.knn_many("emb", list(q), k=sz.k, exact=True)), single, dist)
    ctx.out("multi", f"sharded exact scan: {bad} ids differ from the "
            f"single-device exact answer beyond a {TIE_GAP:g} tie gap")
    check(bad == 0, f"sharded exact scan differs in {bad} ids")

    fb = min(sz.filtered, 8)
    frec = []
    for b in range(fb):
        tb = int(tenant[(b * 97) % sz.multi_n])
        got = ids_of([t.knn("emb", q[b], k=sz.k, partition=tb)])
        check(all(tenant[i] == tb for i in got[0] if i >= 0),
              "mesh filtered query returned another tenant's row")
        fd = np.where(tenant == tb, dist[b], np.inf)[None]
        frec.append(filtered_recall_np(got, fd, sz.k))
    ctx.out("multi", f"filtered: {fb} tenants, purity 1.0, mean recall "
            f"{np.mean(frec):.4f} vs the filtered exact answer (gate >= 0.99)")
    check(np.mean(frec) >= 0.99, "mesh filtered recall < 0.99")

    gone = list(range(0, sz.multi_n, 97))
    t.delete_many(gone)
    t.update(1, {"emb": q[-1]})
    after = ids_of(t.knn_many("emb", list(q), k=sz.k, ef=sz.ef))
    check(not set(after.ravel().tolist()) & set(gone),
          "deleted rows still returned")
    top = t.knn("emb", q[-1], k=1)
    check(top and top[0].rowid == 1, f"updated row not found: {top}")
    check(t.integrity_check() == [], f"integrity: {t.integrity_check()}")
    ctx.out("multi", f"delete {len(gone)} rows, update 1 row, "
            "integrity_check ok")


def run_default(ctx: Ctx) -> list:
    devs = phase_device(ctx)
    from tpuvec.utils.safecache import configure_compilation_cache

    ctx.out("device", f"compile cache: {configure_compilation_cache()}")
    with ctx.clock:
        main = phase_main(ctx)
        phase_exact(ctx, main)
        phase_quantized(ctx)
        phase_sql(ctx)
        phase_snapshot(ctx, main)
        phase_determinism(ctx)
        phase_memory(ctx, main)
    ctx.timed("all", "compile total (trace + lower + XLA)", ctx.clock.seconds)
    ctx.out("all", f"compile by program: {ctx.clock.top()}")
    return devs


def run_multi(ctx: Ctx, n_devices: int = 4) -> list:
    devs = phase_device(ctx, n_devices)
    from tpuvec.utils.safecache import configure_compilation_cache

    ctx.out("device", f"compile cache: {configure_compilation_cache()}")
    with ctx.clock:
        phase_multi(ctx, n_devices)
    ctx.timed("all", "compile total (trace + lower + XLA)", ctx.clock.seconds)
    ctx.out("all", f"compile by program: {ctx.clock.top()}")
    return devs[:n_devices]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the mesh-backed table on four GPUs")
    args = ap.parse_args(argv)
    ctx = Ctx(Sizes())
    t0 = time.perf_counter()
    devs = run_multi(ctx) if args.multi else run_default(ctx)
    ctx.timed("all", "wall", time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
