"""tpuvec benchmark — prints ONE JSON line on stdout.

North-star metric (BASELINE.json): QPS at recall@10 >= 0.95 on
1M x 768 f32 (cosine), plus HNSW build vectors/sec. The single-core
reference baseline is ~357 QPS (the stated 2.8 ms/query parity
requirement, reference examples/performance_report.rs:247-250;
envelope reference CHANGELOG.md:92-96).

Runs on one GPU in one process: it refuses any other platform, prints
the card's name and power limit, builds the graph, then sweeps ef.

Environment knobs:
  TPUVEC_BENCH_N       corpus size (default 1_000_000)
  TPUVEC_BENCH_D       dimensions (default 768)
  TPUVEC_BENCH_Q       query batch (default 256)

Side info (card, build rate, sweep table) goes to stderr; stdout carries
exactly the one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N = int(os.environ.get("TPUVEC_BENCH_N", 1_000_000))
D = int(os.environ.get("TPUVEC_BENCH_D", 768))
QN = int(os.environ.get("TPUVEC_BENCH_Q", 256))
K = 10
REPS = 5
BASELINE_QPS = 357.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _config():
    from tpuvec.index import HnswParams
    from tpuvec.index.graph import config_for
    from tpuvec.types import DistanceMetric

    # M0=32 with efc=200 and the uncapped construction beam: the degree
    # trades gathered rows per beam iteration against recall per ef
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    return config_for(D, metric=DistanceMetric.COSINE, params=params, cap=N)


def main() -> None:
    import jax

    from tpuvec.utils.device import card_info, require_gpu

    devs = require_gpu()
    card = card_info()[0]
    log(f"card: {card}; jax: {devs[0].device_kind} x{len(devs)}")

    from tpuvec.utils.safecache import configure_compilation_cache

    configure_compilation_cache()
    import jax.numpy as jnp

    from tpuvec.index import bruteforce_knn
    from tpuvec.index.build import build_graph
    from tpuvec.index.graph import prepare_vectors
    from tpuvec.index.search import search_graph
    from tpuvec.utils.data import synthetic_embeddings
    from tpuvec.utils.transfer import prepare_vectors_device

    t_all = time.time()
    cfg = _config()
    log(f"corpus {N}x{D} f32 cosine k={K}")
    data = synthetic_embeddings(
        N + QN * (REPS + 1), D, n_clusters=1024 if N >= 500_000 else 256, seed=0
    )
    x, qpool = data[:N], data[N:]
    xp_dev = prepare_vectors_device(cfg, x)

    t0 = time.time()
    state = build_graph(cfg, xp_dev, max_batch=1024)
    state.count.block_until_ready()
    build_s = time.time() - t0
    log(f"build: {N} vectors in {build_s:.1f}s = {N / build_s:.0f} vec/s "
        f"(compiles included) [{card}]")

    qp = prepare_vectors(cfg, jnp.asarray(qpool[:QN]))
    _, gt_i = bruteforce_knn(
        qp, xp_dev, jnp.ones(N, bool), metric=cfg.graph_metric, k=K,
        normalized=cfg.normalized,
    )
    gt = np.asarray(gt_i)
    del xp_dev

    def recall(found):
        hits = sum(
            len(set(found[b].tolist()) & set(gt[b].tolist())) for b in range(QN)
        )
        return hits / (QN * K)

    # a distinct query batch per rep, so no rep repeats another's inputs
    rep_qs = [
        prepare_vectors(cfg, jnp.asarray(qpool[(i + 1) * QN : (i + 2) * QN]))
        for i in range(REPS)
    ]
    jax.block_until_ready(rep_qs)

    best = None
    fallback = None
    # (ef, max_iters): a capped iteration budget trades the last recall
    # for QPS; None = default_max_iters
    sweep = [
        (48, None), (24, None), (32, None), (48, 44), (48, 56),
        (64, 64), (96, None), (128, None), (192, None), (256, None),
    ]
    for ef, mi in sweep:
        d_h, i_h = search_graph(cfg, state, qp, k=K, ef=ef, max_iters=mi)
        i_h.block_until_ready()  # compile
        t0 = time.time()
        outs = [
            search_graph(cfg, state, rep_qs[i], k=K, ef=ef, max_iters=mi)[1]
            for i in range(REPS)
        ]
        jax.block_until_ready(outs)
        dt = (time.time() - t0) / REPS
        qps = QN / dt
        r = recall(np.asarray(i_h))
        log(
            f"ef={ef:4d} iters={mi if mi else 'def':>4} recall@10={r:.4f} "
            f"{dt * 1e3:7.2f} ms/batch {qps:9.0f} QPS [{card}]"
        )
        if fallback is None or r > fallback[1]:
            fallback = (qps, r, ef)
        if r >= 0.95 and (best is None or qps > best[0]):
            best = (qps, r, ef)
        if r >= 0.95 and best is not None and qps < best[0] / 2:
            break  # recall already met; deeper ef only gets slower

    if best is None:
        log("WARNING: no ef reached recall 0.95; reporting highest-recall point")
        best = fallback

    qps, r, ef = best
    log(f"total bench wall time {time.time() - t_all:.0f}s")
    print(
        json.dumps(
            {
                "metric": (
                    f"QPS at recall@10>={r:.3f} ({N}x{D} f32 cosine, "
                    f"ef={ef}); build {N / build_s:.0f} vec/s"
                ),
                "value": round(qps, 1),
                "unit": "QPS",
                "vs_baseline": round(qps / BASELINE_QPS, 2),
                "card": card,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
