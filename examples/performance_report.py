"""Performance report: insert rate / query latency / recall tables
(mirrors the reference's examples/performance_report.rs, whose stated
requirement is ~170 vec/s insert and ~2.8 ms/query at recall > 0.95)."""

import time

import numpy as np
import jax.numpy as jnp

from tpuvec.index import HnswParams, bruteforce_knn
from tpuvec.index.build import build_graph
from tpuvec.index.graph import config_for, prepare_vectors
from tpuvec.index.search import search_graph
from tpuvec.types import DistanceMetric
from tpuvec.utils.data import synthetic_embeddings
from tpuvec.utils.safecache import configure_compilation_cache


def main() -> None:
    configure_compilation_cache()
    n, d, k, qn = 25_000, 384, 10, 256
    data = synthetic_embeddings(n + qn, d, seed=0)
    x, q = data[:n], data[n:]

    cfg = config_for(
        d,
        metric=DistanceMetric.L2,
        params=HnswParams(m=32, max_m0=64, ef_construction=200, ef_search=64),
        cap=n,
    )
    xp = prepare_vectors(cfg, jnp.asarray(x))
    xp_host = np.asarray(xp)

    t0 = time.time()
    state = build_graph(cfg, xp_host, max_batch=1024)
    state.count.block_until_ready()
    build_s = time.time() - t0
    print(f"insert rate: {n / build_s:8.0f} vec/s   ({n} x {d}, M=32 ef_c=200)")

    qp = prepare_vectors(cfg, jnp.asarray(q))
    gt = np.asarray(
        bruteforce_knn(qp, xp, jnp.ones(n, bool), metric=cfg.graph_metric, k=k)[1]
    )

    print(f"{'ef':>5} {'recall@10':>10} {'ms/query':>10} {'QPS':>10}")
    for ef in (16, 32, 64, 128):
        d_h, i_h = search_graph(cfg, state, qp, k=k, ef=ef)
        i_h.block_until_ready()
        t0 = time.time()
        reps = 10
        for _ in range(reps):
            d_h, i_h = search_graph(cfg, state, qp, k=k, ef=ef)
        i_h.block_until_ready()
        dt = (time.time() - t0) / reps
        found = np.asarray(i_h)
        recall = sum(
            len(set(found[b]) & set(gt[b])) for b in range(qn)
        ) / (qn * k)
        print(
            f"{ef:>5} {recall:>10.4f} {dt / qn * 1e3:>10.4f} {qn / dt:>10.0f}"
        )


if __name__ == "__main__":
    main()
