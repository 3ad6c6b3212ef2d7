"""All five BASELINE.md benchmark configs in one driver-visible artifact.

Reproduces the whole reference performance table (BASELINE.md; reference
sweep shape: reference tests/test_recall_perf.rs:98-125) on one GPU and
writes the results table to BENCH_CONFIGS.md at the repo root. bench.py stays the driver's single-number entry; this suite is
the full story:

  1. 25K x 384 f32 L2        - HNSW point + exact ENN scan
  2. 100K x 768 f32 cosine   - ef_search sweep (recall vs QPS)
  3. 1M x 1024 int8 cosine   - coarse int8 graph + device f32 rerank
  4. 1M..10M x 1024 binary   - Hamming coarse + device rerank cascade
  5. 256K x 384, 1K tenants  - partition-filtered KNN via VecTable

Usage:
  python scripts/bench_suite.py          # all configs
  python scripts/bench_suite.py 1 2 5    # a subset

Long builds (configs 3/4) checkpoint per 256K segment to .scratch/ in the
checkout and resume across reruns. Config 4 reuses the probe_10m_binary
checkpoints when present (TPUVEC_SUITE_BIN_N selects the corpus size,
default 1M).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RESULTS_MD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BENCH_CONFIGS.md",
)
K = 10
QN = 256
REPS = 5
SEG = 262_144


def log(*a):
    print(*a, file=sys.stderr, flush=True)


SCRATCH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".scratch"
)


def _setup():
    import jax

    from tpuvec.utils.device import card_info, require_gpu
    from tpuvec.utils.safecache import configure_compilation_cache

    devs = require_gpu()
    log(f"card: {card_info()[0]}; jax: {devs[0].device_kind} x{len(devs)}")
    configure_compilation_cache()
    os.makedirs(SCRATCH, exist_ok=True)
    return jax


_CKPT_FIELDS = [
    "adj0", "adj0_dist", "levels", "upper_slot", "upper_nodes",
    "upper_adj", "upper_dist", "entry_point", "entry_level", "count",
    "upper_count",
]


def checkpointed_build(cfg, xp_dev, n, tag):
    """Segmented build with .scratch/ checkpoints; returns (state, vec/s)."""
    import jax.numpy as jnp

    from tpuvec.index.build import build_graph
    from tpuvec.index.graph import GraphState, allocate

    ckpt = os.path.join(SCRATCH, f"tpuvec_suite_{tag}.npz")
    side = ckpt + ".json"
    state, pos, secs = None, 0, 0.0
    if os.path.exists(ckpt) and os.path.exists(side):
        try:
            with open(side) as f:
                meta = json.load(f)
            z = np.load(ckpt)
            fields = {f: jnp.asarray(z[f]) for f in _CKPT_FIELDS}
            mask = (np.arange(n) < int(meta["pos"]))[:, None]
            fields["vectors"] = jnp.where(jnp.asarray(mask), xp_dev, 0)
            state = GraphState(**fields)
            pos, secs = int(meta["pos"]), float(meta["secs"])
            log(f"[{tag}] resumed at {pos}/{n}")
        except Exception as e:
            log(f"[{tag}] checkpoint unreadable ({e!r}); fresh build")
            state, pos, secs = None, 0, 0.0
    if state is None:
        state = allocate(cfg)
    while pos < n:
        take = min(SEG, n - pos)
        t0 = time.time()
        state = build_graph(
            cfg, xp_dev[pos : pos + take],
            ids=np.arange(pos, pos + take, dtype=np.int32),
            max_batch=1024, state=state, start_size=max(pos, 1),
        )
        state.count.block_until_ready()
        secs += time.time() - t0
        pos += take
        if n > SEG:  # don't checkpoint small builds
            arrays = {f: np.asarray(getattr(state, f)) for f in _CKPT_FIELDS}
            np.savez(ckpt + ".tmp.npz", **arrays)
            os.replace(ckpt + ".tmp.npz", ckpt)
            with open(side + ".tmp", "w") as f:
                json.dump({"pos": pos, "secs": secs}, f)
            os.replace(side + ".tmp", side)
        log(f"[{tag}] build {pos}/{n} ({pos / max(secs, 1e-9):.0f} vec/s)")
    return state, n / max(secs, 1e-9)


def measure(jax, run, rep_inputs):
    """Compile via rep 0, then time distinct-input reps."""
    out0 = run(*rep_inputs[0])
    jax.block_until_ready(out0)
    t0 = time.time()
    outs = [run(*ri) for ri in rep_inputs[1:]]
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / (len(rep_inputs) - 1)
    return out0, QN / dt


def recall_of(found, gt):
    return sum(
        len(set(found[b].tolist()) & set(gt[b].tolist()))
        for b in range(found.shape[0])
    ) / (found.shape[0] * K)


def config_1(jax):
    """25K x 384 f32 L2: HNSW + exact ENN (brute force wins at this scale,
    SURVEY.md §7 step 2)."""
    import jax.numpy as jnp

    from tpuvec.index import HnswParams, bruteforce_knn
    from tpuvec.index.graph import config_for, prepare_vectors
    from tpuvec.index.search import search_graph
    from tpuvec.types import DistanceMetric
    from tpuvec.utils.data import synthetic_embeddings
    from tpuvec.utils.transfer import prepare_vectors_device

    n, d = 25_000, 384
    data = synthetic_embeddings(n + QN * (REPS + 1), d, seed=1)
    x, qpool = data[:n], data[n:]
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=64)
    cfg = config_for(d, metric=DistanceMetric.L2, params=params, cap=n)
    xp = prepare_vectors_device(cfg, x)
    t0 = time.time()
    state, rate = checkpointed_build(cfg, xp, n, f"c1_{n}x{d}")
    reps = [
        (prepare_vectors(cfg, jnp.asarray(qpool[i * QN : (i + 1) * QN])),)
        for i in range(REPS + 1)
    ]
    jax.block_until_ready(reps)
    valid = jnp.ones(n, bool)

    (gt_d, gt_i), enn_qps = measure(
        jax,
        lambda qp: bruteforce_knn(qp, xp, valid, metric=cfg.graph_metric, k=K),
        reps,
    )
    gt = np.asarray(gt_i)
    rows = [("exact ENN (matmul scan)", 1.0, enn_qps)]
    for ef in (16, 32, 64):
        (dd, ii), qps = measure(
            jax,
            lambda qp, ef=ef: search_graph(cfg, state, qp, k=K, ef=ef),
            reps,
        )
        rows.append((f"HNSW ef={ef}", recall_of(np.asarray(ii), gt), qps))
    return {
        "name": "config 1: 25K x 384 f32 L2 k=10",
        "build_rate": rate,
        "rows": rows,
    }


def config_2(jax):
    """100K x 768 f32 cosine ef sweep (the reference's recall_perf shape)."""
    import jax.numpy as jnp

    from tpuvec.index import HnswParams, bruteforce_knn
    from tpuvec.index.graph import config_for, prepare_vectors
    from tpuvec.index.search import search_graph
    from tpuvec.types import DistanceMetric
    from tpuvec.utils.data import synthetic_embeddings
    from tpuvec.utils.transfer import prepare_vectors_device

    n, d = 100_000, 768
    data = synthetic_embeddings(n + QN * (REPS + 1), d, seed=0)
    x, qpool = data[:n], data[n:]
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    cfg = config_for(d, metric=DistanceMetric.COSINE, params=params, cap=n)
    xp = prepare_vectors_device(cfg, x)
    state, rate = checkpointed_build(cfg, xp, n, f"c2_{n}x{d}")
    reps = [
        (prepare_vectors(cfg, jnp.asarray(qpool[i * QN : (i + 1) * QN])),)
        for i in range(REPS + 1)
    ]
    jax.block_until_ready(reps)
    gt = np.asarray(
        bruteforce_knn(
            reps[0][0], xp, jnp.ones(n, bool), metric=cfg.graph_metric, k=K,
            normalized=cfg.normalized,
        )[1]
    )
    rows = []
    for ef in (16, 24, 32, 48, 96):
        (dd, ii), qps = measure(
            jax,
            lambda qp, ef=ef: search_graph(cfg, state, qp, k=K, ef=ef),
            reps,
        )
        rows.append((f"HNSW ef={ef}", recall_of(np.asarray(ii), gt), qps))
    return {
        "name": "config 2: 100K x 768 f32 cosine k=10 (ef sweep)",
        "build_rate": rate,
        "rows": rows,
    }


def config_3(jax):
    """1M x 1024 int8-quantized cosine + device f32 rerank (BASELINE
    config 3; quantization path of the reference, src/vector.rs:554-575)."""
    import jax.numpy as jnp

    from tpuvec.index import HnswParams
    from tpuvec.index.bruteforce import bruteforce_knn
    from tpuvec.index.graph import config_for, prepare_vectors
    from tpuvec.index.search import search_graph
    from tpuvec.ops.rerank import rerank_topk
    from tpuvec.types import DistanceMetric, IndexQuantization
    from tpuvec.utils.data import synthetic_embeddings
    from tpuvec.utils.transfer import prepare_vectors_device, to_device_chunked

    n, d = 1_000_000, 1024
    data = synthetic_embeddings(
        n + QN * (REPS + 1), d, n_clusters=1024, seed=3
    )
    x, qpool = data[:n], data[n:]
    params = HnswParams(m=16, max_m0=32, ef_construction=200, ef_search=128)
    cfg = config_for(
        d, metric=DistanceMetric.COSINE,
        quantization=IndexQuantization.INT8, params=params, cap=n,
    )
    xp = prepare_vectors_device(cfg, x)
    state, rate = checkpointed_build(cfg, xp, n, f"c3_{n}x{d}_int8")
    reps = [
        (
            prepare_vectors(cfg, jnp.asarray(qpool[i * QN : (i + 1) * QN])),
            jnp.asarray(qpool[i * QN : (i + 1) * QN]),
        )
        for i in range(REPS + 1)
    ]
    jax.block_until_ready(reps)
    xf = to_device_chunked(x)  # f32 shadow for rerank + ground truth
    gt = np.asarray(
        bruteforce_knn(
            reps[0][1], xf, jnp.ones(n, bool),
            metric=DistanceMetric.COSINE, k=K,
        )[1]
    )
    rows = []
    for ef, mi in ((48, 56), (64, 64)):
        (dd, ii), qps = measure(
            jax,
            lambda qp, qf, ef=ef, mi=mi: search_graph(
                cfg, state, qp, k=K, ef=ef, max_iters=mi
            ),
            reps,
        )
        rows.append(
            (f"coarse int8 ef={ef}", recall_of(np.asarray(ii), gt), qps)
        )
    for ef, mi, c in ((64, 64, 48), (128, None, 96)):
        def run(qp, qf, ef=ef, mi=mi, c=c):
            _, ii = search_graph(cfg, state, qp, k=c, ef=ef, max_iters=mi)
            return rerank_topk(
                xf, ii, ii >= 0, qf, metric=DistanceMetric.COSINE, k=K
            )
        (dd, ii), qps = measure(jax, run, reps)
        rows.append(
            (
                f"int8 + f32 rerank ef={ef} C={c}",
                recall_of(np.asarray(ii), gt),
                qps,
            )
        )
    return {
        "name": "config 3: 1M x 1024 int8 cosine k=10 (+device f32 rerank)",
        "build_rate": rate,
        "rows": rows,
    }


def config_4(jax):
    """Binary Hamming + rerank cascade at TPUVEC_SUITE_BIN_N (default 1M).

    Delegates to scripts/probe_10m_binary.py's checkpointed phases so a
    10M run reuses the long-build machinery and its .scratch/ artifacts.
    """
    bin_n = int(os.environ.get("TPUVEC_SUITE_BIN_N", 1_000_000))
    os.environ["TPUVEC_BIN_N"] = str(bin_n)
    sys.modules.pop("probe_10m_binary", None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import jax.numpy as jnp

    import probe_10m_binary as p

    cfg = p.get_cfg()
    packed = p.phase_prepare(cfg)
    state, built_n = p.phase_build(cfg, packed)
    del packed
    state = dataclasses.replace(state, adj0_dist=jnp.zeros((1, 1)))
    rows = p.phase_search(cfg, state, built_n)
    with open(p.SIDE) as f:
        secs = float(json.load(f)["secs"])
    return {
        "name": f"config 4: {built_n} x 1024 binary Hamming + rerank k=10",
        "build_rate": built_n / max(secs, 1e-9),
        "rows": rows,
    }


def config_5(jax):
    """256K x 384 across 1K tenants: partition-filtered KNN through the
    VecTable product surface (the feature the reference parses but never
    implements, src/vtab.rs:2479-2480)."""
    from tpuvec.store.table import ColumnSpec, VecTable
    from tpuvec.types import DistanceMetric
    from tpuvec.utils.data import synthetic_embeddings

    n, d, tenants = 262_144, 384, 1024
    data = synthetic_embeddings(n + 64, d, seed=5)
    x, q = data[:n], data[n:]
    rng = np.random.default_rng(7)
    parts = rng.integers(0, tenants, n)
    t = VecTable(
        "bench5",
        [
            ColumnSpec.vector("e", d, metric=DistanceMetric.COSINE),
            ColumnSpec.partition_key("tenant"),
        ],
        initial_cap=n,
    )
    t0 = time.time()
    t.insert_many(
        [{"e": x[i], "tenant": int(parts[i])} for i in range(n)],
        rowids=list(range(n)),
    )
    t.flush()
    rate = n / (time.time() - t0)
    # warm + measure single-tenant filtered queries (~256 rows/tenant ->
    # the planner routes them to the exact masked scan, the right plan at
    # this selectivity)
    qps_samples = []
    hits = 0
    probes = 64
    for i in range(probes):
        tenant = int(parts[i * 97 % n])
        t.knn("e", q[i % 64], k=K, partition=tenant)  # warm per-shape
    t0 = time.time()
    for i in range(probes):
        tenant = int(parts[i * 97 % n])
        res = t.knn("e", q[i % 64], k=K, partition=tenant)
        hits += sum(1 for r in res if int(parts[r.rowid]) == tenant)
    dt = (time.time() - t0) / probes
    qps_samples.append(1.0 / dt)
    purity = hits / (probes * K)

    # batched multi-tenant serving shape: B queries, each its OWN tenant,
    # in one device dispatch (per-query partition codes compared in-kernel
    # against the distance tile). Distinct query values per rep, so no
    # rep repeats another's inputs.
    bsz = 64
    reps = 4
    rep_qs = [
        [q[j % 64] * (1.0 + 1e-4 * (r + 1)) for j in range(bsz)]
        for r in range(reps)
    ]
    rep_parts = [
        [int(parts[(j * 97 + r) % n]) for j in range(bsz)] for r in range(reps)
    ]
    t.knn_many("e", rep_qs[0], k=K, partition=rep_parts[0])  # warm
    bhits = btot = 0
    t0 = time.time()
    for r in range(reps):
        outs = t.knn_many("e", rep_qs[r], k=K, partition=rep_parts[r])
        for j, res in enumerate(outs):
            bhits += sum(
                1 for rr in res if int(parts[rr.rowid]) == rep_parts[r][j]
            )
            btot += len(res)
    bqps = bsz * reps / (time.time() - t0)
    bpurity = bhits / max(btot, 1)
    return {
        "name": (
            f"config 5: {n} x {d}, {tenants} tenants, "
            "partition-filtered KNN (VecTable)"
        ),
        "build_rate": rate,
        "rows": [
            (
                f"single-tenant k={K} (purity {purity:.3f})",
                purity,
                qps_samples[0],
            ),
            (
                f"per-query tenants, B={bsz} batched k={K} "
                f"(purity {bpurity:.3f})",
                bpurity,
                bqps,
            ),
        ],
    }


def main():
    jax = _setup()
    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5]
    configs = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}
    # subset runs merge into the previous full table (JSON sidecar keyed
    # by config index) instead of clobbering the other configs' rows
    merged: dict[str, dict] = {}
    if os.path.exists(RESULTS_MD + ".json"):
        try:
            with open(RESULTS_MD + ".json") as f:
                merged = json.load(f)
        except Exception:
            merged = {}
    for i in which:
        log(f"=== {configs[i].__doc__.splitlines()[0]} ===")
        t0 = time.time()
        try:
            res = configs[i](jax)
            res["wall"] = time.time() - t0
            for name, r, qps in res["rows"]:
                log(f"  {name}: recall@10={r:.4f} {qps:.0f} QPS")
        except Exception as e:
            log(f"config {i} FAILED: {e!r}")
            res = {
                "name": f"config {i}", "build_rate": 0, "rows": [],
                "error": repr(e), "wall": time.time() - t0,
            }
        merged[str(i)] = res
    results = [merged[k] for k in sorted(merged, key=int)]
    with open(RESULTS_MD + ".json.tmp", "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(RESULTS_MD + ".json.tmp", RESULTS_MD + ".json")
    lines = [
        "# BENCH_CONFIGS — full BASELINE config table",
        "",
        "One command reproduces the whole BASELINE.md table on one",
        "GPU: `python scripts/bench_suite.py` (subset: `1 2 5`).",
        f"Generated by bench_suite.py; reference baseline table in",
        "BASELINE.md (single-core Apple Silicon).",
        "",
        "| Config | Point | recall@10 | QPS | build vec/s |",
        "|---|---|---|---|---|",
    ]
    for res in results:
        if res.get("error"):
            lines.append(f"| {res['name']} | ERROR {res['error']} | | | |")
        for name, r, qps in res["rows"]:
            lines.append(
                f"| {res['name']} | {name} | {r:.4f} | {qps:,.0f} | "
                f"{res['build_rate']:,.0f} |"
            )
    lines.append("")
    with open(RESULTS_MD, "w") as f:
        f.write("\n".join(lines))
    log(f"wrote {RESULTS_MD}")


if __name__ == "__main__":
    main()
