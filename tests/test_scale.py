"""Opt-in scale test (reference tests/test_scale.rs: 10K and 100K tiers
with count/node/search sanity + a listed insert rate).

The default CPU suite builds sub-1K graphs; this tier inserts 10K
through the full VecTable surface and checks the same invariants the
reference asserts (row count, index node count, k results returned,
self-query nearest). It needs several minutes of XLA:CPU build time on
the 1-core CI box, so it is opt-in:

    TPUVEC_SCALE_TEST=1 python -m pytest tests/test_scale.py -q

(The 100K tier runs on the GPU in chip_smoke.py, which prints its build
time.)
"""

import os
import time

import numpy as np
import pytest

from tpuvec.store import ColumnSpec, VecTable
from tpuvec.types import DistanceMetric

pytestmark = pytest.mark.skipif(
    os.environ.get("TPUVEC_SCALE_TEST") != "1",
    reason="scale tier is opt-in (TPUVEC_SCALE_TEST=1); minutes on 1-core CPU",
)

N, D = 10_000, 96


def test_scale_10k_vectors():
    rng = np.random.RandomState(7)
    x = rng.randn(N, D).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)

    t = VecTable(
        "scale10k",
        [ColumnSpec.vector("e", D, metric=DistanceMetric.L2)],
        initial_cap=N,
    )
    t0 = time.time()
    t.insert_many([{"e": row} for row in x])
    dt = time.time() - t0
    print(f"insert: {N} rows in {dt:.1f}s = {N / dt:.0f} vec/s")

    # row count + index node count (reference: _data count, hnsw_nodes)
    assert len(t) == N
    vc = t.vector_cols["e"]
    assert int(vc.state.count) == N
    assert not t.integrity_check()

    # k results, self-query nearest, distances sorted
    hits = 0
    for qi in range(0, 200, 10):
        res = t.knn("e", x[qi], k=10)
        assert len(res) == 10
        d = [r.distance for r in res]
        assert d == sorted(d)
        if res[0].rowid == qi + 1:  # auto rowids start at 1
            hits += 1
    assert hits >= 18, f"self-query nearest only {hits}/20"
