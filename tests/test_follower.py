"""Cross-process access tests: writer autosave -> follower readers.

Models the reference's multi-process WAL behavior
(tests/test_multithread_stress.rs:53-106, test_disk_persistence.rs):
readers see the last committed (= autosaved) state, a second writer
fails fast on the write lock, and a genuinely separate OS process can
open the published snapshot.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpuvec.index import HnswParams
from tpuvec.store import ColumnSpec, SnapshotFollower, VecTable, writer_lock
from tpuvec.types import DistanceMetric, InvalidState
from tpuvec.utils.data import synthetic_embeddings

PARAMS = HnswParams(m=8, max_m0=16, ef_construction=48, ef_search=48)


def make_writer(path, n=64):
    x = synthetic_embeddings(n, 32, intrinsic_dim=8, n_clusters=8, seed=1)
    t = VecTable(
        "w",
        [ColumnSpec.vector("e", 32, metric=DistanceMetric.L2, params=PARAMS),
         ColumnSpec.metadata("tag")],
        initial_cap=256,
        autosave_path=path,
        autosave_every=1,
    )
    for i, v in enumerate(x):
        t.insert({"e": v, "tag": i})
    t.flush()
    t.wait_autosave()
    return t, x


def test_follower_sees_committed_state_and_refreshes(tmp_path):
    path = str(tmp_path / "snap.npz")
    t, x = make_writer(path)

    f = SnapshotFollower(path)
    assert len(f) == len(t) == 64
    assert f.row(1)["tag"] == 0
    got = {r.rowid for r in f.knn("e", x[5], k=3)}
    assert 6 in got

    # no new generation -> no reload
    assert f.refresh() is False

    # writer commits more rows; follower picks them up on refresh
    x2 = synthetic_embeddings(8, 32, intrinsic_dim=8, n_clusters=8, seed=2)
    for v in x2:
        t.insert({"e": v, "tag": 99})
    t.flush()
    t.wait_autosave()
    assert f.refresh() is True
    assert len(f) == 72


def test_writer_lock_excludes_second_writer(tmp_path):
    path = str(tmp_path / "snap.npz")
    with writer_lock(path):
        with pytest.raises(InvalidState, match="another writer"):
            with writer_lock(path):
                pass
    # released -> can acquire again
    with writer_lock(path):
        pass


def test_second_os_process_reads_snapshot(tmp_path):
    path = str(tmp_path / "snap.npz")
    t, x = make_writer(path)
    q = repr([float(v) for v in x[9]])
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import sys\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from tpuvec.store import SnapshotFollower\n"
        f"f = SnapshotFollower({path!r})\n"
        "print(len(f))\n"
        f"print(f.knn('e', {q}, k=1)[0].rowid)\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "64" and lines[-1] == "10", lines
