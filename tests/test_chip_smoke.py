"""chip_smoke.py's phases at toy sizes on the CPU, each against the
script's own numpy references; and its refusal to run off the GPU.

The phases share one f32 table configuration (phase 2, SQL and the
determinism builds all use phase 2's capacity and HNSW parameters), so
the insert programs compile once per configuration; a flat graph
(max_level=0) keeps each compile short on XLA:CPU.
"""

import numpy as np
import pytest

import chip_smoke as cs
from tpuvec.index.params import HnswParams
from tpuvec.sql import ddl

TOY = cs.Sizes(
    n=2000, d=32, tenants=16, queries=16, filtered=8, reps=1,
    quant_n=32, quant_d=64, coarse_k=32, product_q=8, sql_n=300,
    det_n=400, multi_n=512, ef=64,
    params=HnswParams(m=8, max_m0=16, ef_construction=32, ef_search=32,
                      max_level=0),
)


def _main_chain(ctx):
    main = cs.phase_main(ctx)
    cs.phase_exact(ctx, main)
    cs.phase_snapshot(ctx, main)
    cs.phase_memory(ctx, main)


@pytest.mark.parametrize(
    "phase",
    [
        _main_chain,
        cs.phase_quantized,
        cs.phase_sql,
        cs.phase_determinism,
    ],
    ids=["main_exact_snapshot_memory", "quantized", "sql", "determinism"],
)
def test_phase_at_toy_size(phase, capsys, monkeypatch):
    # the vec0 DDL cannot set max_level; start its tables from the toy
    # parameters so the SQL phase reuses phase 2's compiled programs
    monkeypatch.setattr(ddl, "HnswParams", lambda: TOY.params)
    ctx = cs.Ctx(TOY)
    with ctx.clock:
        phase(ctx)
    out = capsys.readouterr().out
    assert out and "Traceback" not in out
    if phase is cs.phase_determinism:
        # XLA:CPU builds are deterministic: the phase must say so
        assert "byte-identical" in out


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.phase_device(cs.Ctx(TOY))
    assert "'cpu'" in str(exc.value)
    with pytest.raises(SystemExit):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_references_catch_a_wrong_answer():
    """The tie-aware id comparison flags a real miss and forgives a tie."""
    dist = np.array([[0.1, 0.2, 0.3, 0.3 + 1e-7, 0.9]])
    ref = np.array([[0, 1, 2]])
    assert cs.tie_aware_mismatch(np.array([[0, 1, 3]]), ref, dist) == 0
    assert cs.tie_aware_mismatch(np.array([[0, 1, 4]]), ref, dist) == 1
    assert cs.recall_np(np.array([[0, 1, 4]]), ref) == pytest.approx(2 / 3)
