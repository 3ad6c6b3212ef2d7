"""HNSW parameters and presets (reference: src/hnsw/mod.rs:16-93)."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HnswParams:
    """HNSW index parameters. Defaults match the reference
    (src/hnsw/mod.rs:35-47): M=32, max_M0=64, ef_c=400, ef_s=200.

    ``level_factor`` is 1/ln(M) (exponential level decay).

    ``simple_prune``: True = closest-M neighbor selection (the reference's
    default, src/hnsw/mod.rs:29-32); False = RNG diversity heuristic for
    forward-edge selection (the reference ships it behind the same flag).
    We default to the heuristic: at 768-D, closest-only graphs are barely
    navigable (measured: exact-kNN edges give recall@10 = 0.65 at ef=128 on
    20K random vectors; the diversity heuristic is what makes HNSW work at
    high dimension). Set True for strict reference-default behavior.
    """

    m: int = 32
    max_m0: int = 64
    ef_construction: int = 400
    ef_search: int = 200
    max_level: int = 16
    simple_prune: bool = False
    rng_seed: int = 0x5EED
    # iteration budget for the *construction* candidate beam; None derives
    # it from ef_construction (search.default_max_iters). The build beam is
    # a large share of insert, and capping
    # its straggler tail trades a little candidate quality for build rate —
    # the same iters-vs-recall trade measured for search (bench.py sweep).
    build_max_iters: int | None = None

    @property
    def level_factor(self) -> float:
        return 1.0 / math.log(self.m)

    # -- presets (src/hnsw/mod.rs:49-93) -----------------------------------

    @classmethod
    def high_recall(cls) -> "HnswParams":
        return cls(m=32, max_m0=64, ef_construction=400, ef_search=200)

    @classmethod
    def hot_tier(cls) -> "HnswParams":
        return cls(m=32, max_m0=64, ef_construction=200, ef_search=100)

    @classmethod
    def warm_tier(cls) -> "HnswParams":
        return cls(m=64, max_m0=128, ef_construction=600, ef_search=400)

    @classmethod
    def cold_tier(cls) -> "HnswParams":
        return cls(m=96, max_m0=192, ef_construction=1000, ef_search=800)

    def with_(self, **kw) -> "HnswParams":
        return replace(self, **kw)

    def validate(self) -> None:
        """Bounds match vec_rebuild_hnsw validation (src/sql_functions.rs:456-465)."""
        from tpuvec.types import InvalidParameter

        if not (2 <= self.m <= 256):
            raise InvalidParameter(f"M must be in [2, 256], got {self.m}")
        if not (10 <= self.ef_construction <= 4096):
            raise InvalidParameter(
                f"ef_construction must be in [10, 4096], got {self.ef_construction}"
            )
        if self.max_m0 < self.m:
            raise InvalidParameter("max_m0 must be >= M")
