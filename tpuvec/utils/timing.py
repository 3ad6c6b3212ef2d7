"""Timing / profiling instrumentation.

Mirrors the reference's feature-gated timing subsystem (Cargo `timing`
feature: atomic counters + RAII scope timers with breakdown printouts,
src/hnsw/timing.rs:12-195, insert.rs:16-105, search.rs:54-171) in the
spirit the survey prescribes: off by default, near-zero cost when
disabled, explicit enable.

Host-side: ``enable()`` + ``timer("phase")`` context managers accumulate
wall-clock per phase and counts (device work is async — phases that must
charge device time call block_until_ready inside the timed region, which
the hot paths only do when timing is enabled).

Device-side: ``trace(path)`` wraps jax.profiler for full XLA traces.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["enable", "disable", "enabled", "reset", "timer", "add", "stats", "print_stats", "trace"]

_enabled = False
_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def timer(name: str):
    """Scope timer (no-op when disabled, like the reference's Timer RAII)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _totals[name] += dt
            _counts[name] += 1


def add(name: str, seconds: float, count: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _totals[name] += seconds
        _counts[name] += count


def stats() -> dict[str, tuple[float, int]]:
    with _lock:
        return {k: (_totals[k], _counts[k]) for k in sorted(_totals)}


def print_stats() -> None:
    """Breakdown printout (reference print_timing_stats analogue)."""
    s = stats()
    if not s:
        print("tpuvec timing: no samples (enable() first)")
        return
    width = max(len(k) for k in s)
    print(f"{'phase':<{width}}  {'total_ms':>10}  {'calls':>8}  {'avg_us':>10}")
    for k, (tot, n) in s.items():
        print(f"{k:<{width}}  {tot * 1e3:>10.2f}  {n:>8}  {tot / max(n, 1) * 1e6:>10.1f}")


@contextlib.contextmanager
def trace(path: str):
    """Device-level profiling via jax.profiler (view with tensorboard /
    xprof). The device analogue of the reference's samply workflow
    (examples/bench_standalone.rs)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
