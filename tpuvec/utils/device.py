"""The card the program runs on: its memory budgets, the GPU check that
measurement entry points make, and the card's name and power limit.

Budgets that decide whether a large array lives on the device (the f32
rerank shadow, the dense reverse-apply temporaries) are a share of the
first device's allocator limit, so they scale with the card instead of
being fixed for one card size.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["device_bytes_limit", "device_share", "require_gpu", "card_info"]


def device_bytes_limit() -> int | None:
    """Bytes the first device's allocator may hand out, or None when the
    backend reports no memory statistics (the CPU backend does not)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def device_share(fraction: float, default: int) -> int:
    """``fraction`` of the device's memory limit; ``default`` bytes when
    the backend reports no limit."""
    limit = device_bytes_limit()
    return default if limit is None else int(limit * fraction)


def require_gpu() -> list:
    """JAX's devices, or SystemExit (code 1) naming the platform found when
    the first one is not a GPU: a measurement never falls back to the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX found platform {devs[0].platform!r} "
            f"({devs[0].device_kind}, {len(devs)} device(s))"
        )
    return devs


def card_info() -> list[str]:
    """One ``name, power.limit`` line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process that does not touch JAX)."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
