"""Card-derived settings: the compile-cache directory and the device
memory budgets (tpuvec/utils/safecache.py, tpuvec/utils/device.py)."""

import os

import pytest

import jax

from tpuvec.index import build as B
from tpuvec.store import table as T
from tpuvec.utils import device, safecache


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert safecache.compilation_cache_dir() == str(tmp_path)
    assert safecache.compilation_cache_dir("cpu-tests") == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert safecache.configure_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert safecache.compilation_cache_dir() == os.path.join(
        root, ".jax_cache", "device"
    )
    # the tests' own directory, which conftest configured for this run
    assert jax.config.jax_compilation_cache_dir in (
        os.path.join(root, ".jax_cache", "cpu-tests"),
        os.environ.get("JAX_COMPILATION_CACHE_DIR"),
    )
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _Card:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats,shadow,dense",
    [
        # an 80 GB card at JAX's default 75% reservation
        ({"bytes_limit": 60 << 30}, (60 << 30) * 6 // 16, (60 << 30) // 16),
        # a 16 GB card keeps the sizes the constants were chosen for
        ({"bytes_limit": 16 << 30}, 6 << 30, 1 << 30),
        # no stats (the CPU backend): the constants
        (None, 6144 << 20, 1 << 30),
    ],
    ids=["80GB", "16GB", "no-stats"],
)
def test_budgets_follow_card_memory(monkeypatch, stats, shadow, dense):
    monkeypatch.delenv("TPUVEC_SHADOW_BUDGET_MB", raising=False)
    monkeypatch.delenv("TPUVEC_REV_APPLY_DENSE_MAX_BYTES", raising=False)
    monkeypatch.delenv("TPUVEC_REV_APPLY", raising=False)
    monkeypatch.setattr(device.jax, "devices", lambda: [_Card(stats)])
    assert T._shadow_budget_bytes() == shadow
    assert B._apply_rows_impl(dense // 2) is B._apply_rows_dense
    assert B._apply_rows_impl(dense // 2 + 1) is B._apply_rows
    # the env overrides still win
    monkeypatch.setenv("TPUVEC_SHADOW_BUDGET_MB", "1")
    assert T._shadow_budget_bytes() == 1 << 20


def test_cpu_backend_reports_no_limit():
    assert jax.devices()[0].memory_stats() is None
    assert device.device_bytes_limit() is None
    assert device.device_share(0.5, 123) == 123
