"""Bitonic sort network tests (tpuvec/ops/sort.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuvec.ops.sort import bitonic_sort, bitonic_topk_merge


@pytest.mark.parametrize("length", [2, 8, 64, 256, 1024])
def test_sort_matches_numpy(rng, length):
    k = rng.standard_normal((5, length)).astype(np.float32)
    v = rng.integers(0, 1 << 20, (5, length)).astype(np.int32)
    sk, sv = jax.jit(bitonic_sort)(jnp.asarray(k), jnp.asarray(v))
    order = np.argsort(k, axis=1, kind="stable")
    np.testing.assert_allclose(np.asarray(sk), np.take_along_axis(k, order, 1))
    np.testing.assert_array_equal(np.asarray(sv), np.take_along_axis(v, order, 1))


def test_sort_with_inf_padding(rng):
    k = rng.standard_normal((3, 128)).astype(np.float32)
    k[:, 50:] = np.inf
    (sk,) = jax.jit(bitonic_sort)(jnp.asarray(k))
    sk = np.asarray(sk)
    assert np.all(np.isinf(sk[:, 50:]))
    assert np.all(np.diff(sk[:, :50], axis=1) >= 0)


def test_non_pow2_rejected():
    with pytest.raises(AssertionError):
        bitonic_sort(jnp.zeros((2, 96)))


def test_merge_keeps_smallest(rng):
    ef, w = 128, 128
    bd = np.sort(rng.standard_normal((4, ef)).astype(np.float32), axis=1)
    bi = rng.integers(0, 9999, (4, ef)).astype(np.int32)
    bx = rng.random((4, ef)) > 0.5
    nd = rng.standard_normal((4, w)).astype(np.float32)
    ni = rng.integers(0, 9999, (4, w)).astype(np.int32)
    md, mi, mx = jax.jit(bitonic_topk_merge)(
        *(jnp.asarray(a) for a in (bd, bi, bx, nd, ni))
    )
    expect = np.sort(np.concatenate([bd, nd], axis=1), axis=1)[:, :ef]
    np.testing.assert_allclose(np.asarray(md), expect)
    # new entrants arrive unexpanded
    allx = np.concatenate([bx, np.zeros((4, w), bool)], axis=1)
    alld = np.concatenate([bd, nd], axis=1)
    order = np.argsort(alld, axis=1, kind="stable")[:, :ef]
    np.testing.assert_array_equal(np.asarray(mx), np.take_along_axis(allx, order, 1))


@pytest.mark.parametrize("ef,w", [(16, 64), (64, 64), (256, 128), (128, 7)])
def test_merge_sorted_any_width(rng, ef, w):
    from tpuvec.ops.sort import bitonic_topk_merge_sorted

    bd = np.sort(rng.standard_normal((4, ef)).astype(np.float32), axis=1)
    bi = rng.integers(0, 9999, (4, ef)).astype(np.int32)
    bx = rng.random((4, ef)) > 0.5
    nd = rng.standard_normal((4, w)).astype(np.float32)
    ni = rng.integers(0, 9999, (4, w)).astype(np.int32)
    md, mi, mx = jax.jit(bitonic_topk_merge_sorted)(
        *(jnp.asarray(a) for a in (bd, bi, bx, nd, ni))
    )
    alld = np.concatenate([bd, nd], axis=1)
    alli = np.concatenate([bi, ni], axis=1)
    allx = np.concatenate([bx, np.zeros((4, w), bool)], axis=1)
    order = np.argsort(alld, axis=1, kind="stable")[:, :ef]
    np.testing.assert_allclose(np.asarray(md), np.take_along_axis(alld, order, 1))
    np.testing.assert_array_equal(np.asarray(mi), np.take_along_axis(alli, order, 1))
    np.testing.assert_array_equal(np.asarray(mx), np.take_along_axis(allx, order, 1))


def test_merge_sorted_with_inf(rng):
    from tpuvec.ops.sort import bitonic_topk_merge_sorted

    ef, w = 32, 48
    bd = np.sort(rng.standard_normal((3, ef)).astype(np.float32), axis=1)
    bd[:, 20:] = np.inf
    bi = np.where(np.isfinite(bd), 7, -1).astype(np.int32)
    bx = np.zeros((3, ef), bool)
    nd = rng.standard_normal((3, w)).astype(np.float32)
    nd[:, 10:] = np.inf
    ni = np.where(np.isfinite(nd), 9, -1).astype(np.int32)
    md, mi, mx = bitonic_topk_merge_sorted(
        *(jnp.asarray(a) for a in (bd, bi, bx, nd, ni))
    )
    md = np.asarray(md)
    expect = np.sort(np.concatenate([bd, nd], axis=1), axis=1)[:, :ef]
    np.testing.assert_allclose(md, expect)
    assert np.all(np.asarray(mi)[~np.isfinite(md)] == -1)


def test_descending_sort(rng):
    k = rng.standard_normal((4, 64)).astype(np.float32)
    (sk,) = bitonic_sort(jnp.asarray(k), descending=True)
    np.testing.assert_allclose(np.asarray(sk), -np.sort(-k, axis=1))


@pytest.mark.parametrize("width,k", [(64, 32), (100, 10), (7, 7)])
def test_bitonic_smallest(rng, width, k):
    from tpuvec.ops.sort import bitonic_smallest

    d = rng.standard_normal((5, width)).astype(np.float32)
    i = rng.integers(0, 9999, (5, width)).astype(np.int32)
    sd, si = jax.jit(lambda a, b: bitonic_smallest(a, b, k=k))(
        jnp.asarray(d), jnp.asarray(i)
    )
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(np.asarray(sd), np.take_along_axis(d, order, 1))
    np.testing.assert_array_equal(np.asarray(si), np.take_along_axis(i, order, 1))


@pytest.mark.parametrize("ef,w", [(16, 64), (64, 64), (128, 48)])
def test_merge_impls_identical(rng, ef, w):
    """The xor and roll compare-exchange implementations must produce
    bit-identical merges."""
    from tpuvec.ops.sort import bitonic_topk_merge_sorted

    bd = np.sort(rng.standard_normal((4, ef)).astype(np.float32), axis=1)
    bi = rng.integers(0, 9999, (4, ef)).astype(np.int32)
    bx = rng.random((4, ef)) < 0.5
    nd = rng.standard_normal((4, w)).astype(np.float32)
    nd[:, w - 5 :] = np.inf
    ni = np.where(np.isfinite(nd), rng.integers(0, 9999, (4, w)), -1).astype(
        np.int32
    )
    args = tuple(jnp.asarray(a) for a in (bd, bi, bx, nd, ni))
    outs = {
        impl: bitonic_topk_merge_sorted(*args, impl=impl)
        for impl in ("xor", "roll")
    }
    for a, b in zip(outs["xor"], outs["roll"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("ef,w", [(16, 64), (64, 64), (128, 48)])
def test_rank_merge_matches_bitonic(rng, ef, w):
    """rank_topk_merge_sorted (the XLA hot path) must agree with the
    bitonic merge on distinct keys, including inf-padding handling."""
    from tpuvec.ops.sort import (
        bitonic_topk_merge_sorted, rank_topk_merge_sorted,
    )

    bd = np.sort(rng.standard_normal((4, ef)).astype(np.float32), axis=1)
    bd[2, ef // 2 :] = np.inf  # partially-filled beam
    bi = np.where(np.isfinite(bd), rng.integers(0, 9999, (4, ef)), -1).astype(np.int32)
    bx = ~np.isfinite(bd) | (rng.random((4, ef)) < 0.5)
    nd = rng.standard_normal((4, w)).astype(np.float32)
    nd[:, w - 5 :] = np.inf
    nd[3] = np.inf  # fully-masked window
    ni = np.where(np.isfinite(nd), rng.integers(0, 9999, (4, w)), -1).astype(np.int32)
    args = tuple(jnp.asarray(a) for a in (bd, bi, bx, nd, ni))
    rd, ri, rx = (np.asarray(a) for a in rank_topk_merge_sorted(*args))
    sd, si, sx = (np.asarray(a) for a in bitonic_topk_merge_sorted(*args))
    np.testing.assert_allclose(rd, sd)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(ri[fin], si[fin])
    np.testing.assert_array_equal(rx[fin], sx[fin])
    assert np.all(ri[~fin] == -1) and np.all(si[~fin] == -1)
