"""Bitonic networks over the last axis.

Fixed-width selection built from static shuffles + selects: it works under
jit at any batch shape, on every backend, with no data-dependent control
flow. Whether ``lax.top_k`` / ``lax.sort`` are faster on a given device at
the beam-merge shapes is an open measurement (ROADMAP).

Two compare-exchange implementations (``impl=``):

* ``"roll"`` (default): static lane rolls as concat-of-two-slices +
  select.
* ``"xor"``: partner fetch ``x[i ^ j]`` as ONE [.., g, 2, j] reshape +
  ``lax.rev`` per array. Half the shuffles; kept as the cross-check of
  ``"roll"`` (tests/test_sort.py requires bit-identical merges).

Value lanes ride through the network packed: callers with an (id, flag)
pair use pack_iv/unpack_iv to carry ONE int32 payload instead of two.

Two cost tiers:

* ``bitonic_sort`` — full sort, O(log^2 L) stages. Used for unsorted
  inputs.
* ``bitonic_topk_merge_sorted`` — merge an already-sorted beam with a
  block of new candidates. Only the new block pays the full sort; the
  combined sequence is (ascending ++ descending) = bitonic, so one split
  stage + O(log L) merge stages finish the job. The construction beam
  merges this way (index/build.py); search uses rank_topk_merge_sorted.

All lengths must be powers of two (pad with +inf keys).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "bitonic_sort",
    "bitonic_topk_merge",
    "bitonic_topk_merge_sorted",
    "bitonic_smallest",
    "pack_iv",
    "unpack_iv",
]


def pack_iv(ids: jnp.ndarray, flag: jnp.ndarray) -> jnp.ndarray:
    """Pack (id >= -1, bool flag) into one int32 payload: ((id+1)<<1)|f.
    Valid for ids < 2^30 (caps are well below)."""
    return ((ids + 1) << 1) | flag.astype(jnp.int32)


def unpack_iv(p: jnp.ndarray):
    return (p >> 1) - 1, (p & 1).astype(jnp.bool_)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _roll(x: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Static roll along the last axis (shift > 0 rolls right), as a
    concat of two static slices."""
    n = x.shape[-1]
    s = shift % n
    if s == 0:
        return x
    return jnp.concatenate([x[..., n - s :], x[..., : n - s]], axis=-1)


def _lane_iota(ndim: int, length: int) -> jnp.ndarray:
    """[1, ..., 1, L] int32 iota along the last axis."""
    shape = (1,) * max(ndim - 1, 1) + (length,)
    return jax.lax.broadcasted_iota(jnp.int32, shape, len(shape) - 1)


def _xor_partner(x: jnp.ndarray, j: int) -> jnp.ndarray:
    """x[i ^ j] along the last axis in ONE shuffle: view the lane axis as
    [g, 2, j] pair-blocks and reverse the pair axis. XLA lowers this to a
    single copy (vs two concat-of-slices rolls that also block fusion of
    the surrounding elementwise ops)."""
    b = x.shape[:-1]
    length = x.shape[-1]
    r = x.reshape(*b, length // (2 * j), 2, j)
    r = jax.lax.rev(r, dimensions=(r.ndim - 2,))
    return r.reshape(*b, length)


def _stage(
    keys, vals, j: int, is_lo: jnp.ndarray, want_small: jnp.ndarray,
    impl: str = "roll",
):
    """One compare-exchange stage with partner distance j.

    Element i pairs with i ^ j; ``is_lo`` marks (i & j) == 0 positions and
    ``want_small`` the positions that keep the smaller key of the pair
    (both broadcastable iota-derived masks). Ties keep the resident
    element on both sides, so the exchange stays consistent.

    impl: see module docstring.
    """

    def partner(x):
        if impl == "xor":
            return _xor_partner(x, j)
        # partner value: x[i + j] for lo positions, x[i - j] for hi ones
        return jnp.where(is_lo, _roll(x, -j), _roll(x, j))

    kp = partner(keys)
    take = jnp.logical_or(
        jnp.logical_and(want_small, kp < keys),
        jnp.logical_and(jnp.logical_not(want_small), kp > keys),
    )
    keys = jnp.where(take, kp, keys)
    new_vals = [jnp.where(take, partner(v), v) for v in vals]
    return keys, new_vals


def bitonic_sort(
    keys: jnp.ndarray,
    *vals: jnp.ndarray,
    descending: bool = False,
    impl: str = "roll",
):
    """Sort by keys along the last axis (ascending by default); vals follow.

    keys [..., L] with L a power of two. Returns (keys, vals...).
    """
    length = keys.shape[-1]
    assert length & (length - 1) == 0, f"L={length} must be a power of two"
    iota = _lane_iota(keys.ndim, length)
    k = 2
    while k <= length:
        # ascending-block mask for sub-sequence size k (final pass: all asc)
        if k >= length:
            dirs = jnp.full(iota.shape, not descending)
        else:
            dirs = ((iota & k) == 0) != descending
        j = k // 2
        while j >= 1:
            is_lo = (iota & j) == 0
            want_small = is_lo == dirs
            keys, vals = _stage(keys, vals, j, is_lo, want_small, impl)
            j //= 2
        k *= 2
    return (keys, *vals)


def _merge_stages(keys, vals, length: int, impl: str = "roll"):
    """Finish sorting a bitonic sequence: stages j = L/2 .. 1, ascending."""
    iota = _lane_iota(keys.ndim, length)
    j = length // 2
    while j >= 1:
        is_lo = (iota & j) == 0
        keys, vals = _stage(keys, vals, j, is_lo, is_lo, impl)  # ascending
        j //= 2
    return keys, vals


def bitonic_topk_merge_sorted(
    beam_d: jnp.ndarray,
    beam_i: jnp.ndarray,
    beam_x: jnp.ndarray,
    new_d: jnp.ndarray,
    new_i: jnp.ndarray,
    impl: str = "roll",
):
    """Merge a sorted-ascending beam with new candidates; keep smallest EF.

    beam_* [..., EF] with EF a power of two, sorted ascending by beam_d;
    new_* [..., W], any W. Returns (beam_d, beam_i, beam_x) sorted
    ascending, EF wide. New entries come in unexpanded (x = False).

    Cost: full bitonic sort of the new block (W wide, descending) + one
    split stage + log2(max(EF, W)) merge stages — instead of a full
    O(log^2) sort of the whole EF+W concatenation: the (ascending ++
    descending) concatenation is bitonic by construction. The (id, flag)
    pair rides the network as ONE packed int32 payload (pack_iv), so a
    stage moves two arrays, not three.
    """
    ef = beam_d.shape[-1]
    assert ef & (ef - 1) == 0, f"EF={ef} must be a power of two"
    x_bool = beam_x.dtype == jnp.bool_
    beam_p = pack_iv(beam_i, beam_x)
    w = new_d.shape[-1]
    wp = _next_pow2(w)
    new_p = pack_iv(new_i, jnp.zeros(new_i.shape, jnp.bool_))
    if wp != w:
        pad = [(0, 0)] * (new_d.ndim - 1) + [(0, wp - w)]
        new_d = jnp.pad(new_d, pad, constant_values=jnp.inf)
        new_p = jnp.pad(new_p, pad, constant_values=0)  # id -1, unexpanded
    # descending sort: +inf padding lands at the front, so a further
    # front-pad below keeps the block descending (no lax.rev needed)
    nd, np_ = bitonic_sort(new_d, new_p, descending=True, impl=impl)

    s = max(ef, wp)
    if ef < s:  # widen the beam with +inf tail (stays ascending)
        pad = [(0, 0)] * (beam_d.ndim - 1) + [(0, s - ef)]
        bd = jnp.pad(beam_d, pad, constant_values=jnp.inf)
        bp = jnp.pad(beam_p, pad, constant_values=1)  # id -1, expanded
    else:
        bd, bp = beam_d, beam_p
    if wp < s:
        pad = [(0, 0)] * (nd.ndim - 1) + [(s - wp, 0)]
        nd = jnp.pad(nd, pad, constant_values=jnp.inf)
        np_ = jnp.pad(np_, pad, constant_values=0)

    # split stage of the (ascending ++ descending) bitonic 2s-sequence:
    # lower half takes the pairwise min and is itself bitonic, holding the
    # s smallest elements overall (bitonic split theorem)
    take = nd < bd  # tie keeps the beam entry
    d0 = jnp.where(take, nd, bd)
    p0 = jnp.where(take, np_, bp)
    d0, (p0,) = _merge_stages(d0, [p0], s, impl)
    i0, x0 = unpack_iv(p0[..., :ef])
    x0 = x0 if x_bool else x0.astype(jnp.int32)
    return d0[..., :ef], i0, x0


def rank_topk_merge_sorted(
    beam_d: jnp.ndarray,
    beam_i: jnp.ndarray,
    beam_x: jnp.ndarray,
    new_d: jnp.ndarray,
    new_i: jnp.ndarray,
):
    """Merge beam + candidate window by O(S^2) rank computation.

    Same contract as bitonic_topk_merge_sorted (and stable, so equal keys
    keep beam-then-window order), but with ZERO sequential stages (the
    bitonic network is 28 dependent compare-exchange stages of cross-lane
    shuffles at the search shape). Here every element's output position is its rank in the union — one
    [S, S] compare-reduce (S = EF + W, ~80: tiny, embarrassingly
    parallel) — and placement is a one-hot select-reduce instead of a
    scatter. All the work sits in two big fusable reductions with no
    dependency chain.
    """
    ef = beam_d.shape[-1]
    d = jnp.concatenate([beam_d, new_d], axis=-1)  # [., S]
    p = jnp.concatenate(
        [
            pack_iv(beam_i, beam_x),
            pack_iv(new_i, jnp.zeros(new_i.shape, jnp.bool_)),
        ],
        axis=-1,
    )
    s = d.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, (s,), 0)
    di = d[..., :, None]
    dj = d[..., None, :]
    # precedes[j, i]: element j sorts before element i (index tie-break)
    precedes = jnp.logical_or(
        dj < di,
        jnp.logical_and(dj == di, iota[None, :] < iota[:, None]),
    )
    rank = jnp.sum(precedes, axis=-1)  # [., S], a permutation of 0..S-1
    onehot = rank[..., :, None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, ef), 1
    )  # [., S, EF]
    out_d = jnp.sum(jnp.where(onehot, di, 0.0), axis=-2)
    out_p = jnp.sum(jnp.where(onehot, p[..., :, None], 0), axis=-2)
    i0, x0 = unpack_iv(out_p)
    x0 = x0 if beam_x.dtype == jnp.bool_ else x0.astype(beam_x.dtype)
    return out_d, i0, x0


def bitonic_topk_merge(
    beam_d: jnp.ndarray,
    beam_i: jnp.ndarray,
    beam_x: jnp.ndarray,
    new_d: jnp.ndarray,
    new_i: jnp.ndarray,
):
    """Merge a *sorted-ascending* beam with new candidates; keep smallest EF.

    Back-compat wrapper over bitonic_topk_merge_sorted (the beam in every
    caller is sorted ascending by construction; seed beams qualify because
    all non-seed slots are +inf).
    """
    return bitonic_topk_merge_sorted(beam_d, beam_i, beam_x, new_d, new_i)


def bitonic_smallest(d: jnp.ndarray, *vals: jnp.ndarray, k: int, impl: str = "roll"):
    """Smallest-k along the last axis via one bitonic sort + slice.

    d [..., L] (L any width; padded to a power of two with +inf), vals
    follow. Returns (d [..., k] ascending, vals...). Stands in for
    lax.top_k (see the module docstring).
    """
    w = d.shape[-1]
    wp = _next_pow2(w)
    if wp != w:
        pad = [(0, 0)] * (d.ndim - 1) + [(0, wp - w)]
        d = jnp.pad(d, pad, constant_values=jnp.inf)
        vals = tuple(jnp.pad(v, pad, constant_values=-1) for v in vals)
    out = bitonic_sort(d, *vals, impl=impl)
    return tuple(o[..., :k] for o in out)
