"""Interleaved (in-place) Haar layout: the stencil form of the transform.

The reference stores each axis pass as (low half, high half).  The
interleaved layout keeps every pass in place instead:

    out[2l]   = (v[2l] + v[2l+1]) / 2      (low  stays at even index)
    out[2l+1] = (v[2l] - v[2l+1]) / 2      (high stays at odd index)

A pair never leaves its aligned ``2 * stride`` block, so an array split
along X into shards whose extent divides by ``2**scales`` transforms every
shard on its own, with no data exchanged between shards.  The giant-box
path (runtime/distributed.py) relies on that: one box sharded over X runs
the whole pyramid with zero collectives.

The reference's halves order is recovered by a fixed logical->physical
index map (:func:`interleave_perm` per axis at one scale,
:func:`interleave_map_multi` for a pyramid) that the host packer walks, so
archive bytes do not depend on the layout.  The arithmetic is the same
single float32 rounding per output as core/haar.py, so results are bitwise
equal to the reference math (tests/test_interleaved.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["interleave_perm", "interleave_coords_multi",
           "interleave_map_multi", "interleaved_ok", "forward_block",
           "inverse_block"]


def interleave_perm(n: int) -> np.ndarray:
    """Logical (reference halves-order) index -> physical interleaved index.

    lows l < n//2 live at 2l; highs at 2(l - n//2) + 1; an odd axis's last
    element stays in place (compressor.cpp:107 leaves it untransformed).
    """
    h = n // 2
    p = np.empty(n, np.int64)
    p[:h] = 2 * np.arange(h)
    p[h : 2 * h] = 2 * np.arange(h) + 1
    if n % 2:
        p[n - 1] = n - 1
    return p


def interleave_coords_multi(dims, scales: int):
    """Physical coordinates of every LOGICAL pyramid position for the
    multi-scale interleaved layout: returns (PX, PY, PZ), each int64
    [X, Y, Z], with ``logical (i, j, k) -> physical (PX[ijk], PY[ijk],
    PZ[ijk])``.

    The map is NOT a per-axis product for scales > 1: a coordinate in a
    high band means the other axes were never re-transformed at deeper
    scales (haar3d_forward_multi only recurses into the corner block), so
    membership of the block decides which scale's per-axis map applies.
    Recursion mirrors the pyramid: outside the corner block, the
    single-scale maps apply; inside, recurse on the half-dims and double
    (scale-1 lows sit at even physical positions in every axis).
    """
    x, y, z = (int(d) for d in dims)
    px1, py1, pz1 = (interleave_perm(n) for n in (x, y, z))
    PX = np.broadcast_to(px1[:, None, None], (x, y, z)).copy()
    PY = np.broadcast_to(py1[None, :, None], (x, y, z)).copy()
    PZ = np.broadcast_to(pz1[None, None, :], (x, y, z)).copy()
    if scales > 1 and x % 2 == 0 and y % 2 == 0 and z % 2 == 0:
        hx, hy, hz = x // 2, y // 2, z // 2
        QX, QY, QZ = interleave_coords_multi((hx, hy, hz), scales - 1)
        PX[:hx, :hy, :hz] = 2 * QX
        PY[:hx, :hy, :hz] = 2 * QY
        PZ[:hx, :hy, :hz] = 2 * QZ
    return PX, PY, PZ


def interleave_map_multi(dims, scales: int, sx: int, sy: int, sz: int = 1):
    """Flat physical element offsets per logical position: int64[X*Y*Z]
    with strides (sx, sy, sz) — the host packer's walk table for the
    multi-scale interleaved layout.

    Built directly in flat form: the corner block's recursive map uses
    the PARENT's strides throughout (physical coords double per scale, so
    ``corner = 2 * submap`` with the same (sx, sy, sz)), which means the
    three int64 [X, Y, Z] coordinate temporaries of
    :func:`interleave_coords_multi` (24 B/element on top of the 8 B
    result — prohibitive for giant boxes) are never materialized; peak is
    the result plus broadcast scratch.  Bitwise-identical to the
    coordinate route (tests/test_interleaved.py)."""
    x, y, z = (int(d) for d in dims)
    px1, py1, pz1 = (interleave_perm(n) for n in (x, y, z))
    m = (px1[:, None, None] * sx + py1[None, :, None] * sy
         + pz1[None, None, :] * sz)
    if scales > 1 and x % 2 == 0 and y % 2 == 0 and z % 2 == 0:
        hx, hy, hz = x // 2, y // 2, z // 2
        m[:hx, :hy, :hz] = 2 * interleave_map_multi(
            (hx, hy, hz), scales - 1, sx, sy, sz).reshape(hx, hy, hz)
    return m.reshape(-1)


def interleaved_ok(dims, scales: int = 1) -> bool:
    """The stencil needs extents divisible by ``2**scales`` (odd tails keep
    the halves layout, which handles the reference's stay-in-place and
    zeroing quirks; deeper pyramids need deeper divisibility, the same
    rule as haar3d_forward_multi)."""
    q = 1 << max(1, int(scales))
    return all(int(d) % q == 0 for d in dims)


def _pass(v: jax.Array, axis: int, stride: int = 1, inverse: bool = False,
          member=None) -> jax.Array:
    """One in-place Haar pass along ``axis``.

    ``stride = 2**(s-1)`` selects scale ``s`` of the pyramid: the pass
    pairs positions ``(2m*stride, (2m+1)*stride)``.  ``member`` restricts
    it to the scale's corner block (positions that are scale-(s-1) lows in
    EVERY axis — the block ``haar3d_forward_multi`` re-transforms); a
    member's roll partner is itself a member, so partners are always
    valid.
    """
    left = jnp.roll(v, -stride, axis)    # partner of even-position lows
    right = jnp.roll(v, stride, axis)    # partner of odd-position entries
    idx = jax.lax.broadcasted_iota(jnp.int32, v.shape, axis)
    parity = (idx // stride) % 2
    half = jnp.asarray(0.5, v.dtype)
    if inverse:
        even_out = v + left          # avg + diff
        odd_out = right - v          # avg - diff
    else:
        even_out = (v + left) * half
        odd_out = (right - v) * half
    out = jnp.where(parity == 0, even_out, odd_out)
    if member is None:
        return out
    return jnp.where(member, out, v)


def _scale_member(shape, stride: int):
    """Membership mask of the scale's corner block in interleaved space:
    positions that are multiples of ``stride`` along every axis."""
    if stride == 1:
        return None
    m = None
    for axis in range(3):
        idx = jax.lax.broadcasted_iota(jnp.int32, shape, axis)
        cond = idx % stride == 0
        m = cond if m is None else (m & cond)
    return m


def forward_block(v: jax.Array, scales: int = 1) -> jax.Array:
    """(X, Y, Z) forward: per scale, Z, Y, X passes, all in place (scale s
    pairs at stride 2**(s-1) within the corner block).  Valid on any X
    block whose extent divides by 2**scales: block-local row indices then
    have the same corner membership and pair parity as the global ones, so
    a blocked or sharded run is bitwise-identical to a whole-extent run."""
    for s in range(scales):
        st = 1 << s
        member = _scale_member(v.shape, st)
        v = _pass(v, 2, st, member=member)
        v = _pass(v, 1, st, member=member)
        v = _pass(v, 0, st, member=member)
    return v


def inverse_block(v: jax.Array, scales: int = 1) -> jax.Array:
    """Coarsest scale first, X, Y, Z inverse passes per scale; input
    interleaved, output natural spatial."""
    for s in reversed(range(scales)):
        st = 1 << s
        member = _scale_member(v.shape, st)
        v = _pass(v, 0, st, inverse=True, member=member)
        v = _pass(v, 1, st, inverse=True, member=member)
        v = _pass(v, 2, st, inverse=True, member=member)
    return v
