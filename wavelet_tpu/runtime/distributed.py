"""Multi-device compress step with explicit collectives (shard_map).

The reference is strictly serial; this module is the multi-device
execution path: boxes/timesteps shard over the ``data`` mesh axis, and the
*global* coefficient threshold is computed with an all-reduced magnitude
histogram (``lax.psum``/``lax.pmax``, which XLA hands to NCCL on GPUs)
instead of the per-box rule.

Two modes:

- :func:`make_parity_compress_step` — per-item signed-absmax thresholds (the
  reference rule), fully data-parallel; maxima come back per item, no
  cross-shard communication.
- :func:`make_global_compress_step` — one histogram-quantile threshold
  across every coefficient on every device.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.sharding import NamedSharding

from wavelet_tpu.core import haar, interleave, threshold
from wavelet_tpu.runtime.mesh import DATA_AXIS

try:  # jax>=0.4.35 moved shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["make_parity_compress_step", "make_global_compress_step",
           "kept_count",
           "make_train_step", "make_sharded_box_forward",
           "make_sharded_box_inverse",
           "make_sharded_box_forward_interleaved",
           "make_sharded_box_inverse_interleaved"]


def make_parity_compress_step(mesh):
    """jit(batch [N, X, Y, Z] sharded on N) -> (flat [N, XYZ], absmax [N])."""
    sh = NamedSharding(mesh, P(DATA_AXIS))

    @partial(jax.jit,
             in_shardings=sh,
             out_shardings=(sh, NamedSharding(mesh, P(DATA_AXIS))))
    def step(batch):
        flat = haar.forward_flat(batch)
        return flat, threshold.signed_absmax(flat, axis=-1)

    return step


def kept_count(limbs) -> int:
    """Recombine :func:`make_global_compress_step`'s two-limb kept count
    (int32 [lo16, hi16] sums) into the exact global count."""
    lo, hi = (int(v) for v in np.asarray(limbs))
    return lo + (hi << 16)


def make_global_compress_step(mesh, keep_fraction: float,
                              n_pad_rows: int = 0):
    """jit(batch [N, X, Y, Z] sharded on N) ->
    (masked coeffs [N, XYZ], global threshold scalar, kept count int32[2]
    — two 16-bit limb sums; recombine with :func:`kept_count`).

    The threshold is a single magnitude quantile over the *entire* sharded
    batch, reduced across the mesh with a psum'd fixed float-bit histogram
    (BASELINE.json configs 4-5) — the SAME bins and selection rule as the
    CLI pipeline's host path (threshold.threshold_from_histogram), so both
    paths derive the identical threshold and identical archive bytes for
    the same data (tests/test_global_threshold.py)."""

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS),
             out_specs=(P(DATA_AXIS), P(), P()))
    def step(batch):
        flat = haar.forward_flat(batch)
        # n_pad_rows: zero rows appended to reach a mesh multiple must
        # not skew the quantile (the CLI host path subtracts the same
        # padding from its histogram)
        thr = threshold.global_histogram_threshold(
            flat, keep_fraction, axis_name=DATA_AXIS,
            n_pad_coeffs=n_pad_rows * flat.shape[1])
        mask = jnp.abs(flat) > thr
        # two 16-bit limbs: a plain int32 psum of per-shard counts wraps
        # once the GLOBAL kept crosses 2^31 (realistic across many devices —
        # the same overflow threshold_from_histogram_device's limb psum
        # avoids); limb sums stay exact for up to 32k shards
        local = jnp.sum(mask, dtype=jnp.int32)
        kept = jax.lax.psum(
            jnp.stack([local & 0xFFFF, local >> 16]), DATA_AXIS)
        return jnp.where(mask, flat, jnp.zeros_like(flat)), thr, kept

    return jax.jit(step)


def _exchange_perms(D: int):
    """Static ppermute patterns for the cross-shard X-pass regroup.

    After the local pair transform, shard s holds its low and high half
    pieces; globally all lows must precede all highs, so shard s's low piece
    belongs on shard s//2 (slot s%2) and its high piece on D//2 + s//2.
    Sources of equal parity form disjoint permutations, so the full
    exchange is four ppermutes.
    """
    lo_even = [(s, s // 2) for s in range(0, D, 2)]
    lo_odd = [(s, s // 2) for s in range(1, D, 2)]
    hi_even = [(s, D // 2 + s // 2) for s in range(0, D, 2)]
    hi_odd = [(s, D // 2 + s // 2) for s in range(1, D, 2)]
    return lo_even, lo_odd, hi_even, hi_odd


def make_sharded_box_forward(mesh):
    """Forward Haar for ONE giant box sharded over the mesh's X axis.

    Capability with no reference analogue: boxes too large for a single
    device's memory are laid out ``[X, Y, Z]`` with X sharded across devices.
    The Z and Y passes are shard-local (whole-box single-scale Haar needs no
    spatial halos; pairs never straddle an even shard boundary).  The X
    pass pairs locally, then the low/high pieces regroup across shards with
    four ``lax.ppermute`` boundary exchanges — this is the
    block-boundary exchange machinery of BASELINE.json config 5.

    Requires: even shard extent and an even number of devices.
    """
    D = mesh.size
    assert D % 2 == 0, "sharded-box transform needs an even device count"
    perms = _exchange_perms(D)

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS))
    def fwd(xl):
        xs = xl.shape[0]
        assert xs % 2 == 0, "shard extent must be even"
        t = haar._along(haar._fwd_last, xl, -1)   # Z pass (local)
        t = haar._along(haar._fwd_last, t, -2)    # Y pass (local)
        v = t.reshape((xs // 2, 2) + t.shape[1:])
        low = (v[:, 0] + v[:, 1]) * jnp.asarray(0.5, t.dtype)
        high = (v[:, 0] - v[:, 1]) * jnp.asarray(0.5, t.dtype)
        lo_e, lo_o, hi_e, hi_o = perms
        r_lo_e = jax.lax.ppermute(low, DATA_AXIS, lo_e)
        r_lo_o = jax.lax.ppermute(low, DATA_AXIS, lo_o)
        r_hi_e = jax.lax.ppermute(high, DATA_AXIS, hi_e)
        r_hi_o = jax.lax.ppermute(high, DATA_AXIS, hi_o)
        is_low_side = jax.lax.axis_index(DATA_AXIS) < D // 2
        first = jnp.where(is_low_side, r_lo_e, r_hi_e)
        second = jnp.where(is_low_side, r_lo_o, r_hi_o)
        return jnp.concatenate([first, second], axis=0)

    return jax.jit(fwd)


def make_sharded_box_inverse(mesh):
    """Inverse of :func:`make_sharded_box_forward` (X, then Y, then Z, as
    decompressor.cpp:90-156): the boundary exchange runs first, reversed."""
    D = mesh.size
    assert D % 2 == 0
    lo_e, lo_o, hi_e, hi_o = _exchange_perms(D)
    inv = lambda pairs: [(d, s) for s, d in pairs]

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS))
    def bwd(cl):
        xs = cl.shape[0]
        h = xs // 2
        first = cl[:h]
        second = cl[h:]
        is_low_side = jax.lax.axis_index(DATA_AXIS) < D // 2
        low_piece = jnp.where(is_low_side, first, jnp.zeros_like(first))
        low_piece2 = jnp.where(is_low_side, second, jnp.zeros_like(second))
        high_piece = jnp.where(is_low_side, jnp.zeros_like(first), first)
        high_piece2 = jnp.where(is_low_side, jnp.zeros_like(second), second)
        # send pieces back to their origin shards
        avg = (jax.lax.ppermute(low_piece, DATA_AXIS, inv(lo_e))
               + jax.lax.ppermute(low_piece2, DATA_AXIS, inv(lo_o)))
        diff = (jax.lax.ppermute(high_piece, DATA_AXIS, inv(hi_e))
                + jax.lax.ppermute(high_piece2, DATA_AXIS, inv(hi_o)))
        even = avg + diff
        odd = avg - diff
        t = jnp.stack([even, odd], axis=1).reshape((xs,) + cl.shape[1:])
        t = haar._along(haar._inv_last, t, -2)    # Y pass (local)
        return haar._along(haar._inv_last, t, -1)  # Z pass (local)

    return jax.jit(bwd)


def make_sharded_box_forward_interleaved(mesh, scales: int = 1):
    """Multi-scale forward Haar for ONE giant box sharded over X — with
    ZERO boundary exchange.

    The halves-layout path (:func:`make_sharded_box_forward`) must regroup
    low/high pieces across shards with four ppermutes, and generalizing
    that regroup to a pyramid would need a different exchange pattern per
    scale.  The interleaved (in-place) layout dissolves the problem: the
    scale-``s`` pass pairs positions ``(2m*st, (2m+1)*st)`` with
    ``st = 2**(s-1)`` — both endpoints always inside the same aligned
    ``2*st``-element block — so as long as each shard's X extent is a
    multiple of ``2**scales``, every pair at every scale is shard-local
    and the whole pyramid runs without a single collective.  Corner-block
    membership is also local: ``global_x %% st == local_x %% st`` because
    ``st`` divides the shard extent.

    Output: interleaved-layout coefficients, sharded over X.  The host
    recovers the reference order with the
    ``interleave.interleave_map_multi`` walk tables (bitwise-identical
    archives; see tests/test_multichip.py).
    """
    q = 1 << max(1, int(scales))

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS),
             out_specs=P(DATA_AXIS))
    def fwd(xl):
        assert xl.shape[0] % q == 0, (
            f"shard X extent {xl.shape[0]} must divide by 2**scales={q}")
        return interleave.forward_block(xl, scales)

    return jax.jit(fwd)


def make_sharded_box_inverse_interleaved(mesh, scales: int = 1):
    """Inverse of :func:`make_sharded_box_forward_interleaved`: consumes
    interleaved coefficients sharded over X, emits the natural spatial
    box — again with zero collectives."""
    q = 1 << max(1, int(scales))

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS),
             out_specs=P(DATA_AXIS))
    def bwd(cl):
        assert cl.shape[0] % q == 0, (
            f"shard X extent {cl.shape[0]} must divide by 2**scales={q}")
        return interleave.inverse_block(cl, scales)

    return jax.jit(bwd)


def make_train_step(mesh, keep_fraction: float = 0.05):
    """The full multi-device 'step' for one batch: forward transform, global
    all-reduce threshold, masking, inverse transform, and the all-reduced
    RMSE of the lossy round trip — every collective the framework uses, in
    one compiled program.  (This is what ``__graft_entry__.dryrun_multichip``
    compiles and runs.)"""

    @partial(shard_map, mesh=mesh, in_specs=P(DATA_AXIS),
             out_specs=(P(DATA_AXIS), P(), P()))
    def step(batch):
        flat = haar.forward_flat(batch)
        thr = threshold.global_histogram_threshold(
            flat, keep_fraction, axis_name=DATA_AXIS)
        masked = jnp.where(jnp.abs(flat) > thr, flat, jnp.zeros_like(flat))
        recon = haar.inverse_from_flat(masked, batch.shape[-3:])
        err = (recon - batch).astype(jnp.float32)
        sq = jax.lax.psum(jnp.sum(err * err), DATA_AXIS)
        cnt = jax.lax.psum(jnp.asarray(err.size, jnp.float32), DATA_AXIS)
        return recon, thr, jnp.sqrt(sq / cnt)

    return jax.jit(step)


# --- cross-host giant boxes (VERDICT r3 stretch item 7) --------------------
#
# A box larger than one HOST's devices shards over the GLOBAL multi-process
# mesh.  The interleaved transform needs no collectives (every Haar pair at
# every scale is shard-local — see make_sharded_box_forward_interleaved),
# so the cross-host case adds only data plumbing: each process contributes
# its X-slab via jax.make_array_from_process_local_data, the same
# shard-mapped kernels run SPMD across processes, and the packing host
# gathers the coefficient slabs back (host RAM is far larger than device
# memory, so the gather target fits where the box itself could not).

def giant_from_process_slabs(mesh, local_slab, global_shape):
    """Assemble a globally-X-sharded giant box from per-process slabs.

    ``local_slab``: this process's contiguous X-rows (host numpy), i.e.
    rows [sum of previous processes' extents : +local extent).  Every
    process must call this collectively with the same ``global_shape``.
    """
    sh = NamedSharding(mesh, P(DATA_AXIS))
    return jax.make_array_from_process_local_data(sh, local_slab,
                                                  global_shape)


def gather_giant(arr):
    """Fetch a globally-sharded giant array to EVERY process's host memory
    (jax.experimental.multihost_utils allgather); the work-item
    owner packs from its copy.  A fully-addressable array — single
    process, OR a process-LOCAL giant mesh in a multi-process run — is a
    plain fetch: routing it through ``process_allgather(tiled=True)``
    would CONCATENATE each process's (different) local array along X and
    return mixed garbage, so the guard lives here, not in the caller."""
    if arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
