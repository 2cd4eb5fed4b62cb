"""Coefficient thresholding with exact reference parity, TPU-friendly.

Reference rule (``compressor.cpp:212-234``): per (box, component),

    max_val = the *signed* coefficient whose |value| is largest (first on ties)
    thresh  = max_val * (1 - keep)          # in double
    keep c  iff |c| > thresh                # |c| widened to double

Quirk preserved: if the largest-magnitude coefficient is negative, ``thresh``
is negative and *every* coefficient (zeros included) survives (SURVEY.md §5.2).

TPU strategy: ``signed_absmax`` is a cheap on-device reduction (an ``argmax``
— the degenerate quantile; the general histogram-quantile for the new global
threshold modes lives in :func:`global_histogram_threshold`).  The double-
precision comparison is reproduced *without* f64 device math via a rounding
trick: for float32 ``|c|``, ``|c| > thresh_f64`` iff ``|c| > t32`` where
``t32`` is the largest float32 ≤ ``thresh_f64``.  ``exact_threshold32``
computes that on host from the per-box maxima (an [N]-sized op).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "signed_absmax",
    "exact_threshold32",
    "mask_coefficients",
    "global_histogram_threshold",
    "EXP_HIST_BINS",
    "abs_exponent_histogram",
    "threshold_from_histogram",
    "threshold_from_histogram_device",
]


def signed_absmax(coeffs: jax.Array, axis: int = -1) -> jax.Array:
    """Signed value of the largest-|.| element along ``axis`` (first on ties).

    Matches ``std::max_element`` with an |a|<|b| comparator
    (compressor.cpp:212-215): strict-less keeps the earliest maximum.
    ``jnp.argmax`` also returns the first occurrence.
    """
    idx = jnp.argmax(jnp.abs(coeffs), axis=axis)
    return jnp.take_along_axis(
        coeffs, jnp.expand_dims(idx, axis), axis=axis
    ).squeeze(axis)


def exact_threshold32(max_vals: np.ndarray, keep: float) -> np.ndarray:
    """float32 thresholds reproducing the double comparison exactly.

    ``thresh64 = f64(max_val) * (1 - keep)`` as the reference computes it;
    returns the largest float32 ≤ thresh64, so that a float32 magnitude
    compares ``> t32`` exactly when it compares ``> thresh64``.
    """
    thresh64 = max_vals.astype(np.float64) * (1.0 - float(keep))
    t32 = thresh64.astype(np.float32)
    too_high = t32.astype(np.float64) > thresh64
    t32 = np.where(too_high, np.nextafter(t32, np.float32(-np.inf)), t32)
    return np.asarray(t32, dtype=np.float32)


def mask_coefficients(coeffs: jax.Array, t32: jax.Array) -> jax.Array:
    """Boolean keep-mask: ``|c| > t32`` broadcast over trailing axes."""
    return jnp.abs(coeffs) > t32[..., None]


# 11-bit keys: sign-stripped float32 bits >> 20 = 8 exponent bits + 3
# mantissa bits, monotone in |c|; quantile resolution ~2^-4 relative.
# (abs clears the sign bit, so 31 bits >> 20 caps the key at 0x7FF = 2047
# — the round-4 4096-bin table's top half was provably always zero, and
# every host accumulation, process allgather and two-limb psum moved 2x the
# needed bytes.)
EXP_HIST_BINS = 2048
_EXP_SHIFT = 20


def abs_exponent_histogram(coeffs: jax.Array) -> jax.Array:
    """uint32[EXP_HIST_BINS] histogram of |coeffs| with float-bit bucketing.

    Bin edges are fixed properties of the float32 format, so partial
    histograms from different batches/shapes/devices merge by plain
    addition — no prior max pass, deterministic under any sharding.  This is the
    device-side building block of the *global* threshold mode (the new
    TPU-native capability of BASELINE.json configs 4-5).

    uint32 counts are exact for any single call (one call covers at most
    one device's memory worth of f32 coefficients, < 2^32); callers that
    accumulate across batches do so in int64 on host (pipeline/compress.py)
    or with the 16-bit-limb psum of :func:`threshold_from_histogram_device`
    across shards.
    """
    bits = jax.lax.bitcast_convert_type(
        jnp.abs(coeffs.reshape(-1)), jnp.int32)
    keys = jax.lax.shift_right_logical(bits, _EXP_SHIFT)
    return jnp.zeros((EXP_HIST_BINS,), jnp.uint32).at[keys].add(1)


def threshold_from_histogram(hist: np.ndarray, keep_fraction: float) -> np.float32:
    """Magnitude threshold keeping ~``keep_fraction`` of all coefficients.

    Picks the smallest bin edge such that the count of strictly-greater bins
    is <= target; coefficients compare ``|c| > thresh``.
    """
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    target = keep_fraction * total
    above = np.cumsum(hist[::-1])[::-1]  # above[k] = count of bins >= k
    # smallest k with above[k] <= target -> keep bins >= k, threshold is the
    # lower edge of bin k-1 (i.e. all of bin k and up survive |c| > edge)
    ks = np.nonzero(above <= target)[0]
    k = int(ks[0]) if len(ks) else EXP_HIST_BINS
    # if the target fell inside a populated bin such that bins >= k hold
    # nothing at all, keeping "nothing" silently zeroes low-entropy fields
    # (e.g. a constant box concentrates every coefficient in one bin);
    # overshoot the target instead by stepping down to the last populated bin
    while k > 1 and (k >= len(above) or above[k] == 0):
        k -= 1
    if k <= 1:
        return np.float32(0.0)
    # |c| > thresh must hold exactly for bins >= k: thresh is the largest
    # float below bin k's lower edge, i.e. bits (k << shift) - 1
    prev = np.uint32((k << _EXP_SHIFT) - 1)
    return prev.view(np.float32)


def threshold_from_histogram_device(hist: jax.Array,
                                    keep_fraction: float,
                                    total,
                                    *,
                                    axis_name: str | None = None,
                                    pad_zeros: int = 0) -> jax.Array:
    """In-jit :func:`threshold_from_histogram` — bin-for-bin identical
    semantics to the host version, so the shard_map collective path and the
    CLI pipeline derive the *same* threshold (and therefore identical
    archive bytes) from the same data.

    ``hist`` is one shard's uint32 fixed-bin histogram
    (:func:`abs_exponent_histogram`); with ``axis_name`` it is all-reduced
    over the mesh as two 16-bit int32 limbs (exact for any mesh size — a
    plain int32/uint32 psum would wrap once the per-bin total crosses 2^31,
    which one fat bin reaches at ~8 GiB of f32 per shard x mesh size).
    ``total`` is the *global* number of real coefficients (pass the psum'd
    count, or a static value).

    The cumulative count runs in float32: exact below 2^24 total
    coefficients, and above that the ~1e-7 relative rounding is orders of
    magnitude finer than the ~6% bin width itself.
    """
    if axis_name is not None:
        lo = jax.lax.psum((hist & jnp.uint32(0xFFFF)).astype(jnp.int32),
                          axis_name)
        hi = jax.lax.psum(
            jax.lax.shift_right_logical(hist, jnp.uint32(16)).astype(
                jnp.int32), axis_name)
        histf = hi.astype(jnp.float32) * 65536.0 + lo.astype(jnp.float32)
    else:
        histf = hist.astype(jnp.float32)
    if pad_zeros:
        # applied AFTER the psum: zero padding rows land in bin 0 on
        # whichever shards hold them, so one global correction — the
        # same hist[0] -= n_pad * m the CLI host path performs
        histf = histf.at[0].add(jnp.float32(-int(pad_zeros)))
    above = jnp.cumsum(histf[::-1])[::-1]  # above[k] = count in bins >= k
    if isinstance(total, (int, float)):
        # static total: the host compares integer counts against the f64
        # target, and ``int_count <= real_target`` is exactly
        # ``int_count <= floor(real_target)`` — so take the floor in
        # Python f64 and compare against that integer (rounding the f64
        # target itself to f32 could round UP across an integer boundary
        # and flip the comparison, e.g. keep_fraction=0.29, total=100)
        import math

        target = jnp.float32(math.floor(float(keep_fraction) * float(total)))
    else:
        # traced total: the f32 product cannot take the exact f64 floor
        # above, so at a knife-edge integer boundary (e.g. 0.29 * 100)
        # the selection can land one bin off the host's.  Every
        # production path passes a STATIC total (batch shapes are
        # static), which is the configuration the bit-parity guarantee
        # covers; traced totals trade that corner for in-jit dynamism.
        target = total.astype(jnp.float32) * jnp.float32(keep_fraction)
    le = above <= target
    # host: smallest k with above[k] <= target, else EXP_HIST_BINS
    k0 = jnp.where(jnp.any(le), jnp.argmax(le), EXP_HIST_BINS)
    # host: step down while bins >= k hold nothing (above[k] == 0), i.e.
    # clamp to the last index with above > 0 (above is non-increasing)
    kmax = jnp.sum((above > 0).astype(jnp.int32)) - 1
    k = jnp.minimum(k0.astype(jnp.int32), kmax)
    thr = jax.lax.bitcast_convert_type(
        (jnp.left_shift(k, _EXP_SHIFT) - 1).astype(jnp.int32), jnp.float32)
    return jnp.where(k <= 1, jnp.float32(0.0), thr)


def global_histogram_threshold(coeffs: jax.Array,
                               keep_fraction: float,
                               *,
                               axis_name: str | None = None,
                               n_pad_coeffs: int = 0) -> jax.Array:
    """Global coefficient-magnitude quantile via an all-reduced histogram.

    This is the *new* thresholding mode mandated by BASELINE.json's
    north star ("on-device global coefficient-magnitude quantile computed via
    all-reduce histograms across the devices") — the reference has no
    equivalent (its rule is per-box, see above).  Given sharded ``coeffs`` and a target
    kept fraction, returns the scalar magnitude threshold such that
    approximately ``keep_fraction`` of all coefficients (across every shard)
    exceed it.

    Uses the same fixed float-bit bins + selection rule as the host
    pipeline (:func:`abs_exponent_histogram` + selection identical to
    :func:`threshold_from_histogram`), so a shard_map compress step and the
    CLI pipeline produce the identical threshold for the same data
    (tests/test_global_threshold.py).  Inside ``shard_map``/``pmap`` pass
    ``axis_name`` to reduce over the mesh with ``lax.psum``;
    outside, the reductions are process-local.
    """
    hist = abs_exponent_histogram(coeffs)
    total = coeffs.size
    if axis_name is not None:
        total = total * jax.lax.axis_size(axis_name)
    # n_pad_coeffs: zero coefficients contributed by PADDING rows (a batch
    # padded to a mesh multiple) — counted out of both the histogram's
    # bin 0 and the total so the quantile matches the CLI host path,
    # which performs the same correction (engine.forward_hist_shapebatch)
    return threshold_from_histogram_device(hist, keep_fraction,
                                           total - int(n_pad_coeffs),
                                           axis_name=axis_name,
                                           pad_zeros=n_pad_coeffs)
