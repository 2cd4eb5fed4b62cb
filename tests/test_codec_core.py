"""Unit tests for the codec math: Haar, thresholding, RLE.

Tier-1 of the reference's test strategy (SURVEY.md §6): pure-function tests
against a scalar NumPy oracle that models the C++ semantics line-by-line,
plus the reference's own doctest cases transcribed (compressor.cpp:300-406).
"""

import numpy as np
import pytest

from wavelet_tpu.core import haar, oracle, rle, threshold, metrics

import jax
import jax.numpy as jnp


def rand_box(shape, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


SHAPES = [(4, 8, 16), (16, 32, 64), (8, 4, 2), (2, 2, 2), (1, 1, 4), (6, 10, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_haar_forward_matches_oracle_bitwise(shape):
    box = rand_box(shape, seed=hash(shape) % 2**31)
    want = oracle.haar_forward_oracle(box)
    got = np.asarray(haar.forward_flat(jnp.asarray(box)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_haar_inverse_matches_oracle_bitwise(shape):
    flat = rand_box((int(np.prod(shape)),), seed=7)
    want = oracle.haar_inverse_oracle(flat, *shape)
    got = np.asarray(haar.inverse_from_flat(jnp.asarray(flat), shape))
    np.testing.assert_array_equal(got, want)


def test_haar_roundtrip_reference_case():
    """Transcription of TEST_CASE("Wavelet decomposition") compressor.cpp:369-384."""
    box = np.full((4, 8, 16), 5.0, dtype=np.float32)
    box[1, 2, 3] = 8.5
    box[2, 5, 6] = 5.44
    box[1, 1, 1] = 3.3999932
    box[2, 2, 2] = 3.19229
    box[3, 5, 12] = 199.39029
    flat = haar.forward_flat(jnp.asarray(box))
    back = np.asarray(haar.inverse_from_flat(flat, (4, 8, 16)))
    np.testing.assert_allclose(back, box, atol=1e-6)


def test_haar_batched_matches_single():
    boxes = np.stack([rand_box((8, 8, 8), seed=i) for i in range(5)])
    batched = np.asarray(haar.haar3d_forward(jnp.asarray(boxes)))
    for i in range(5):
        single = np.asarray(haar.haar3d_forward(jnp.asarray(boxes[i])))
        np.testing.assert_array_equal(batched[i], single)


def test_haar_odd_dims_forward_keeps_tail_inverse_zeroes_it():
    """SURVEY.md §5.1: odd dims don't round-trip in the reference; we
    reproduce that exact behavior."""
    box = rand_box((3, 4, 4), seed=3)
    flat = np.asarray(haar.forward_flat(jnp.asarray(box)))
    want = oracle.haar_forward_oracle(box)
    np.testing.assert_array_equal(flat, want)
    back = np.asarray(haar.inverse_from_flat(jnp.asarray(flat), (3, 4, 4)))
    assert np.all(back[2, :, :] == 0.0)  # zeroed odd tail along X


def test_constant_box_low_block_only():
    """A constant box transforms (single scale) to a constant low-low-low
    block of X*Y*Z/8 coefficients and zeros elsewhere; thresholding at any
    keep < 1 keeps exactly that block, which is what makes the constant-data
    fixture round-trip byte-identically."""
    box = np.full((16, 32, 64), 3902.4, dtype=np.float32)
    coeffs = np.asarray(haar.haar3d_forward(jnp.asarray(box)))
    low = coeffs[:8, :16, :32]
    assert np.all(low == np.float32(3902.4))
    assert np.count_nonzero(coeffs) == 8 * 16 * 32
    back = np.asarray(haar.haar3d_inverse(jnp.asarray(
        np.where(np.abs(coeffs) > 3.9, coeffs, 0.0).astype(np.float32))))
    np.testing.assert_array_equal(back, box)


@pytest.mark.parametrize("keep", [0.99, 0.999, 0.9999])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_matches_oracle(keep, seed):
    flat = rand_box((4096,), seed=seed)
    mask_o, vals_o, max_o, _ = oracle.threshold_oracle(flat, keep)

    mx = np.asarray(threshold.signed_absmax(jnp.asarray(flat)))
    assert float(mx) == max_o
    t32 = threshold.exact_threshold32(np.asarray([mx]), keep)
    mask = np.asarray(
        threshold.mask_coefficients(jnp.asarray(flat)[None], jnp.asarray(t32)))[0]
    np.testing.assert_array_equal(mask, mask_o)


def test_threshold_negative_max_keeps_everything():
    """SURVEY.md §5.2 edge: negative max -> negative threshold -> keep all."""
    flat = np.array([-10.0, 0.0, 1.0, 0.0], dtype=np.float32)
    mask_o, _, max_o, thresh = oracle.threshold_oracle(flat, 0.999)
    assert max_o == -10.0 and thresh < 0
    assert mask_o.all()
    t32 = threshold.exact_threshold32(np.asarray([np.float32(-10.0)]), 0.999)
    mask = np.abs(flat) > t32[0]
    np.testing.assert_array_equal(mask, mask_o)


def test_threshold_tie_prefers_first():
    flat = np.array([3.0, -3.0, 1.0], dtype=np.float32)
    assert float(np.asarray(threshold.signed_absmax(jnp.asarray(flat)))) == 3.0
    flat2 = np.array([-3.0, 3.0, 1.0], dtype=np.float32)
    assert float(np.asarray(threshold.signed_absmax(jnp.asarray(flat2)))) == -3.0


def test_rle_reference_case():
    """Transcription of TEST_CASE("RLE Encode") compressor.cpp:300-339."""
    values = np.array([1.0, 2.0, 3.0, 4.0, 5.0], dtype=np.float32)
    mask = np.array([True, True, False, False, True])
    # the C++ test passes the compacted kept-values [1,2,3]; our encoder takes
    # the full source array, so place those at the mask positions
    full = np.array([1.0, 2.0, 0.0, 0.0, 3.0], dtype=np.float32)
    runs, vals = rle.rle_encode_mask(mask, full)
    np.testing.assert_array_equal(runs, [0, 0, 2])
    np.testing.assert_array_equal(vals, [1.0, 2.0, 3.0])

    all_true = np.ones(5, dtype=bool)
    runs, vals = rle.rle_encode_mask(all_true, values)
    np.testing.assert_array_equal(runs, [0] * 5)
    np.testing.assert_array_equal(vals, values)

    all_false = np.zeros(5, dtype=bool)
    runs, vals = rle.rle_encode_mask(all_false, values)
    assert len(runs) == 0 and len(vals) == 0


@pytest.mark.parametrize("seed", range(4))
def test_rle_roundtrip_random(seed):
    rng = np.random.default_rng(seed)
    n = 1000
    flat = (rng.standard_normal(n) * rng.integers(0, 2, n)).astype(np.float32)
    mask = flat != 0
    runs, vals = rle.rle_encode_mask(mask, flat)
    back = rle.rle_decode(runs, vals, n)
    np.testing.assert_array_equal(back, np.where(mask, flat, 0.0))


def test_rmse_reference_case():
    """Transcription of TEST_CASE("Calc RMSE") calc-loss.cpp:68-86."""
    a = np.zeros((2, 2, 2, 2), dtype=np.float32)
    b = np.full((2, 2, 2, 2), 3.5, dtype=np.float32)
    np.testing.assert_array_equal(metrics.rmse_per_box(a, b), [3.5, 3.5])


def test_global_histogram_threshold_quantile():
    rng = np.random.default_rng(0)
    mags = rng.uniform(0, 1, 1 << 16).astype(np.float32)
    thr = float(threshold.global_histogram_threshold(jnp.asarray(mags), 0.1))
    frac = np.mean(np.abs(mags) > thr)
    # fixed float-bit bins (8 exp + 3 mantissa bits) quantize at ~1/8
    # relative width: the selection keeps AT MOST the target fraction, and
    # is one-bin tight — keeping one more bin would overshoot the target
    assert frac <= 0.1 + 1e-12
    hist = np.asarray(
        threshold.abs_exponent_histogram(jnp.asarray(mags)), np.int64)
    above = np.cumsum(hist[::-1])[::-1]
    k = np.nonzero(above <= 0.1 * mags.size)[0][0]
    assert above[k - 1] > 0.1 * mags.size


def test_device_threshold_matches_host_threshold():
    """The in-jit selection (threshold_from_histogram_device) must agree
    bit-for-bit with the host pipeline's threshold_from_histogram — the
    unification contract that makes shard_map archives identical to CLI
    archives."""
    rng = np.random.default_rng(7)
    for kf in (0.5, 0.1, 0.02, 0.001):
        coeffs = rng.standard_normal(4096).astype(np.float32) * 100
        hist_dev = threshold.abs_exponent_histogram(jnp.asarray(coeffs))
        t_host = threshold.threshold_from_histogram(
            np.asarray(hist_dev, np.int64), kf)
        t_dev = threshold.threshold_from_histogram_device(
            hist_dev, kf, coeffs.size)
        assert np.float32(t_host).tobytes() == \
            np.asarray(t_dev, np.float32).tobytes()
    # degenerate inputs: constant (single populated bin) and all-zero
    for data in (np.full(512, 3.0, np.float32), np.zeros(512, np.float32)):
        hist_dev = threshold.abs_exponent_histogram(jnp.asarray(data))
        t_host = threshold.threshold_from_histogram(
            np.asarray(hist_dev, np.int64), 0.01)
        t_dev = threshold.threshold_from_histogram_device(
            hist_dev, 0.01, data.size)
        assert np.float32(t_host).tobytes() == \
            np.asarray(t_dev, np.float32).tobytes()


def test_device_rmse_matches_host():
    from wavelet_tpu.runtime import engine as eng_mod

    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 8, 16, 32)).astype(np.float32)
    b = (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
    eng = eng_mod.CodecEngine()
    got = eng.rmse_batch(a, b)
    want = metrics.rmse_per_box(a, b)  # (treats axis 0 as components)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_estimate_device_metrics_flag(tmp_path):
    from conftest import FIXTURES
    from wavelet_tpu.pipeline import Config, estimate_run

    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
                 min_level=0, max_level=0, components=["temp"], keep=0.999,
                 device_metrics=True)
    r = estimate_run(cfg)
    assert r["components"]["temp"]["rmse"] == 0.0
