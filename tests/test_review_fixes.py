"""Regression tests for the round-1 code-review findings."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from wavelet_tpu.core import rle, threshold
from wavelet_tpu.io import plotfile as pf
from wavelet_tpu.pipeline import Config, compress_run, decompress_run


def test_quantile_never_zeroes_low_entropy_fields():
    """A constant box concentrates all coefficients in one magnitude bin;
    the quantile must overshoot the target rather than keep nothing."""
    box = np.full((8, 8, 8), 5.0, np.float32)
    from wavelet_tpu.core import haar

    coeffs = np.asarray(haar.forward_flat(jnp.asarray(box)))
    hist = np.asarray(threshold.abs_exponent_histogram(jnp.asarray(coeffs)),
                      np.int64)
    t = threshold.threshold_from_histogram(hist, 0.05)
    kept = np.sum(np.abs(coeffs) > t)
    assert kept == 64  # the whole DC bin survives, not zero


def test_block_rows_odd_x_single_row():
    """Odd extents on any axis: the forward leaves each odd line's last
    element untouched, bitwise as the oracle does."""
    from wavelet_tpu.core import haar, oracle

    rng = np.random.default_rng(1)
    for dims in ((5, 8, 16), (16, 17, 8), (3, 5, 7), (1, 4, 4)):
        box = (rng.standard_normal(dims) * 10).astype(np.float32)
        got = np.asarray(haar.forward_flat(jnp.asarray(box)))
        np.testing.assert_array_equal(
            got.view(np.int32), oracle.haar_forward_oracle(box).view(np.int32))


def test_packed_kernel_odd_x_interpret():
    """Odd-X boxes through the engine's compress step match the oracle
    bitwise (odd tail untouched by the forward)."""
    from wavelet_tpu.core import oracle
    from wavelet_tpu.runtime import engine

    rng = np.random.default_rng(0)
    boxes = (rng.standard_normal((4, 5, 8, 32)) * 10).astype(np.float32)
    flat, _t32 = engine.CodecEngine().compress_batch_raw(boxes, 0.999)
    for i in range(4):
        want = oracle.haar_forward_oracle(boxes[i])
        np.testing.assert_array_equal(flat[i].view(np.int32),
                                      want.view(np.int32))


def test_rle_decode_rejects_negative_positions():
    runs = np.array([-5, 0], np.int32)   # corrupt payload
    vals = np.array([1.0, 2.0], np.float32)
    out = rle.rle_decode(runs, vals, 8)
    # nothing scattered to out[-5]; second value lands at cumulative pos
    assert out[3] == 0.0  # would have been vals[0] via wraparound before
    assert not np.any(out == 1.0)


def test_empty_level_writes_valid_plotfile(tmp_path):
    out = tmp_path / "plt"
    box = np.ones((1, 4, 4, 4), np.float32)
    pf.write_plotfile(str(out), [[box], []], [[(0, 0, 0)], []],
                      [[(4, 4, 4)], []], ["u"], 0.1, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (4, 4, 4), [1, 2])
    lv1 = pf.read_level(str(out), 1, [0])
    assert lv1.boxes == []


def test_atomic_writes_no_tmp_leftovers(tmp_path):
    src = tmp_path / "data" / "plt00070"
    box = np.ones((1, 4, 4, 4), np.float32)
    pf.write_plotfile(str(src), [[box]], [[(0, 0, 0)]], [[(4, 4, 4)]],
                      ["u"], 0.1, [0., 0., 0.], [1., 1., 1.], (2, 2, 2),
                      (4, 4, 4), [70])
    comp = str(tmp_path / "c") + "/"
    compress_run(Config(data_dir=str(tmp_path / "data"), min_time="plt00070",
                        max_time="plt00070", min_level=0, max_level=0,
                        components=["u"], keep=0.999, compressed_dir=comp))
    assert not [f for f in os.listdir(comp) if f.endswith(".tmp")]


def test_component_order_independence(tmp_path):
    """Listing components out of Header order must not mislabel outputs."""
    a = np.full((4, 4, 4), 1.0, np.float32)
    b = np.full((4, 4, 4), 2.0, np.float32)
    src = tmp_path / "data" / "plt00080"
    pf.write_plotfile(str(src), [[np.stack([a, b])]], [[(0, 0, 0)]],
                      [[(4, 4, 4)]], ["alpha", "beta"], 0.1, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (4, 4, 4), [80])
    comp = str(tmp_path / "c") + "/"
    out = str(tmp_path / "o") + "/"
    # user lists beta before alpha
    compress_run(Config(data_dir=str(tmp_path / "data"), min_time="plt00080",
                        max_time="plt00080", min_level=0, max_level=0,
                        components=["beta", "alpha"], keep=0.999,
                        compressed_dir=comp))
    from wavelet_tpu.io import archive
    info = archive.read_runinfo(comp)
    assert info.components == ["alpha", "beta"]   # header order
    assert info.comp_idxs == [0, 1]
    decompress_run(Config(compressed_dir=comp, out_dir=out))
    regen = pf.read_level(out + "plt00080", 0, [0, 1])
    h = pf.read_header(out + "plt00080")
    assert h.component_names == ["alpha", "beta"]
    np.testing.assert_array_equal(regen.boxes[0][0], a)   # alpha data = 1.0
    np.testing.assert_array_equal(regen.boxes[0][1], b)


def test_global_resume_uses_full_histogram(tmp_path):
    """Resumed global-mode runs must derive the same threshold as the
    original (histogram over all items), only skipping the pack."""
    rng = np.random.default_rng(1)
    boxes = [np.stack([(rng.standard_normal((8, 8, 8)) * (i + 1))
                       .astype(np.float32)]) for i in range(4)]
    src = tmp_path / "data" / "plt00090"
    pf.write_plotfile(str(src), [boxes],
                      [[(i * 8, 0, 0) for i in range(4)]],
                      [[(8, 8, 8)] * 4], ["u"], 0.1, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (32, 8, 8), [90])
    comp = str(tmp_path / "c") + "/"
    cfg = Config(data_dir=str(tmp_path / "data"), min_time="plt00090",
                 max_time="plt00090", min_level=0, max_level=0,
                 components=["u"], threshold_mode="global",
                 keep_fraction=0.1, compressed_dir=comp, resume=True)
    s1 = compress_run(cfg)
    # delete one output and resume: threshold must be identical and only
    # the missing file repacked
    os.remove(comp + "compressed-wavelet-0-0-0-2.xz")
    s2 = compress_run(cfg)
    assert s2["global_threshold"] == s1["global_threshold"]
    assert s2["files"] == 1 and s2["skipped"] == 3
    assert os.path.exists(comp + "compressed-wavelet-0-0-0-2.xz")


def test_write_prep_threads_env_parsing(monkeypatch):
    """Round-5 review: WAVELET_TPU_WRITE_THREADS='0' must mean the native
    default (per the docstring), not a 1-thread pin, and a non-integer
    must fail with a descriptive error instead of a bare ValueError from
    int() mid-write."""
    import pytest

    from wavelet_tpu.io.plotfile import _write_prep_threads

    monkeypatch.delenv("WAVELET_TPU_WRITE_THREADS", raising=False)
    assert _write_prep_threads() == 0        # unset -> native default
    monkeypatch.setenv("WAVELET_TPU_WRITE_THREADS", "0")
    assert _write_prep_threads() == 0        # explicit native default
    monkeypatch.setenv("WAVELET_TPU_WRITE_THREADS", "3")
    assert _write_prep_threads() == 3
    monkeypatch.setenv("WAVELET_TPU_WRITE_THREADS", "-2")
    assert _write_prep_threads() == 0        # clamped, not crashed
    monkeypatch.setenv("WAVELET_TPU_WRITE_THREADS", "auto")
    with pytest.raises(ValueError, match="WAVELET_TPU_WRITE_THREADS"):
        _write_prep_threads()
