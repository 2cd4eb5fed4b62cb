"""Preview (low-band) decompression: ``-d preview=p`` regenerates plotfiles
at 1/2**p resolution per axis from the wavelet low band.

Extension — the reference can only regenerate full resolution (its inverse
unconditionally reconstructs every band, decompressor.cpp:79-159).  The Haar
low coefficient is the pairwise mean (compressor.cpp:107-119), so the
preview at depth p is the 2**p-cube block mean of the (reconstructed) data —
that is the oracle these tests pin against.
"""

import os

import numpy as np
import pytest

from conftest import FIXTURES, fixture
from wavelet_tpu import cli
from wavelet_tpu.io import plotfile as pf
from wavelet_tpu.pipeline import Config, compress_run, decompress_run

PLT74 = fixture("plt00074")

def lowpass_np(a, depth):
    """NumPy oracle of haar.haar3d_lowpass on one (X, Y, Z) box: pairwise
    means along Z, Y, X per scale, float32 rounding per combine (the exact
    arithmetic the forward's low band stores)."""
    a = np.asarray(a, np.float32)
    for _ in range(depth):
        a = ((a[..., 0::2] + a[..., 1::2]) * np.float32(0.5)).astype(np.float32)
        a = ((a[:, 0::2, :] + a[:, 1::2, :]) * np.float32(0.5)).astype(np.float32)
        a = ((a[0::2] + a[1::2]) * np.float32(0.5)).astype(np.float32)
    return a


def _write_synthetic(tmp_path, n_boxes=3, shape=(16, 8, 8), n_times=1):
    rng = np.random.default_rng(11)
    data_dir = tmp_path / "data"
    x, _y, _z = shape
    for t in range(n_times):
        boxes, locs, dims = [], [], []
        for b in range(n_boxes):
            smooth = np.fromfunction(
                lambda i, j, k: np.sin(0.2 * (i + b)) * np.cos(0.3 * j) + 0.1 * k,
                shape).astype(np.float32)
            noisy = (smooth + 0.03 * rng.standard_normal(shape)
                     ).astype(np.float32)
            boxes.append(np.stack([smooth, noisy]))
            locs.append((b * x, 0, 0))
            dims.append(shape)
        pf.write_plotfile(str(data_dir / f"plt{20 + t:05d}"), [boxes], [locs],
                          [dims], ["a", "b"], 0.25 + t, [0., 0., 0.],
                          [1., 1., 1.], (2, 2, 2), (n_boxes * x,) + shape[1:],
                          [20 + t])
    return str(data_dir)


def _compress(data_dir, comp_dir, n_times=1, **kw):
    cfg = Config(data_dir=data_dir, min_time="plt00020",
                 max_time=f"plt{20 + n_times - 1:05d}", min_level=0,
                 max_level=0, components=["a", "b"], keep=0.999,
                 compressed_dir=comp_dir, **kw)
    compress_run(cfg)
    return cfg


def test_preview_equals_blockmean_of_full_output(tmp_path):
    """preview=p must equal the depth-p lowpass of the FULL regenerated
    output (not of the original — thresholding is lossy; the low band of
    what the archive reconstructs is the contract)."""
    data_dir = _write_synthetic(tmp_path)
    comp = str(tmp_path / "comp") + os.sep
    _compress(data_dir, comp)
    full = str(tmp_path / "full") + os.sep
    prev = str(tmp_path / "prev") + os.sep
    decompress_run(Config(compressed_dir=comp, out_dir=full))
    decompress_run(Config(compressed_dir=comp, out_dir=prev, preview=1))

    lv_full = pf.read_level(os.path.join(full, "plt00020"), 0, [0, 1])
    lv_prev = pf.read_level(os.path.join(prev, "plt00020"), 0, [0, 1])
    assert len(lv_prev.boxes) == len(lv_full.boxes)
    for fb, pb in zip(lv_full.boxes, lv_prev.boxes):
        assert pb.shape == (2, 8, 4, 4)
        for c in range(2):
            np.testing.assert_allclose(pb[c], lowpass_np(fb[c], 1),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scales,depth", [(1, 1), (2, 1), (2, 2), (1, 2)])
def test_preview_depths_and_scales(tmp_path, scales, depth):
    """Every (archive scales, preview depth) relation: depth == scales is a
    pure corner slice, depth < scales inverts the remaining pyramid,
    depth > scales reconstructs and re-lowpasses on device — all must give
    the block mean of the full output."""
    data_dir = _write_synthetic(tmp_path)
    comp = str(tmp_path / "comp") + os.sep
    _compress(data_dir, comp, scales=scales)
    full = str(tmp_path / "full") + os.sep
    prev = str(tmp_path / "prev") + os.sep
    decompress_run(Config(compressed_dir=comp, out_dir=full))
    decompress_run(Config(compressed_dir=comp, out_dir=prev, preview=depth))

    lv_full = pf.read_level(os.path.join(full, "plt00020"), 0, [0, 1])
    lv_prev = pf.read_level(os.path.join(prev, "plt00020"), 0, [0, 1])
    for fb, pb in zip(lv_full.boxes, lv_prev.boxes):
        assert pb.shape[1:] == tuple(d >> depth for d in fb.shape[1:])
        for c in range(2):
            np.testing.assert_allclose(pb[c], lowpass_np(fb[c], depth),
                                       rtol=1e-5, atol=1e-6)


def test_preview_plotfile_geometry(tmp_path):
    """The preview plotfile is a valid plotfile: halved index space on the
    SAME physical domain (cells 2x larger), same time/steps/ref ratios."""
    data_dir = _write_synthetic(tmp_path)
    comp = str(tmp_path / "comp") + os.sep
    prev = str(tmp_path / "prev") + os.sep
    _compress(data_dir, comp)
    decompress_run(Config(compressed_dir=comp, out_dir=prev, preview=1))

    h_orig = pf.read_header(os.path.join(data_dir, "plt00020"))
    h_prev = pf.read_header(os.path.join(prev, "plt00020"))
    assert h_prev.prob_lo == h_orig.prob_lo
    assert h_prev.prob_hi == h_orig.prob_hi
    assert h_prev.time == h_orig.time
    assert h_prev.component_names == h_orig.component_names
    locs, dims = pf.read_level_meta(os.path.join(prev, "plt00020"), 0)
    locs0, dims0 = pf.read_level_meta(os.path.join(data_dir, "plt00020"), 0)
    assert locs == [tuple(v >> 1 for v in l) for l in locs0]
    assert dims == [tuple(v >> 1 for v in d) for d in dims0]


def test_preview_cli_on_fixture(tmp_path):
    """CLI end-to-end on the golden fixture (mixed 16x32x64 and 8x4x2
    boxes): preview=1 works; preview=2 is a clean error (the 8x4x2 box's
    z=2 is not divisible by 4); preview+sparse is rejected at parse."""
    comp = str(tmp_path / "comp") + os.sep
    out1 = str(tmp_path / "out1") + os.sep
    assert cli.main(["datadir=" + FIXTURES, "minfile=plt00074",
                     "maxfile=plt00074", "minlevel=0", "maxlevel=1",
                     "components=temp pressure", "keep=0.999",
                     "compresseddir=" + comp, "-c"]) == 0
    assert cli.main(["compresseddir=" + comp, "out=" + out1,
                     "preview=1", "-d"]) == 0
    lv = pf.read_level(os.path.join(out1, "plt00074"), 0, [0, 1])
    orig = pf.read_level(fixture("plt00074"), 0, [0, 1])
    for ob, pb in zip(orig.boxes, lv.boxes):
        for c in range(2):
            # fixture boxes are constant per component -> block means are
            # exact regardless of thresholding
            np.testing.assert_array_equal(pb[c], lowpass_np(ob[c], 1))

    assert cli.main(["compresseddir=" + comp,
                     "out=" + str(tmp_path / "out2") + os.sep,
                     "preview=2", "-d"]) == 1   # clean error, no traceback
    with pytest.raises(SystemExit):
        cli.parse_argv(["compresseddir=" + comp, "out=x", "preview=1",
                        "transfer=sparse", "-d"])


def test_preview_composes_with_partial_retrieval(tmp_path):
    data_dir = _write_synthetic(tmp_path, n_times=2)
    comp = str(tmp_path / "comp") + os.sep
    _compress(data_dir, comp, n_times=2)
    prev = str(tmp_path / "prev") + os.sep
    decompress_run(Config(compressed_dir=comp, out_dir=prev, preview=1,
                          min_time="plt00021", components=["b"]))
    assert sorted(os.listdir(prev)) == ["plt00021"]
    h = pf.read_header(os.path.join(prev, "plt00021"))
    assert h.component_names == ["b"]
    lv = pf.read_level(os.path.join(prev, "plt00021"), 0, [0])
    assert lv.boxes[0].shape == (1, 8, 4, 4)


@pytest.mark.parametrize("flavor", [
    {"archive": "bundle"}, {"payload": "q16"}, {"codec": "raw"}])
def test_preview_archive_flavors(tmp_path, flavor):
    """Preview reads through the same unpack machinery as full decompress:
    bundles, q16 payloads and raw codec archives all preview identically
    to the default-flavor preview."""
    data_dir = _write_synthetic(tmp_path)
    base = str(tmp_path / "comp0") + os.sep
    flav = str(tmp_path / "comp1") + os.sep
    _compress(data_dir, base)
    _compress(data_dir, flav, **flavor)
    out0 = str(tmp_path / "out0") + os.sep
    out1 = str(tmp_path / "out1") + os.sep
    decompress_run(Config(compressed_dir=base, out_dir=out0, preview=1))
    decompress_run(Config(compressed_dir=flav, out_dir=out1, preview=1))
    a = pf.read_level(os.path.join(out0, "plt00020"), 0, [0, 1])
    b = pf.read_level(os.path.join(out1, "plt00020"), 0, [0, 1])
    for ab, bb in zip(a.boxes, b.boxes):
        if flavor.get("payload") == "q16":
            np.testing.assert_allclose(bb, ab, rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_array_equal(bb, ab)
