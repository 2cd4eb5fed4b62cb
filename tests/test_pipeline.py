"""End-to-end pipeline tests (tier-3, SURVEY.md §6): full compress ->
decompress round trips on the golden fixtures, estimate-mode metrics, and
CLI contract."""

import filecmp
import os

import numpy as np
import pytest

from conftest import FIXTURES, fixture
from wavelet_tpu import cli
from wavelet_tpu.io import archive
from wavelet_tpu.pipeline import (Config, common, compress_run,
                                  decompress_run, estimate_run)

PLT74 = fixture("plt00074")


def _dirs_identical(p1, p2):
    for root, _dirs, names in os.walk(p1):
        rel = os.path.relpath(root, p1)
        for n in names:
            a = os.path.join(root, n)
            b = os.path.join(p2, rel, n)
            if not os.path.exists(b) or not filecmp.cmp(a, b, shallow=False):
                return False, os.path.join(rel, n)
    return True, None


def test_compress_decompress_byte_identical_roundtrip(tmp_path):
    """BASELINE.json config 2: plt00074->plt00075, levels 0-1, full round
    trip.  The fixtures hold constant boxes, which survive thresholding
    exactly, so regenerated plotfiles must be byte-identical."""
    comp_dir = str(tmp_path / "compressed") + os.sep
    out_dir = str(tmp_path / "regen") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp_dir)
    stats = compress_run(cfg)
    assert stats["files"] == 2 * 2 * 2 * 2  # t x lev x comp x box

    # sidecars present
    for name in ["runinfo.raw", "locations.raw", "dimensions.raw",
                 "boxcounts.raw", "amrexinfo.raw"]:
        assert os.path.exists(os.path.join(comp_dir, name))
    # file naming contract: header component indices in names
    assert os.path.exists(os.path.join(
        comp_dir, "compressed-wavelet-0-0-0-0.xz"))
    assert os.path.exists(os.path.join(
        comp_dir, "compressed-wavelet-1-1-1-1.xz"))

    dcfg = Config(compressed_dir=comp_dir, out_dir=out_dir)
    decompress_run(dcfg)

    for plt in ["plt00074", "plt00075"]:
        same, diff = _dirs_identical(fixture(plt), os.path.join(out_dir, plt))
        assert same, f"{plt}/{diff} differs after round trip"


def test_runinfo_matches_reference_layout(tmp_path):
    comp_dir = str(tmp_path) + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
                 min_level=0, max_level=0, components=["pressure"],
                 keep=0.999, compressed_dir=comp_dir)
    compress_run(cfg)
    info = archive.read_runinfo(comp_dir)
    assert info.components == ["pressure"]
    assert info.comp_idxs == [1]      # header index of 'pressure'
    assert info.min_level == 0 and info.max_level == 0
    assert [os.path.basename(f) for f in info.files] == ["plt00074"]
    counts = archive.read_boxcounts(comp_dir, 1, 1)
    assert counts == [[2]]


def test_estimate_mode_fixture_metrics(tmp_path):
    """BASELINE.json config 1: plt00074, level 0, keep=0.999, -estimate.

    Constant boxes reconstruct exactly -> RMSE and adjusted loss are 0."""
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
                 min_level=0, max_level=0, components=["temp", "pressure"],
                 keep=0.999)
    result = estimate_run(cfg)
    for name in ["temp", "pressure"]:
        assert result["components"][name]["rmse"] == 0.0
        assert result["components"][name]["adjusted_loss"] == 0.0
    assert 0.0 < result["compressed_size_pct"] < 5.0


def test_lossy_roundtrip_quality_on_synthetic_data(tmp_path):
    """Non-constant data: verify the estimator reports sane lossy metrics and
    that lower keep -> more loss, less size."""
    from wavelet_tpu.io import plotfile as pf

    # synthesize a 2-component plotfile with smooth + noisy fields
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(np.linspace(0, 4, 32), np.linspace(0, 3, 16),
                          np.linspace(0, 2, 8), indexing="ij")
    smooth = (np.sin(x) * np.cos(y) + z).astype(np.float32)
    noisy = (smooth + 0.1 * rng.standard_normal(smooth.shape)).astype(np.float32)
    boxes = [np.stack([smooth, noisy])]
    src = tmp_path / "data" / "plt00010"
    pf.write_plotfile(str(src), [boxes], [[(0, 0, 0)]], [[(32, 16, 8)]],
                      ["a", "b"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (32, 16, 8), [10])

    losses, sizes = [], []
    for keep in (0.99, 0.9999):
        cfg = Config(data_dir=str(tmp_path / "data"), min_time="plt00010",
                     max_time="plt00010", min_level=0, max_level=0,
                     components=["a", "b"], keep=keep)
        r = estimate_run(cfg)
        losses.append(r["components"]["b"]["rmse"])
        sizes.append(r["compressed_size_pct"])
    assert losses[1] < losses[0]       # higher keep -> lower loss
    assert sizes[1] > sizes[0]         # higher keep -> bigger archive
    assert losses[1] < 0.05            # keep=0.9999 is near-lossless here


def test_cli_parse_reference_grammar():
    mode, cfg = cli.parse_argv([
        'datadir=/data', 'minfile=plt07400', 'maxfile=plt07900',
        'minlevel=0', 'maxlevel=3',
        'components=density Temp pressure x_velocity', 'keep=0.999',
        'compresseddir=/out', '-c'])
    assert mode == "c"
    assert cfg.components == ["density", "Temp", "pressure", "x_velocity"]
    assert cfg.keep == 0.999
    mode, cfg = cli.parse_argv(['compresseddir=/in', 'out=/regen', '-d'])
    assert mode == "d" and cfg.out_dir == "/regen"
    with pytest.raises(SystemExit):
        cli.parse_argv(['datadir=/data', '-c'])
    with pytest.raises(SystemExit):
        cli.parse_argv(['datadir=/data'])
    mode, cfg = cli.parse_argv(['compresseddir=/in', 'out=/r',
                                'outprec=f32', '-d'])
    assert cfg.out_precision == "f32"
    with pytest.raises(SystemExit):
        cli.parse_argv(['compresseddir=/in', 'out=/r', 'outprec=f16', '-d'])
    # giantbox: positive byte count, both modes; auto transfer accepted
    _m, cfg = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'maxfile=a1', 'minlevel=0',
        'maxlevel=0', 'components=f', 'keep=0.9', 'compresseddir=/o',
        'giantbox=1048576', 'transfer=auto', '-c'])
    assert cfg.giant_box_bytes == 1048576 and cfg.transfer == "auto"
    _m, cfg = cli.parse_argv(['compresseddir=/in', 'out=/r',
                              'giantbox=2048', '-d'])
    assert cfg.giant_box_bytes == 2048
    with pytest.raises(SystemExit):
        cli.parse_argv(['compresseddir=/in', 'out=/r', 'giantbox=0', '-d'])
    with pytest.raises(SystemExit):
        cli.parse_argv(['compresseddir=/in', 'out=/r', 'transfer=sparce',
                        '-d'])


def test_clean_string_reference_case():
    """argparse.cpp:181-187 transcription."""
    assert common.clean_string("plt07400") == 7400
    assert common.clean_string("fff9909") == 9909
    assert common.clean_string("doctest.h") == -1


def test_resume_skips_existing_outputs(tmp_path):
    comp_dir = str(tmp_path) + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
                 min_level=0, max_level=0, components=["temp"], keep=0.999,
                 compressed_dir=comp_dir, resume=True)
    s1 = compress_run(cfg)
    assert s1["files"] == 2 and s1["skipped"] == 0
    s2 = compress_run(cfg)
    assert s2["files"] == 0 and s2["skipped"] == 2


def test_cli_main_end_to_end(tmp_path, monkeypatch):
    """Drive the real CLI entrypoint (both modes) including the profile key."""
    comp = str(tmp_path / "c") + os.sep
    out = str(tmp_path / "o") + os.sep
    trace = str(tmp_path / "trace")
    rc = cli.main([f"datadir={FIXTURES}", "minfile=plt00074",
                   "maxfile=plt00074", "minlevel=0", "maxlevel=0",
                   "components=temp", "keep=0.999",
                   f"compresseddir={comp}", f"profile={trace}", "-c"])
    assert rc == 0
    rc = cli.main([f"compresseddir={comp}", f"out={out}", "-d"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "plt00074", "Header"))
    assert os.path.isdir(trace)  # profiler wrote something


def test_cli_main_keep_sweep_and_partial_retrieval(tmp_path):
    """CLI e2e for the two retrieval/estimate extensions: a keep sweep
    through -estimate (fast path) and a filtered -d."""
    rc = cli.main([f"datadir={FIXTURES}", "minfile=plt00074", "minlevel=0",
                   "components=temp pressure", "keep=0.99 0.999",
                   "fastestimate=1", "-estimate"])
    assert rc == 0
    comp = str(tmp_path / "c") + os.sep
    out = str(tmp_path / "o") + os.sep
    rc = cli.main([f"datadir={FIXTURES}", "minfile=plt00074",
                   "maxfile=plt00075", "minlevel=0", "maxlevel=1",
                   "components=temp pressure", "keep=0.999",
                   f"compresseddir={comp}", "-c"])
    assert rc == 0
    rc = cli.main([f"compresseddir={comp}", f"out={out}",
                   "minfile=plt00075", "components=temp", "maxlevel=0",
                   "-d"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["plt00075"]
    assert not os.path.isdir(os.path.join(out, "plt00075", "Level_1"))


def test_cli_clean_error_for_unknown_component(tmp_path, caplog):
    rc = cli.main([f"datadir={FIXTURES}", "minfile=plt00074",
                   "maxfile=plt00074", "minlevel=0", "maxlevel=0",
                   "components=ghost", "keep=0.999",
                   f"compresseddir={tmp_path}/", "-c"])
    assert rc == 1  # clean exit, no traceback
