"""The programmatic API (wavelet_tpu.api) drives the same pipelines as the
CLI: compress -> decompress regenerates the golden fixtures byte-identically,
estimate/check/info return their stats dicts, bad options fail fast."""

import filecmp
import os

import pytest

import wavelet_tpu
from conftest import fixture

PLT74 = fixture("plt00074")
PLT75 = fixture("plt00075")

DATADIR = os.path.dirname(PLT74)


def _compare_tree(golden, ours):
    for root, _dirs, names in os.walk(golden):
        rel = os.path.relpath(root, golden)
        for n in names:
            a, b = os.path.join(root, n), os.path.join(ours, rel, n)
            assert filecmp.cmp(a, b, shallow=False), f"{rel}/{n} differs"


def test_api_compress_decompress_byte_identical(tmp_path):
    stats = wavelet_tpu.compress(
        DATADIR, str(tmp_path / "comp"), min_time="plt00074",
        max_time="plt00075", min_level=0, max_level=1,
        components=["temp", "pressure"], keep=0.999)
    assert isinstance(stats, dict)
    out = tmp_path / "out"
    wavelet_tpu.decompress(str(tmp_path / "comp"), str(out))
    _compare_tree(PLT74, str(out / "plt00074"))
    _compare_tree(PLT75, str(out / "plt00075"))


def test_api_decompress_partial_and_preview(tmp_path):
    wavelet_tpu.compress(
        DATADIR, str(tmp_path / "comp"), min_time="plt00074",
        max_time="plt00075", min_level=0, max_level=1,
        components=["temp", "pressure"], keep=0.999)
    wavelet_tpu.decompress(str(tmp_path / "comp"), str(tmp_path / "part"),
                           min_time="plt00075", max_time="plt00075",
                           components=["temp"], levels_upto=0)
    assert os.path.isdir(tmp_path / "part" / "plt00075")
    assert not os.path.isdir(tmp_path / "part" / "plt00074")
    wavelet_tpu.decompress(str(tmp_path / "comp"), str(tmp_path / "prev"),
                           preview=1)
    assert os.path.isdir(tmp_path / "prev" / "plt00074")


def test_api_estimate_check_info(tmp_path):
    est = wavelet_tpu.estimate(DATADIR, min_time="plt00074",
                               components=["temp", "pressure"], keep=0.999)
    assert est["compressed_size_pct"] < 1.0
    assert set(est["components"]) == {"temp", "pressure"}

    wavelet_tpu.compress(
        DATADIR, str(tmp_path / "comp"), min_time="plt00074",
        max_time="plt00074", min_level=0, max_level=0,
        components=["temp", "pressure"], keep=0.999)
    chk = wavelet_tpu.check(str(tmp_path / "comp"))
    assert chk["errors"] == []
    inf = wavelet_tpu.info(str(tmp_path / "comp"))
    assert inf["missing"] == 0 and inf["payload_bytes"] > 0


def test_api_unknown_option_raises():
    with pytest.raises(TypeError, match="unknown option"):
        wavelet_tpu.compress("d", "c", min_time="a", max_time="b",
                             components=["x"], not_a_knob=1)


def test_api_lazy_exports():
    assert "compress" in dir(wavelet_tpu)
    assert wavelet_tpu.Config().keep == 0.999
    with pytest.raises(AttributeError):
        wavelet_tpu.no_such_attribute


def test_api_decompress_f32_output(tmp_path):
    wavelet_tpu.compress(
        DATADIR, str(tmp_path / "comp"), min_time="plt00074",
        max_time="plt00074", min_level=0, max_level=1,
        components=["temp", "pressure"], keep=0.999)
    wavelet_tpu.decompress(str(tmp_path / "comp"), str(tmp_path / "o64"))
    wavelet_tpu.decompress(str(tmp_path / "comp"), str(tmp_path / "o32"),
                           out_precision="f32")
    from wavelet_tpu.io import plotfile as pf
    for lvl in range(2):
        a = pf.read_level(str(tmp_path / "o64" / "plt00074"), lvl, [0, 1])
        b = pf.read_level(str(tmp_path / "o32" / "plt00074"), lvl, [0, 1])
        for x, y in zip(a.boxes, b.boxes):
            assert (x == y).all()
    big = os.path.getsize(tmp_path / "o64/plt00074/Level_0/Cell_D_00000")
    small = os.path.getsize(tmp_path / "o32/plt00074/Level_0/Cell_D_00000")
    assert small < 0.6 * big
