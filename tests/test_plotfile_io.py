"""Golden-file tests for the pure-Python plotfile reader/writer.

Mirrors the reference's own integration tests: ``TEST_CASE("Preprocessing")``
(preprocess.cpp:311-377) asserts exact box contents/locations/dims/extrema,
and ``TEST_CASE("Writing plotfiles")`` (writeplotfile.cpp:322-404) demands the
regenerated plotfile be byte-identical to the checked-in fixture.
"""

import filecmp
import os

import numpy as np
import pytest

from conftest import fixture
from wavelet_tpu.io import plotfile as pf

PLT74 = fixture("plt00074")
PLT75 = fixture("plt00075")


def test_read_header():
    h = pf.read_header(PLT74)
    assert h.magic == "HyperCLaw-V1.1"
    assert h.n_comp == 2
    assert h.component_names == ["temp", "pressure"]
    assert h.spacedim == 3
    assert abs(h.time - 0.2219392) < 1e-12
    assert h.finest_level == 1
    assert h.prob_lo == [0.6, 0.5, 0.4]
    assert h.prob_hi == [0.8, 0.9, 1.0]
    assert h.ref_ratio == [2]
    assert h.domain_dims(0) == (256, 512, 256)
    assert h.domain_dims(1) == (512, 1024, 512)
    assert h.level_steps == [1200, 1500]
    assert h.component_indices(["temp", "pressure"]) == [0, 1]


def test_read_level_matches_reference_expectations():
    # expectations transcribed from preprocess.cpp:327-373
    h = pf.read_header(PLT74)
    lv0_74 = pf.read_level(PLT74, 0, [0, 1])
    lv1_74 = pf.read_level(PLT74, 1, [0, 1])
    lv0_75 = pf.read_level(PLT75, 0, [0, 1])

    # boxes[t=0][lev=1][box=0][comp=0] == constant 3902.4 box of dims 16x32x64
    b = lv1_74.boxes[0]
    assert b.shape == (2, 16, 32, 64)
    assert np.all(b[0] == np.float32(3902.4))
    # boxes[t=1][lev=0][box=1][comp=1] == constant 16.0 box of dims 8x4x2
    b2 = lv0_75.boxes[1]
    assert b2.shape == (2, 8, 4, 2)
    assert np.all(b2[1] == np.float32(16.0))

    assert lv0_74.locations == [(0, 0, 0), (16, 32, 64)]
    assert lv0_74.dimensions == [(16, 32, 64), (8, 4, 2)]
    assert lv1_74.dimensions == [(16, 32, 64), (8, 4, 2)]

    # per-component extrema over both boxes (preprocess.cpp:348-352)
    np.testing.assert_array_equal(lv0_74.min_values, [np.float32(16.0)] * 2)
    np.testing.assert_array_equal(lv0_74.max_values, [np.float32(3902.4)] * 2)


def test_write_plotfile_byte_identical(tmp_path):
    """Regenerate plt00074 and plt00075 from parsed data; require byte equality.

    Same bar as writeplotfile.cpp:400 (`directories_are_identical`).
    """
    for src in (PLT74, PLT75):
        h = pf.read_header(src)
        levels = [pf.read_level(src, l, [0, 1]) for l in range(h.n_levels)]
        out = tmp_path / os.path.basename(src)
        pf.write_plotfile(
            str(out),
            [lv.boxes for lv in levels],
            [lv.locations for lv in levels],
            [lv.dimensions for lv in levels],
            h.component_names,
            h.time,
            h.prob_lo, h.prob_hi,
            (h.ref_ratio[0],) * 3 if h.ref_ratio else (2, 2, 2),
            h.domain_dims(0),
            h.level_steps,
        )
        for rel in ["Header", "Level_0/Cell_H", "Level_0/Cell_D_00000",
                    "Level_1/Cell_H", "Level_1/Cell_D_00000"]:
            golden = os.path.join(src, rel)
            ours = os.path.join(str(out), rel)
            assert os.path.exists(ours), f"missing {rel}"
            if not filecmp.cmp(golden, ours, shallow=False):
                gb = open(golden, "rb").read()
                ob = open(ours, "rb").read()
                i = next((k for k, (a, b) in enumerate(zip(gb, ob)) if a != b),
                         min(len(gb), len(ob)))
                raise AssertionError(
                    f"{rel} differs at byte {i}: golden[{i}:{i+60}]="
                    f"{gb[i:i+60]!r} ours={ob[i:i+60]!r} "
                    f"(sizes {len(gb)} vs {len(ob)})")


def test_read_write_read_roundtrip(tmp_path):
    """Data survives write->read unchanged (independent of byte identity)."""
    levels = [pf.read_level(PLT74, l, [0, 1]) for l in range(2)]
    out = tmp_path / "plt"
    h = pf.read_header(PLT74)
    pf.write_plotfile(str(out), [lv.boxes for lv in levels],
                      [lv.locations for lv in levels],
                      [lv.dimensions for lv in levels],
                      h.component_names, h.time, h.prob_lo, h.prob_hi,
                      (2, 2, 2), h.domain_dims(0), h.level_steps)
    again = pf.read_level(str(out), 0, [0, 1])
    for a, b in zip(levels[0].boxes, again.boxes):
        np.testing.assert_array_equal(a, b)
    assert again.locations == levels[0].locations


def test_big_endian_fab_rejected(tmp_path):
    """A foreign byte-order FAB raises a clean error instead of decoding
    garbage (VisMF::Read byte-swaps; no supported platform writes one)."""
    import shutil

    dst = tmp_path / "plt00074"
    shutil.copytree(PLT74, dst)
    fab = dst / "Level_0" / "Cell_D_00000"
    raw = fab.read_bytes()
    le, be = b"(8, (8 7 6 5 4 3 2 1))", b"(8, (1 2 3 4 5 6 7 8))"
    assert le in raw
    fab.write_bytes(raw.replace(le, be, 1))
    with pytest.raises(ValueError, match="byte order"):
        pf.read_level(str(dst), 0, [0, 1])


def test_write_plotfile_f32_precision(tmp_path):
    """outprec=f32: single-precision FABs read back value-identical (the
    data is float32 end to end) at half the Cell_D bytes."""
    levels = [pf.read_level(PLT74, l, [0, 1]) for l in range(2)]
    h = pf.read_header(PLT74)

    def write(out, precision):
        pf.write_plotfile(str(out), [lv.boxes for lv in levels],
                          [lv.locations for lv in levels],
                          [lv.dimensions for lv in levels],
                          h.component_names, h.time, h.prob_lo, h.prob_hi,
                          (2, 2, 2), h.domain_dims(0), h.level_steps,
                          precision=precision)

    write(tmp_path / "p64", "f64")
    write(tmp_path / "p32", "f32")
    for lvl in range(2):
        a = pf.read_level(str(tmp_path / "p64"), lvl, [0, 1])
        b = pf.read_level(str(tmp_path / "p32"), lvl, [0, 1])
        for x, y in zip(a.boxes, b.boxes):
            np.testing.assert_array_equal(x, y)
        d64 = os.path.getsize(tmp_path / "p64" / f"Level_{lvl}" / "Cell_D_00000")
        d32 = os.path.getsize(tmp_path / "p32" / f"Level_{lvl}" / "Cell_D_00000")
        assert d32 < 0.6 * d64

    with pytest.raises(ValueError, match="precision"):
        write(tmp_path / "bad", "f16")
