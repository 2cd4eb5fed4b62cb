"""The seeded AMR dataset generator (io/synth.py)."""

import numpy as np
import pytest

from wavelet_tpu.io import plotfile, synth


@pytest.mark.parametrize("base,fractions,mgs", [
    ((128, 128, 128), (0.8, 0.77), 32),
    ((64, 32, 48), (0.5,), 16),
    ((32, 32, 32), (0.5, 0.5, 0.5), 32),
])
def test_layout_follows_amrex_grid_rules(base, fractions, mgs):
    bf, r = 8, 2
    lay = synth.amr_layout(base, fractions, ref_ratio=r, blocking_factor=bf,
                           max_grid_size=mgs, seed=3)
    assert len(lay.dimensions) == len(fractions) + 1
    # level 0 tiles the whole domain
    assert sum(int(np.prod(d)) for d in lay.dimensions[0]) == np.prod(base)
    bounds = []
    for lev, (locs, dims) in enumerate(zip(lay.locations, lay.dimensions)):
        domain = [b * r ** lev for b in base]
        lo = np.min(locs, axis=0)
        hi = np.max(np.asarray(locs) + np.asarray(dims), axis=0)
        for loc, d in zip(locs, dims):
            assert all(1 <= v <= mgs for v in d)          # max_grid_size
            assert all(0 <= a and a + v <= n
                       for a, v, n in zip(loc, d, domain))
        # the refined region is aligned to the blocking factor
        assert all(v % bf == 0 for v in lo) and all(v % bf == 0 for v in hi)
        # boxes tile the region exactly (no overlap, no gap)
        assert sum(int(np.prod(d)) for d in dims) == int(np.prod(hi - lo))
        bounds.append((lo, hi))
    for (plo, phi), (lo, hi) in zip(bounds, bounds[1:]):
        # proper nesting: each region inside its parent's refinement
        assert np.all(lo >= plo * r) and np.all(hi <= phi * r)


def test_layout_and_fields_are_seeded(tmp_path):
    a = synth.amr_layout((32, 32, 32), (0.5,), seed=1)
    b = synth.amr_layout((32, 32, 32), (0.5,), seed=1)
    assert a == b
    p1 = synth.write_amr_dataset(str(tmp_path / "x"), a, ["u", "v"], [0.0],
                                 seed=5)
    p2 = synth.write_amr_dataset(str(tmp_path / "y"), b, ["u", "v"], [0.0],
                                 seed=5)
    for lev in range(2):
        la = plotfile.read_level(p1[0], lev, [0, 1])
        lb = plotfile.read_level(p2[0], lev, [0, 1])
        for x, y in zip(la.boxes, lb.boxes):
            np.testing.assert_array_equal(x, y)


def test_dataset_reads_back_with_fronts(tmp_path):
    lay = synth.amr_layout((32, 32, 32), (0.5,), seed=0)
    paths = synth.write_amr_dataset(str(tmp_path), lay, ["a", "b", "c"],
                                    [0.0, 0.5], seed=0)
    assert [p[-8:] for p in paths] == ["plt00100", "plt00101"]
    h = plotfile.read_header(paths[1])
    assert h.component_names == ["a", "b", "c"]
    assert h.finest_level == 1 and h.ref_ratio == [2]
    assert h.domain_dims(1) == (64, 64, 64)
    lv = plotfile.read_level(paths[0], 1, [0, 1, 2])
    assert [tuple(d) for d in lv.dimensions] == \
        [tuple(d) for d in lay.dimensions[1]]
    for box in lv.boxes:
        assert box.dtype == np.float32 and np.all(np.isfinite(box))
    # sharp fronts: some neighbouring cells jump by far more than the
    # smooth part could
    jumps = max(float(np.abs(np.diff(b, axis=1)).max()) for b in lv.boxes)
    smooth = max(float(np.abs(np.diff(b, axis=1)).mean()) for b in lv.boxes)
    assert jumps > 10 * smooth
    # timesteps differ (the fronts move)
    l0 = plotfile.read_level(paths[0], 0, [0])
    l1 = plotfile.read_level(paths[1], 0, [0])
    assert not np.array_equal(l0.boxes[0], l1.boxes[0])


def test_constant_fixture_facts(tmp_path):
    paths = synth.write_constant_fixture(str(tmp_path))
    lv = plotfile.read_level(paths[1], 1, [0, 1])
    assert lv.dimensions == [(16, 32, 64), (8, 4, 2)]
    assert np.all(lv.boxes[0] == np.float32(3902.4))
    assert np.all(lv.boxes[1] == np.float32(16.0))
