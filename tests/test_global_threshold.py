"""Global-threshold mode: exponent-bin histograms, quantile selection, and
the end-to-end compress path (new capability; no reference
analogue — SURVEY.md §2 item 2 and BASELINE.json configs 4-5)."""

import numpy as np
import pytest

import jax.numpy as jnp

from wavelet_tpu.core import threshold as thr
from wavelet_tpu.pipeline import Config, common, compress, decompress
from wavelet_tpu.io import plotfile as pf
from wavelet_tpu.runtime import engine


def test_exponent_histogram_counts_and_merge():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 100).astype(np.float32)
    b = (rng.standard_normal(4096) * 0.01).astype(np.float32)
    ha = np.asarray(thr.abs_exponent_histogram(jnp.asarray(a)), np.int64)
    hb = np.asarray(thr.abs_exponent_histogram(jnp.asarray(b)), np.int64)
    hab = np.asarray(thr.abs_exponent_histogram(
        jnp.asarray(np.concatenate([a, b]))), np.int64)
    assert ha.sum() == 4096 and hb.sum() == 4096
    np.testing.assert_array_equal(ha + hb, hab)   # mergeable by addition


@pytest.mark.parametrize("frac", [0.5, 0.1, 0.01])
def test_threshold_from_histogram_quantile(frac):
    rng = np.random.default_rng(1)
    mags = (rng.lognormal(0, 3, 1 << 16)).astype(np.float32)
    hist = np.asarray(thr.abs_exponent_histogram(jnp.asarray(mags)), np.int64)
    t = thr.threshold_from_histogram(hist, frac)
    kept = np.mean(np.abs(mags) > t)
    # quantile resolution is one bin (~6% relative in count terms)
    assert kept <= frac * 1.001
    assert kept >= frac * 0.75


def test_threshold_keep_all_fraction():
    mags = np.array([1.0, 2.0, 0.0], np.float32)
    hist = np.asarray(thr.abs_exponent_histogram(jnp.asarray(mags)), np.int64)
    t = thr.threshold_from_histogram(hist, 1.0)
    assert np.mean(np.abs(mags) > t) >= 2 / 3   # all nonzero kept


def _write_synthetic(tmp_path, name="plt00010"):
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(np.linspace(0, 4, 32), np.linspace(0, 3, 16),
                          np.linspace(0, 2, 8), indexing="ij")
    smooth = (np.sin(3 * x) * np.cos(2 * y) + z).astype(np.float32)
    noisy = (10 * smooth + rng.standard_normal(smooth.shape)).astype(np.float32)
    src = tmp_path / "data" / name
    pf.write_plotfile(str(src), [[np.stack([smooth, noisy])]],
                      [[(0, 0, 0)]], [[(32, 16, 8)]],
                      ["a", "b"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (32, 16, 8), [10])
    return str(tmp_path / "data")


def test_global_mode_end_to_end(tmp_path):
    data_dir = _write_synthetic(tmp_path)
    comp_dir = str(tmp_path / "comp") + "/"
    out_dir = str(tmp_path / "out") + "/"
    cfg = Config(data_dir=data_dir, min_time="plt00010", max_time="plt00010",
                 min_level=0, max_level=0, components=["a", "b"],
                 threshold_mode="global", keep_fraction=0.1,
                 compressed_dir=comp_dir)
    stats = compress.compress_run(cfg)
    assert stats["files"] == 2
    assert stats["global_threshold"] > 0

    # the archive decompresses with the unchanged pipeline
    dcfg = Config(compressed_dir=comp_dir, out_dir=out_dir)
    decompress.decompress_run(dcfg)
    again = pf.read_level(out_dir + "plt00010", 0, [0, 1])
    orig = pf.read_level(data_dir + "/plt00010", 0, [0, 1])
    # ~10% of coefficients kept -> rough reconstruction, finite error
    err = np.abs(again.boxes[0].astype(np.float64) -
                 orig.boxes[0].astype(np.float64))
    rng_b = orig.boxes[0][1].max() - orig.boxes[0][1].min()
    assert err.mean() < 0.2 * rng_b


def test_global_mode_requires_fraction():
    empty = common.RunData(levels_data=[], comp_idxs=[], components=[],
                           min_values=None, max_values=None, amrexinfo=None,
                           files=[], levels=[])
    with pytest.raises(ValueError):
        compress.compress_collected(empty, 0.999, "/tmp",
                                    threshold_mode="global")


def test_cli_global_keys():
    from wavelet_tpu import cli
    mode, cfg = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'maxfile=a1', 'minlevel=0', 'maxlevel=0',
        'components=x', 'thresholdmode=global', 'keepfraction=0.05', '-c',
        'compresseddir=/o'])
    assert cfg.threshold_mode == "global" and cfg.keep_fraction == 0.05


def _write_multi_t(tmp_path, n_times=3):
    """n_times timesteps, two components, two box shapes per timestep."""
    rng = np.random.default_rng(7)
    data = tmp_path / "data"
    for t in range(n_times):
        boxes = [rng.standard_normal((2, 16, 8, 8)).astype(np.float32),
                 rng.standard_normal((2, 8, 4, 4)).astype(np.float32)]
        pf.write_plotfile(str(data / f"plt{10 + t:05d}"),
                          [boxes], [[(0, 0, 0), (16, 0, 0)]],
                          [[(16, 8, 8), (8, 4, 4)]],
                          ["a", "b"], 0.1 * t, [0., 0., 0.], [1., 1., 1.],
                          (2, 2, 2), (32, 16, 8), [t])
    return str(data)


def _global_cfg(data_dir, comp_dir, **kw):
    return Config(data_dir=data_dir, min_time="plt00010",
                  max_time="plt00099", min_level=0, max_level=0,
                  components=["a", "b"], threshold_mode="global",
                  keep_fraction=0.1, compressed_dir=comp_dir, **kw)


def test_globalcache_byte_identical_and_skips_reread(tmp_path, monkeypatch):
    """The budgeted coefficient cache (round-4 verdict item 1) must change
    NOTHING about the archive bytes, and must actually remove pass 2's
    plotfile re-reads when the run fits the budget."""
    from tests.conftest import tree_bytes

    data_dir = _write_multi_t(tmp_path)
    n_times = 3

    calls = {"n": 0}
    real_read = pf.read_level

    def counting_read(*a, **kw):
        calls["n"] += 1
        return real_read(*a, **kw)

    monkeypatch.setattr(pf, "read_level", counting_read)

    # budget 0: the round-4 behavior — every timestep read twice
    off_dir = str(tmp_path / "off") + "/"
    compress.compress_run(_global_cfg(data_dir, off_dir,
                                      global_cache_bytes=0))
    assert calls["n"] == 2 * n_times
    calls["n"] = 0

    # ample budget: pass 2 reads nothing
    on_dir = str(tmp_path / "on") + "/"
    stats = compress.compress_run(_global_cfg(data_dir, on_dir,
                                              global_cache_bytes=1 << 30))
    assert calls["n"] == n_times
    assert stats["global_cached_timesteps"] == n_times

    a, b = tree_bytes(off_dir), tree_bytes(on_dir)
    assert set(a) == set(b)
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"globalcache changed archive bytes: {diff}"


def test_globalcache_partial_budget(tmp_path, monkeypatch):
    """A budget that fits only SOME timesteps caches a prefix and re-reads
    the rest — still byte-identical."""
    from tests.conftest import tree_bytes

    data_dir = _write_multi_t(tmp_path)
    # one timestep's coefficients: 2 comps x (16*8*8 + 8*4*4) f32 = 9216 B
    # at pack=1 — 10 KiB fits exactly one timestep, not two
    calls = {"n": 0}
    real_read = pf.read_level

    def counting_read(*a, **kw):
        calls["n"] += 1
        return real_read(*a, **kw)

    monkeypatch.setattr(pf, "read_level", counting_read)

    part_dir = str(tmp_path / "part") + "/"
    stats = compress.compress_run(_global_cfg(data_dir, part_dir,
                                              global_cache_bytes=10 << 10))
    assert 1 <= stats["global_cached_timesteps"] < 3
    # pass 1 reads all 3; pass 2 re-reads only the uncached ones
    assert calls["n"] == 3 + (3 - stats["global_cached_timesteps"])

    off_dir = str(tmp_path / "off") + "/"
    compress.compress_run(_global_cfg(data_dir, off_dir,
                                      global_cache_bytes=0))
    a, b = tree_bytes(off_dir), tree_bytes(part_dir)
    assert set(a) == set(b) and not [k for k in a if a[k] != b[k]]


def test_cli_globalcache_key():
    from wavelet_tpu import cli
    base = ['datadir=/d', 'minfile=a1', 'maxfile=a1', 'minlevel=0',
            'maxlevel=0', 'components=x', 'thresholdmode=global',
            'keepfraction=0.05', '-c', 'compresseddir=/o']
    _, cfg = cli.parse_argv(base + ['globalcache=0'])
    assert cfg.global_cache_bytes == 0
    _, cfg = cli.parse_argv(base + ['globalcache=1073741824'])
    assert cfg.global_cache_bytes == 1 << 30
    _, cfg = cli.parse_argv(base)
    assert cfg.global_cache_bytes is None
    with pytest.raises(SystemExit):
        cli.parse_argv(base + ['globalcache=-1'])
