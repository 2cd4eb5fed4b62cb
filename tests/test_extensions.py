"""Extension features beyond the reference: multi-scale transform, int16
payloads, extension metadata sidecar.  (The reference's TODO.txt wishlist —
coefficient-width selection and better compaction — implemented device-side.)"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from wavelet_tpu.core import haar
from wavelet_tpu.io import archive, plotfile as pf
from wavelet_tpu.pipeline import Config, compress_run, decompress_run, estimate_run


def test_multiscale_roundtrip_and_compaction():
    rng = np.random.default_rng(0)
    x, y, z = np.meshgrid(np.linspace(0, 2, 32), np.linspace(0, 2, 16),
                          np.linspace(0, 2, 8), indexing="ij")
    smooth = (np.sin(x) + np.cos(y) * z).astype(np.float32)
    for scales in (1, 2, 3):
        c = haar.haar3d_forward_multi(jnp.asarray(smooth), scales)
        back = np.asarray(haar.haar3d_inverse_multi(c, scales))
        np.testing.assert_allclose(back, smooth, atol=1e-5)
    # deeper scales concentrate energy: fewer coefficients above threshold
    c1 = np.asarray(haar.haar3d_forward_multi(jnp.asarray(smooth), 1))
    c3 = np.asarray(haar.haar3d_forward_multi(jnp.asarray(smooth), 3))
    thr = np.abs(c1).max() * 1e-3
    assert np.sum(np.abs(c3) > thr) < np.sum(np.abs(c1) > thr)


def test_multiscale_scale1_equals_reference_transform():
    rng = np.random.default_rng(1)
    box = rng.standard_normal((8, 8, 8)).astype(np.float32)
    a = np.asarray(haar.haar3d_forward(jnp.asarray(box)))
    b = np.asarray(haar.haar3d_forward_multi(jnp.asarray(box), 1))
    np.testing.assert_array_equal(a, b)


def test_multiscale_rejects_indivisible_dims():
    with pytest.raises(ValueError):
        haar.haar3d_forward_multi(jnp.zeros((6, 8, 8), jnp.float32), 2)


def test_q16_payload_roundtrip():
    rng = np.random.default_rng(2)
    runs = rng.integers(0, 5, 40).astype(np.int32)
    vals = (rng.standard_normal(40) * 100).astype(np.float32)
    blob = archive.serialize_payload_q16((4, 8, 16), runs, vals)
    shape, total, runs2, vals2 = archive.deserialize_payload_q16(blob)
    assert shape == (4, 8, 16) and total == 512
    np.testing.assert_array_equal(runs2, runs)
    # quantization error bounded by scale/2
    scale = np.abs(vals).max() / 32767
    np.testing.assert_allclose(vals2, vals, atol=scale * 0.51)
    # ~33% smaller than the f32 payload pre-xz
    f32 = archive.serialize_payload((4, 8, 16), runs, vals)
    assert len(blob) < len(f32) * 0.8


def test_meta_sidecar_defaults():
    assert archive.read_meta("/nonexistent") == {
        "format_version": 0, "threshold_mode": "box", "scales": 1,
        "payload": "f32", "codec": "xz", "xz_preset": 6,
        "archive": "files"}


def _synth(tmp_path):
    rng = np.random.default_rng(3)
    x, y, z = np.meshgrid(np.linspace(0, 4, 32), np.linspace(0, 3, 16),
                          np.linspace(0, 2, 8), indexing="ij")
    a = (np.sin(2 * x) * np.cos(y) + z).astype(np.float32)
    b = (a * 10 + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
    src = tmp_path / "data" / "plt00040"
    pf.write_plotfile(str(src), [[np.stack([a, b])]], [[(0, 0, 0)]],
                      [[(32, 16, 8)]], ["a", "b"], 0.5, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (32, 16, 8), [40])
    return str(tmp_path / "data")


@pytest.mark.parametrize("scales,payload", [(2, "f32"), (1, "q16"),
                                            (3, "q16")])
def test_extended_modes_end_to_end(tmp_path, scales, payload):
    data_dir = _synth(tmp_path)
    comp = str(tmp_path / f"c{scales}{payload}") + "/"
    out = str(tmp_path / f"o{scales}{payload}") + "/"
    cfg = Config(data_dir=data_dir, min_time="plt00040", max_time="plt00040",
                 min_level=0, max_level=0, components=["a", "b"], keep=0.999,
                 compressed_dir=comp, scales=scales, payload=payload)
    compress_run(cfg)
    meta = archive.read_meta(comp)
    assert meta["scales"] == scales and meta["payload"] == payload

    decompress_run(Config(compressed_dir=comp, out_dir=out))
    regen = pf.read_level(out + "plt00040", 0, [0, 1])
    orig = pf.read_level(data_dir + "/plt00040", 0, [0, 1])
    err = np.abs(regen.boxes[0].astype(np.float64) -
                 orig.boxes[0].astype(np.float64)).max()
    rng_val = float(orig.boxes[0].max() - orig.boxes[0].min())
    assert err < 0.02 * rng_val


def test_random_flavor_matrix_transport_knobs_never_change_bytes(tmp_path):
    """Interaction property across the whole flavor matrix: for ANY codec
    flavor (scales x payload x threshold mode), the transport/container
    knobs (transfer, archive, codec, xzpreset, prefetch) must never change
    the regenerated plotfile bytes — seeded random draws cover combos the
    per-feature tests don't."""
    import itertools

    from conftest import tree_bytes

    rng = np.random.default_rng(99)
    data_dir = _synth(tmp_path)

    codec_flavors = list(itertools.product(
        (1, 2), ("f32", "q16"), ("box", "global")))
    rng.shuffle(codec_flavors)
    for trial, (scales, payload, tmode) in enumerate(codec_flavors[:4]):
        codec_kw = dict(scales=scales, payload=payload,
                        threshold_mode=tmode,
                        xz_delta=int(rng.choice([0, 8])))
        if tmode == "global":
            codec_kw["keep_fraction"] = 0.05
        transport_kw = dict(
            transfer=str(rng.choice(["dense", "sparse"])),
            archive=str(rng.choice(["files", "bundle"])),
            codec=str(rng.choice(["xz", "raw"])),
            xz_preset=int(rng.choice([1, 6])),
            prefetch=int(rng.choice([0, 1])))
        base_c = str(tmp_path / f"bc{trial}") + "/"
        base_o = str(tmp_path / f"bo{trial}") + "/"
        var_c = str(tmp_path / f"vc{trial}") + "/"
        var_o = str(tmp_path / f"vo{trial}") + "/"
        common_kw = dict(data_dir=data_dir, min_time="plt00040",
                         max_time="plt00040", min_level=0, max_level=0,
                         components=["a", "b"], keep=0.999)
        compress_run(Config(compressed_dir=base_c, **common_kw, **codec_kw))
        decompress_run(Config(compressed_dir=base_c, out_dir=base_o))
        compress_run(Config(compressed_dir=var_c, **common_kw, **codec_kw,
                            **transport_kw))
        decompress_run(Config(compressed_dir=var_c, out_dir=var_o,
                              transfer=transport_kw["transfer"],
                              prefetch=transport_kw["prefetch"]))
        assert tree_bytes(base_o + "plt00040") == \
            tree_bytes(var_o + "plt00040"), (
            f"trial {trial}: {codec_kw} x {transport_kw}")


def test_extended_modes_shrink_archive(tmp_path):
    """scales=3 + q16 should compress smooth data much harder than parity
    settings at the same keep."""
    from wavelet_tpu.core import metrics

    data_dir = _synth(tmp_path)
    sizes = {}
    for name, kw in (("parity", {}), ("ext", {"scales": 3, "payload": "q16"})):
        comp = str(tmp_path / name) + "/"
        cfg = Config(data_dir=data_dir, min_time="plt00040",
                     max_time="plt00040", min_level=0, max_level=0,
                     components=["a", "b"], keep=0.999,
                     compressed_dir=comp, **kw)
        compress_run(cfg)
        sizes[name] = metrics.dir_size(comp)
    assert sizes["ext"] < sizes["parity"]
