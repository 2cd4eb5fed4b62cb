"""The interleaved (in-place) Haar layout: core/interleave.py.

The stencil keeps each pass's (low, high) pairs at their source positions
(even/odd) instead of deinterleaving into axis halves; the host packer
recovers the reference byte order through index permutations.  The
giant-box path (a box X-sharded over a mesh) is the layout's producer in
the pipelines.  These tests pin the contract: bitwise equality with the
reference transform after permutation, identical archive bytes through
both layouts and both packer backends, and the inverse consuming
interleaved coefficients directly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavelet_tpu import native
from wavelet_tpu.core import haar, interleave, threshold
from wavelet_tpu.io import archive
from wavelet_tpu.runtime import batching, engine, mesh as mesh_lib


def _perm_deint(arr):
    x, y, z = arr.shape
    return arr[np.ix_(interleave.interleave_perm(x),
                      interleave.interleave_perm(y),
                      interleave.interleave_perm(z))]


def _mesh(n):
    return mesh_lib.data_mesh(jax.devices()[:n])


def _interleaved_batch(boxes, scales=1):
    """Stencil-transformed boxes as an interleaved coefficient batch."""
    n, x, y, z = boxes.shape
    c = np.stack([np.asarray(interleave.forward_block(jnp.asarray(b), scales))
                  for b in boxes])
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(n)]
    return batching.ShapeBatch(shape=(x, y, z), data=c, items=items,
                               n_valid=n, layout="interleaved",
                               scales=scales), items


@pytest.mark.parametrize("dims", [(8, 4, 4), (16, 8, 8), (4, 8, 2),
                                  (8, 8, 16)])
def test_interleaved_forward_bitwise_vs_reference(dims):
    rng = np.random.default_rng(0)
    boxes = rng.standard_normal((2,) + dims).astype(np.float32)
    ref = np.asarray(haar.haar3d_forward(jnp.asarray(boxes)))
    for i in range(2):
        c = np.asarray(interleave.forward_block(jnp.asarray(boxes[i])))
        np.testing.assert_array_equal(
            _perm_deint(c).view(np.int32), ref[i].view(np.int32))


@pytest.mark.parametrize("dims", [(8, 4, 4), (16, 8, 8)])
def test_interleaved_inverse_bitwise(dims):
    """Inverse consumes interleaved coefficients, emits natural spatial."""
    rng = np.random.default_rng(1)
    box = rng.standard_normal(dims).astype(np.float32)
    c = interleave.forward_block(jnp.asarray(box))
    out = np.asarray(interleave.inverse_block(c))
    ref_c = haar.haar3d_forward(jnp.asarray(box))
    ref_out = np.asarray(haar.haar3d_inverse(ref_c))
    np.testing.assert_array_equal(out.view(np.int32), ref_out.view(np.int32))


def test_interleave_perm_roundtrip():
    for n in (2, 4, 7, 8, 64):
        p = interleave.interleave_perm(n)
        assert sorted(p) == list(range(n))


def _synth(tmp_path):
    from wavelet_tpu.io import plotfile as pf

    rng = np.random.default_rng(5)
    boxes = []
    for b in range(3):
        smooth = np.fromfunction(
            lambda i, j, k: np.sin(0.3 * i + b) * np.cos(0.2 * j) + 0.1 * k,
            (8, 8, 8)).astype(np.float32)
        noisy = (smooth + 0.05 * rng.standard_normal(smooth.shape)
                 ).astype(np.float32)
        boxes.append(np.stack([smooth, noisy]))
    pf.write_plotfile(str(tmp_path / "data" / "plt00050"),
                      [boxes], [[(0, 0, 0), (8, 0, 0), (16, 0, 0)]],
                      [[(8, 8, 8)] * 3], ["a", "b"], 0.5, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (24, 8, 8), [50])
    return str(tmp_path / "data")


def _cfg(data_dir, out, **kw):
    from wavelet_tpu.pipeline import Config

    base = dict(data_dir=data_dir, min_time="plt00050", max_time="plt00050",
                min_level=0, max_level=0, components=["a", "b"],
                keep=0.999, compressed_dir=out)
    base.update(kw)
    return Config(**base)


def _same_archives(d1, d2):
    for name in sorted(os.listdir(d1)):
        a = open(os.path.join(d1, name), "rb").read()
        b = open(os.path.join(d2, name), "rb").read()
        if name.endswith(".xz"):
            # payload contract (containers differ between backends)
            a, b = archive.xz_decompress(a), archive.xz_decompress(b)
        assert a == b, f"{name} differs"


def test_interleaved_pipeline_bytes_match_default(tmp_path):
    """Boxes routed through the interleaved giant path give the archive of
    the default halves path, and decompress back through it."""
    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import Config, compress_run, decompress_run

    data_dir = _synth(tmp_path)
    mesh = _mesh(4)
    assert engine.CodecEngine(mesh=mesh, giant_box_bytes=1024).coeff_layout(
        (8, 8, 8)) == "interleaved"
    int_dir = str(tmp_path / "int") + os.sep
    compress_run(_cfg(data_dir, int_dir, giant_box_bytes=1024), mesh=mesh)
    dfl_dir = str(tmp_path / "dfl") + os.sep
    compress_run(_cfg(data_dir, dfl_dir))
    _same_archives(dfl_dir, int_dir)

    out_dir = str(tmp_path / "out") + os.sep
    decompress_run(Config(compressed_dir=int_dir, out_dir=out_dir,
                          giant_box_bytes=1024), mesh=mesh)
    regen = pf.read_level(out_dir + "plt00050", 0, [0, 1])
    orig = pf.read_level(data_dir + "/plt00050", 0, [0, 1])
    assert np.abs(regen.boxes[0] - orig.boxes[0]).mean() < 0.05


@pytest.mark.skipif(not native.available(), reason="native codec not built")
def test_indexed_native_pack_matches_python(tmp_path):
    """native pack_indexed/unpack_indexed == the python permuted walk."""
    rng = np.random.default_rng(7)
    x, y, z, n = 8, 4, 4, 4
    boxes = rng.standard_normal((n, x, y, z)).astype(np.float32)
    cb, items = _interleaved_batch(boxes)
    signed = engine.resolve_signed_absmax(
        cb.data.reshape(n, -1).max(1), cb.data.reshape(n, -1).min(1),
        row_getter=lambda i: cb.item_view(i).reshape(-1))
    t32 = threshold.exact_threshold32(signed, 0.999)
    outs = {}
    for use_native in (True, False):
        d = tmp_path / ("n" if use_native else "p")
        os.makedirs(d)
        engine.HostPacker(use_native=use_native).pack(str(d), cb, t32)
        # compare serialized payloads: the xz container bytes differ
        # between liblzma's buffer API and python's lzma (test_native.py)
        outs[use_native] = {
            f: archive.xz_decompress(open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))}
    assert outs[True] == outs[False]

    # and both agree with the plain (non-interleaved) reference pack
    ref_c = np.asarray(haar.haar3d_forward(jnp.asarray(boxes)))
    d = tmp_path / "ref"
    os.makedirs(d)
    rb = batching.ShapeBatch(shape=(x, y, z), data=ref_c, items=items,
                             n_valid=n)
    engine.HostPacker(use_native=False).pack(str(d), rb, t32)
    ref_bytes = {
        f: archive.xz_decompress(open(os.path.join(d, f), "rb").read())
        for f in sorted(os.listdir(d))}
    assert ref_bytes == outs[False]

    # unpack back through both backends
    for use_native in (True, False):
        ub = batching.empty_batch(items, (x, y, z), layout="interleaved")
        engine.HostPacker(use_native=use_native).unpack_into(
            str(tmp_path / "p"), ub)
        for i in range(n):
            masked = np.where(np.abs(ref_c[i]) > t32[i], ref_c[i], 0.0)
            np.testing.assert_array_equal(ub.item_view(i), masked)


def test_interleaved_sparse_transfer_matches_dense(tmp_path):
    """transfer=sparse routes giant (interleaved) shapes dense, so the
    archive equals the dense one."""
    from wavelet_tpu.pipeline import compress_run

    data_dir = _synth(tmp_path)
    mesh = _mesh(4)
    dirs = {}
    for mode in ("dense", "sparse"):
        d = str(tmp_path / mode) + os.sep
        compress_run(_cfg(data_dir, d, transfer=mode, giant_box_bytes=1024),
                     mesh=mesh)
        dirs[mode] = d
    _same_archives(dirs["dense"], dirs["sparse"])


def test_interleaved_env_falls_back_for_odd_dims(tmp_path):
    """Odd box extents can't use the interleaved stencil (the reference's
    stay-in-place/zeroing quirks need the halves path): even on a mesh
    with a tiny giant threshold they keep the halves layout and match the
    jnp reference bitwise."""
    e = engine.CodecEngine(mesh=_mesh(4), giant_box_bytes=1)
    assert e.coeff_layout((7, 8, 8)) == "halves"
    assert e.coeff_layout((8, 7, 8)) == "halves"
    assert e.coeff_layout((8, 8, 8)) == "interleaved"
    rng = np.random.default_rng(2)
    data = rng.standard_normal((4, 7, 8, 9)).astype(np.float32)
    flat, _mask = e.compress_batch(data, 0.999)
    ref_c = np.asarray(haar.forward_flat(jnp.asarray(data)))
    np.testing.assert_array_equal(flat, ref_c)


# ---------------------------------------------------------------------------
# multi-scale interleaved (scales > 1: strided stencils + non-separable map)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,scales", [
    ((8, 8, 8), 2),
    ((16, 8, 8), 3),
    ((8, 4, 4), 2),
])
def test_interleaved_multiscale_bitwise(dims, scales):
    """Strided in-place pyramid == haar3d_forward_multi after the flat
    map, both directions."""
    rng = np.random.default_rng(4)
    x, y, z = dims
    boxes = rng.standard_normal((2,) + dims).astype(np.float32)
    ref = np.asarray(haar.haar3d_forward_multi(jnp.asarray(boxes), scales))
    ref_out = np.asarray(haar.haar3d_inverse_multi(jnp.asarray(ref), scales))
    fmap = interleave.interleave_map_multi(dims, scales, y * z, z, 1)
    for i in range(2):
        c = interleave.forward_block(jnp.asarray(boxes[i]), scales)
        got = np.asarray(c).reshape(-1)[fmap].reshape(dims)
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref[i].view(np.int32))
        out = np.asarray(interleave.inverse_block(c, scales))
        np.testing.assert_array_equal(out.view(np.int32),
                                      ref_out[i].view(np.int32))


def test_multiscale_interleaved_pipeline_bytes_match_jnp(tmp_path):
    """scales=2 archives through the interleaved giant path must be
    byte-identical to the jnp multi-scale path (payload contract), and
    decompress back identically."""
    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import Config, compress_run, decompress_run

    data_dir = _synth(tmp_path)
    mesh = _mesh(2)     # X=8 must divide by mesh size * 2**scales
    int_dir = str(tmp_path / "ms_int") + os.sep
    compress_run(_cfg(data_dir, int_dir, scales=2, giant_box_bytes=1024),
                 mesh=mesh)
    jnp_dir = str(tmp_path / "ms_jnp") + os.sep
    compress_run(_cfg(data_dir, jnp_dir, scales=2))
    _same_archives(jnp_dir, int_dir)

    out_dir = str(tmp_path / "ms_out") + os.sep
    decompress_run(Config(compressed_dir=int_dir, out_dir=out_dir,
                          giant_box_bytes=1024), mesh=mesh)
    orig = pf.read_level(data_dir + "/plt00050", 0, [0, 1])
    regen = pf.read_level(out_dir + "plt00050", 0, [0, 1])
    assert np.abs(regen.boxes[0] - orig.boxes[0]).mean() < 0.05


@pytest.mark.skipif(not native.available(), reason="native codec not built")
def test_mapped_native_pack_matches_python_multiscale(tmp_path):
    """native pack_mapped/unpack_mapped == the python flat-map walk."""
    rng = np.random.default_rng(8)
    x, y, z, n, scales = 8, 8, 8, 4, 2
    boxes = rng.standard_normal((n, x, y, z)).astype(np.float32)
    cb, items = _interleaved_batch(boxes, scales)
    signed = engine.resolve_signed_absmax(
        cb.data.reshape(n, -1).max(1), cb.data.reshape(n, -1).min(1),
        row_getter=lambda i: cb.item_view(i).reshape(-1))
    t32 = threshold.exact_threshold32(signed, 0.999)
    outs = {}
    for use_native in (True, False):
        d = tmp_path / ("n" if use_native else "p")
        os.makedirs(d)
        engine.HostPacker(use_native=use_native).pack(str(d), cb, t32)
        outs[use_native] = {
            f: archive.xz_decompress(open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))}
    assert outs[True] == outs[False]
    # unpack via mapped scatter, both backends, equals masked jnp reference
    ref_c = np.asarray(haar.haar3d_forward_multi(jnp.asarray(boxes), 2))
    for use_native in (True, False):
        ub = batching.empty_batch(items, (x, y, z), layout="interleaved",
                                  scales=scales)
        engine.HostPacker(use_native=use_native).unpack_into(
            str(tmp_path / "p"), ub)
        for i in range(n):
            masked = np.where(np.abs(ref_c[i]) > t32[i], ref_c[i], 0.0)
            np.testing.assert_array_equal(ub.item_view(i), masked)


@pytest.mark.skipif(not native.available(), reason="native codec not built")
def test_mapped_native_q16_matches_python_multiscale(tmp_path):
    """q16 payloads through the mapped walk: native == python bytes."""
    rng = np.random.default_rng(9)
    x, y, z, n, scales = 8, 8, 8, 2, 2
    boxes = (rng.standard_normal((n, x, y, z)) * 50).astype(np.float32)
    cb, _items = _interleaved_batch(boxes, scales)
    signed = engine.resolve_signed_absmax(
        cb.data.reshape(n, -1).max(1), cb.data.reshape(n, -1).min(1),
        row_getter=lambda i: cb.item_view(i).reshape(-1))
    t32 = threshold.exact_threshold32(signed, 0.99)
    outs = {}
    for use_native in (True, False):
        d = tmp_path / ("n" if use_native else "p")
        os.makedirs(d)
        engine.HostPacker(use_native=use_native, payload="q16").pack(
            str(d), cb, t32)
        outs[use_native] = {
            f: archive.xz_decompress(open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))}
    assert outs[True] == outs[False]


@pytest.mark.parametrize("scales", [1, 2])
def test_global_mode_forced_pallas_interleaved(tmp_path, scales):
    """The global-threshold pipeline through the interleaved giant path:
    bytes identical to the plain jnp path."""
    from wavelet_tpu.pipeline import compress_run

    data_dir = _synth(tmp_path)
    mesh = _mesh(4 if scales == 1 else 2)
    kw = dict(threshold_mode="global", keep_fraction=0.1, scales=scales)
    int_dir = str(tmp_path / f"g{scales}_int") + os.sep
    compress_run(_cfg(data_dir, int_dir, giant_box_bytes=1024, **kw),
                 mesh=mesh)
    jnp_dir = str(tmp_path / f"g{scales}_jnp") + os.sep
    compress_run(_cfg(data_dir, jnp_dir, **kw))
    _same_archives(jnp_dir, int_dir)


def test_mixed_shapes_effective_scales_roundtrip(tmp_path):
    """scales=2 on a run mixing a pyramid-capable box with a (8,4,2)-style
    box that can only take one scale: each shape uses its deepest
    applicable pyramid and the archive round-trips (regression: the run
    used to abort with 'dims not divisible')."""
    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import Config, compress_run, decompress_run

    rng = np.random.default_rng(13)
    big = np.fromfunction(
        lambda i, j, k: np.sin(0.2 * i) + 0.1 * j + 0.05 * k,
        (16, 8, 8)).astype(np.float32)
    tiny = rng.standard_normal((8, 4, 2)).astype(np.float32)
    pf.write_plotfile(str(tmp_path / "data" / "plt00080"),
                      [[big[None], tiny[None]]],
                      [[(0, 0, 0), (16, 0, 0)]],
                      [[(16, 8, 8), (8, 4, 2)]],
                      ["a"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (24, 8, 8), [80])
    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    compress_run(Config(data_dir=str(tmp_path / "data"),
                        min_time="plt00080", max_time="plt00080",
                        min_level=0, max_level=0, components=["a"],
                        keep=0.999, scales=2, compressed_dir=comp))
    decompress_run(Config(compressed_dir=comp, out_dir=out))
    regen = pf.read_level(out + "plt00080", 0, [0])
    assert np.abs(regen.boxes[0][0] - big).mean() < 0.05
    # the tiny box took a single-scale transform: even dims round-trip
    # within keep=0.999 tolerance
    assert np.abs(regen.boxes[1][0] - tiny).mean() < 0.2


def test_large_box_gate_lifted():
    """No box-size gate: without a mesh every shape takes the halves
    layout on one device; with a mesh, boxes at or above the giant
    threshold take the interleaved giant path."""
    e = engine.CodecEngine()
    for dims in [(128, 128, 128), (512, 512, 512), (128, 32, 64)]:
        assert e.coeff_layout(dims) == "halves", dims
    g = engine.CodecEngine(mesh=_mesh(8), giant_box_bytes=1 << 20)
    assert g.coeff_layout((128, 128, 128)) == "interleaved"
    assert g.coeff_layout((32, 32, 32)) == "halves"     # below threshold
    g2 = engine.CodecEngine(mesh=_mesh(8), giant_box_bytes=1 << 20,
                            scales=2)
    assert g2.coeff_layout((128, 128, 128)) == "interleaved"
    assert g2.coeff_layout((128, 128, 99)) == "halves"   # odd extent


def test_interleaved_large_box_bitwise():
    """A 128^3 box (8 MiB) runs the giant engine path end to end —
    forward, threshold plumbing, inverse — bitwise vs the jnp
    reference."""
    dims = (128, 128, 128)
    e = engine.CodecEngine(mesh=_mesh(8), giant_box_bytes=1 << 20)
    assert e.coeff_layout(dims) == "interleaved"
    rng = np.random.default_rng(11)
    arr = rng.standard_normal(dims).astype(np.float32)
    item = batching.WorkItem(t=0, level=0, comp_idx=0, box=0)
    [batch] = batching.plan_batches([(item, arr)], pad_fn=e.pad_multiple_for)
    cb, t32 = e.compress_shapebatch(batch, 0.999)
    assert cb.layout == "interleaved"
    ref_c = np.asarray(haar.haar3d_forward(jnp.asarray(arr[None])))[0]
    np.testing.assert_array_equal(
        cb.item_view(0).view(np.int32), ref_c.view(np.int32))
    out = e.decompress_shapebatch(cb)
    ref_r = np.asarray(haar.haar3d_inverse(jnp.asarray(ref_c[None])))[0]
    np.testing.assert_array_equal(
        out.item_view(0).view(np.int32), ref_r.view(np.int32))


def test_eff_scales():
    e = engine.CodecEngine(scales=3)
    assert e.eff_scales((16, 16, 16)) == 3
    assert e.eff_scales((16, 8, 8)) == 3   # 8 % 2**3 == 0: full depth ok
    assert e.eff_scales((16, 8, 4)) == 2
    assert e.eff_scales((8, 4, 2)) == 1
    assert e.eff_scales((7, 8, 8)) == 1


@pytest.mark.parametrize("scales", [1, 2])
def test_interleaved_sparse_decompress_bitwise(tmp_path, scales):
    """-d transfer=sparse (device scatter of the kept pairs + the same
    inverse as dense) is bit-identical to dense decompress."""
    import filecmp

    from wavelet_tpu.pipeline import Config, compress_run, decompress_run

    data_dir = _synth(tmp_path)
    comp = str(tmp_path / "comp") + os.sep
    compress_run(_cfg(data_dir, comp, keep=0.97, scales=scales))
    outs = []
    for mode in ("dense", "sparse"):
        out = str(tmp_path / f"out_{mode}") + os.sep
        decompress_run(Config(compressed_dir=comp, out_dir=out,
                              transfer=mode))
        outs.append(out)
    for root, _d, names in os.walk(outs[0]):
        rel = os.path.relpath(root, outs[0])
        for nme in names:
            assert filecmp.cmp(os.path.join(root, nme),
                               os.path.join(outs[1], rel, nme),
                               shallow=False), (rel, nme)
