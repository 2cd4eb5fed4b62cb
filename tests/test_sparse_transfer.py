"""On-device sparsification (transfer=sparse): compaction correctness,
overflow fallback, and byte-identity of the resulting archives."""

import filecmp
import os

import numpy as np
import pytest

import jax.numpy as jnp

from wavelet_tpu.core import threshold
from wavelet_tpu.io import plotfile as pf
from wavelet_tpu.pipeline import Config, compress_run
from wavelet_tpu.runtime import batching, engine


def test_compact_step_matches_mask():
    rng = np.random.default_rng(0)
    flat = (rng.standard_normal((5, 256)) *
            rng.integers(0, 2, (5, 256))).astype(np.float32)
    t32 = np.full(5, np.float32(0.5))
    counts, idxs, vals = engine._compact_step(
        jnp.asarray(flat), jnp.asarray(t32), 128)
    counts, idxs, vals = (np.asarray(counts), np.asarray(idxs),
                          np.asarray(vals))
    for i in range(5):
        want_idx = np.flatnonzero(np.abs(flat[i]) > 0.5)
        assert counts[i] == len(want_idx)
        k = min(len(want_idx), 128)
        np.testing.assert_array_equal(idxs[i, :k], want_idx[:k])
        np.testing.assert_array_equal(vals[i, :k], flat[i][want_idx[:k]])


def test_transfer_auto_picks_by_link_and_bytes_match(tmp_path):
    """transfer=auto resolves to dense (engine.transfer_mode: the Python
    sparse packer loses end to end, so no link measurement can pick
    sparse yet), and its archives are byte-identical to an explicit
    transfer=dense run and decode to transfer=sparse's payloads."""
    import os

    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import Config, compress_run

    rng = np.random.default_rng(21)
    box = (rng.standard_normal((16, 16, 16)) * 1e-3).astype(np.float32)
    box[rng.random((16, 16, 16)) < 0.01] = 50.0
    box.flat[0] = 100.0
    pf.write_plotfile(str(tmp_path / "data" / "plt00090"), [[box[None]]],
                      [[(0, 0, 0)]], [[(16, 16, 16)]], ["f"], 0.5,
                      [0., 0., 0.], [1., 1., 1.], (2, 2, 2), (16, 16, 16),
                      [90])

    def run(transfer, out):
        compress_run(Config(
            data_dir=str(tmp_path / "data"), min_time="plt00090",
            max_time="plt00090", min_level=0, max_level=0,
            components=["f"], keep=0.999, transfer=transfer,
            compressed_dir=str(tmp_path / out) + os.sep))
        return {n: open(os.path.join(tmp_path, out, n), "rb").read()
                for n in os.listdir(tmp_path / out)}

    e = engine.CodecEngine()
    for dims in ((16, 16, 16), (8, 8, 8)):
        assert e.transfer_mode(dims, "auto") == "dense"
    auto = run("auto", "auto")
    sparse = run("sparse", "sparse")
    dense = run("dense", "dense")
    assert auto == dense           # auto IS transfer=dense
    # and the decoded payloads agree across transports (the container
    # bytes may differ between the native and python xz encoders)
    from wavelet_tpu.io import archive
    for k in dense:
        if k.endswith(".xz"):
            a = archive.deserialize_payload(archive.decode_blob(
                dense[k], "xz"))
            b = archive.deserialize_payload(archive.decode_blob(
                sparse[k], "xz"))
            assert a[0] == b[0] and a[1] == b[1]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])


def test_compact_step_chunked_path_matches_oracle():
    """Rows long enough for the chunked compaction (m % 512 == 0,
    m >= 2048) must produce the identical kept (index, value) stream, including a
    clustered row (every kept element inside one chunk — the regime real
    AMR coefficients sit in), an empty row, a dense-overflow row, and a
    row whose kept elements straddle chunk boundaries."""
    m, cap = 4096, 256
    flat = np.zeros((4, m), np.float32)
    rng = np.random.default_rng(7)
    flat[0, 512:600] = rng.standard_normal(88).astype(np.float32) * 10
    # row 1 empty (nothing above threshold)
    flat[2] = rng.standard_normal(m).astype(np.float32) * 10  # overflow
    pos = rng.choice(m, 150, replace=False)
    flat[3, pos] = rng.standard_normal(150).astype(np.float32) * 10
    t32 = np.full(4, np.float32(1.0))
    counts, idxs, vals = (np.asarray(v) for v in engine._compact_step(
        jnp.asarray(flat), jnp.asarray(t32), cap))
    for i in range(4):
        want = np.flatnonzero(np.abs(flat[i]) > 1.0)
        assert counts[i] == len(want)
        k = min(len(want), cap)
        np.testing.assert_array_equal(idxs[i, :k], want[:k])
        np.testing.assert_array_equal(vals[i, :k], flat[i][want[:k]])


def test_compact_step_overflow_detected():
    flat = np.ones((2, 64), np.float32)
    t32 = np.zeros(2, np.float32)
    counts, idxs, vals = engine._compact_step(
        jnp.asarray(flat), jnp.asarray(t32), 16)
    assert np.all(np.asarray(counts) == 64)      # > cap -> caller falls back
    np.testing.assert_array_equal(np.asarray(idxs)[0], np.arange(16))


def test_sparse_engine_overflow_fallback():
    rng = np.random.default_rng(1)
    entries = [(batching.WorkItem(0, 0, 0, i),
                rng.standard_normal((4, 8, 16)).astype(np.float32))
               for i in range(3)]
    eng = engine.CodecEngine()
    [batch] = batching.plan_batches(entries)
    # keep everything (negative-max style threshold) -> guaranteed overflow
    sparse, t32 = eng.compress_shapebatch_sparse(batch, keep=2.0,
                                                 cap_fraction=0.05)
    for i in range(3):
        idx, vals = sparse.item_pairs(i, float(t32[i]))
        row = np.asarray(sparse._flat_dev[i])
        want = np.flatnonzero(np.abs(row) > t32[i])
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(vals, row[want])


def _mesh8():
    import jax

    from wavelet_tpu.runtime import mesh as mesh_lib

    return mesh_lib.data_mesh(jax.devices()[:8])


@pytest.mark.parametrize("sharded", [False, True])
def test_sparse_vs_dense_archives_byte_identical(tmp_path, sharded):
    rng = np.random.default_rng(2)
    x, y, z = np.meshgrid(np.linspace(0, 4, 16), np.linspace(0, 3, 8),
                          np.linspace(0, 2, 16), indexing="ij")
    field = (np.sin(2 * x) * np.cos(y) * z).astype(np.float32)
    entries = [(batching.WorkItem(0, 0, 0, i),
                (field * (i + 1)).astype(np.float32)) for i in range(4)]
    eng = engine.CodecEngine(mesh=_mesh8() if sharded else None)
    pad = 8 if sharded else 1
    packer = engine.HostPacker()
    keep = 0.999

    [b1] = batching.plan_batches(entries, pad_multiple=pad)
    coeffs, t32 = eng.compress_shapebatch(b1, keep)
    d_dense = tmp_path / f"dense{sharded}"; d_dense.mkdir()
    packer.pack(str(d_dense), coeffs, t32)

    [b2] = batching.plan_batches(entries, pad_multiple=pad)
    sparse, t32s = eng.compress_shapebatch_sparse(b2, keep)
    d_sparse = tmp_path / f"sparse{sharded}"; d_sparse.mkdir()
    packer.pack_sparse(str(d_sparse), sparse, t32s)

    np.testing.assert_array_equal(t32[:4], t32s[:4])
    for it, _ in entries:
        from wavelet_tpu.io import archive
        name = archive.payload_filename(it.t, it.level, it.comp_idx, it.box)
        # payload bytes identical; the xz container may differ between the
        # native liblzma writer (dense path) and stdlib lzma (sparse path)
        a = archive.xz_decompress(open(d_dense / name, "rb").read())
        b = archive.xz_decompress(open(d_sparse / name, "rb").read())
        assert a == b


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "mesh8"])
def test_sparse_vs_dense_byte_identical_multiscale(tmp_path, sharded):
    """Sparse transfer at scales=2: the pyramid's coefficients are in
    logical order, so sparse and dense archives stay byte-identical
    (payload bytes), on one device and batch-sharded over a mesh."""
    from wavelet_tpu.io import archive

    rng = np.random.default_rng(5)
    entries = [(batching.WorkItem(0, 0, 0, i),
                (rng.standard_normal((8, 8, 16)) * 4).astype(np.float32))
               for i in range(3)]
    eng = engine.CodecEngine(scales=2, mesh=_mesh8() if sharded else None)
    pad = 8 if sharded else 1
    packer = engine.HostPacker()
    keep = 0.99

    [b1] = batching.plan_batches(entries, pad_multiple=pad)
    coeffs, t32 = eng.compress_shapebatch(b1, keep)
    d_dense = tmp_path / "dense"; d_dense.mkdir()
    packer.pack(str(d_dense), coeffs, t32)

    [b2] = batching.plan_batches(entries, pad_multiple=pad)
    sparse, t32s = eng.compress_shapebatch_sparse(b2, keep)
    d_sparse = tmp_path / "sparse"; d_sparse.mkdir()
    packer.pack_sparse(str(d_sparse), sparse, t32s)

    np.testing.assert_array_equal(t32[:3], t32s[:3])
    for it, _ in entries:
        name = archive.payload_filename(it.t, it.level, it.comp_idx, it.box)
        a = archive.xz_decompress(open(d_dense / name, "rb").read())
        b = archive.xz_decompress(open(d_sparse / name, "rb").read())
        assert a == b, name


def test_transfer_sparse_scales2_end_to_end(tmp_path):
    """CLI-level: transfer=sparse no longer routes scales=2 runs to dense;
    archives match the dense-transfer run and decompress identically.

    Spiky low-kept data: with dense-ish data every item overflows the cap
    and the (honestly counted) fallback fetch makes sparse d2h >= dense —
    the d2h assertion needs the mode's design regime."""
    rng = np.random.default_rng(6)
    box = (rng.standard_normal((2, 16, 8, 16)) * 0.01).astype(np.float32)
    spikes = rng.random((2, 16, 8, 16)) < 0.01
    box[spikes] = 50.0
    box[:, 0, 0, 0] = 100.0      # positive signed absmax (SURVEY.md §5.2)
    src = tmp_path / "data" / "plt00055"
    pf.write_plotfile(str(src), [[box]], [[(0, 0, 0)]], [[(16, 8, 16)]],
                      ["a", "b"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (16, 8, 16), [55])
    stats = {}
    for mode in ("dense", "sparse"):
        comp = str(tmp_path / mode) + "/"
        cfg = Config(data_dir=str(tmp_path / "data"), min_time="plt00055",
                     max_time="plt00055", min_level=0, max_level=0,
                     components=["a", "b"], keep=0.99,
                     compressed_dir=comp, transfer=mode, scales=2)
        stats[mode] = compress_run(cfg)
    assert stats["sparse"]["device_to_host_bytes"] < \
        stats["dense"]["device_to_host_bytes"]
    from wavelet_tpu.io import archive
    for f in os.listdir(str(tmp_path / "dense")):
        if f.endswith(".xz"):
            a = archive.xz_decompress(
                open(tmp_path / "dense" / f, "rb").read())
            b = archive.xz_decompress(
                open(tmp_path / "sparse" / f, "rb").read())
            assert a == b, f


def test_transfer_sparse_end_to_end(tmp_path):
    rng = np.random.default_rng(3)
    box = (rng.standard_normal((2, 16, 8, 16)) * 5).astype(np.float32)
    src = tmp_path / "data" / "plt00050"
    pf.write_plotfile(str(src), [[box]], [[(0, 0, 0)]], [[(16, 8, 16)]],
                      ["a", "b"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (16, 8, 16), [50])
    for mode in ("dense", "sparse"):
        comp = str(tmp_path / mode) + "/"
        cfg = Config(data_dir=str(tmp_path / "data"), min_time="plt00050",
                     max_time="plt00050", min_level=0, max_level=0,
                     components=["a", "b"], keep=0.999,
                     compressed_dir=comp, transfer=mode)
        compress_run(cfg)
    for f in os.listdir(str(tmp_path / "dense")):
        if f.endswith(".xz"):
            from wavelet_tpu.io import archive
            a = archive.xz_decompress(
                open(tmp_path / "dense" / f, "rb").read())
            b = archive.xz_decompress(
                open(tmp_path / "sparse" / f, "rb").read())
            assert a == b, f


def test_sparse_mode_reduces_d2h_bytes(tmp_path):
    """The sparse-transfer value proposition is measurable: at small kept
    fractions, device->host traffic must be well below the dense fetch
    (the stat VERDICT asked to track)."""
    import numpy as np

    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import Config, compress_run

    boxes = []
    for b in range(4):
        smooth = np.fromfunction(
            lambda i, j, k: np.sin(0.05 * i) + 0.02 * j + 0.01 * k,
            (16, 16, 16)).astype(np.float32)
        boxes.append(smooth[None] * (b + 1))
    pf.write_plotfile(str(tmp_path / "data" / "plt00060"),
                      [boxes], [[(16 * b, 0, 0) for b in range(4)]],
                      [[(16, 16, 16)] * 4], ["a"], 0.5, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (64, 16, 16), [60])
    stats = {}
    for mode in ("dense", "sparse"):
        d = str(tmp_path / mode) + "/"
        stats[mode] = compress_run(Config(
            data_dir=str(tmp_path / "data"), min_time="plt00060",
            max_time="plt00060", min_level=0, max_level=0,
            components=["a"], keep=0.9, compressed_dir=d, transfer=mode))
    assert stats["sparse"]["device_to_host_bytes"] < \
        0.6 * stats["dense"]["device_to_host_bytes"]
    assert stats["sparse"]["output_bytes"] > 0


def test_sparse_transfer_never_ships_more_than_dense():
    """The compress-side transport invariant, measured by the honest
    accounting (transfer_bytes counts pair buffers AND every fallback
    fetch item_pairs performs): in every regime — tiny all-overflowing
    buckets, one spiky box among many sparse ones, widespread overflow,
    plain sparse — the sparse transport costs at most dense + the counts
    vector."""
    from wavelet_tpu.runtime import batching, engine as eng_mod

    rng = np.random.default_rng(11)

    def boxes_case(n, spec):
        out = np.zeros((n, 8, 8, 8), np.float32)
        for i in range(n):
            if spec(i) == "all":        # negative absmax -> keep all
                out[i] = -5.0
            elif spec(i) == "spiky":
                out[i] = rng.standard_normal((8, 8, 8)) * 1e-3
                out[i, 0, 0, 0] = 100.0
                out[i, 4, 4, 4] = 50.0
        return out

    cases = [
        ("single box all kept", boxes_case(1, lambda i: "all")),
        ("two boxes all kept", boxes_case(2, lambda i: "all")),
        ("one overflower among 15 sparse",
         boxes_case(15, lambda i: "all" if i == 0 else "spiky")),
        ("widespread overflow",
         boxes_case(12, lambda i: "all" if i % 2 else "spiky")),
        ("all sparse", boxes_case(8, lambda i: "spiky")),
    ]
    for name, arrs in cases:
        eng = eng_mod.CodecEngine()   # fresh adaptive hints per case
        items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
                 for b in range(len(arrs))]
        batch = batching.plan_batches(
            [(it, arrs[i]) for i, it in enumerate(items)])[0]
        dense_bytes = batch.data.nbytes
        s, t32 = eng.compress_shapebatch_sparse(batch, 0.999)
        # exercise every fallback item_pairs would perform, then check the
        # accounting covered it
        for i in range(len(items)):
            s.item_pairs(i, float(t32[i]))
        assert s.transfer_bytes() <= dense_bytes + s.counts.nbytes, name


def test_sparse_decompress_dense_fallback_when_pairs_exceed_dense(tmp_path):
    """At pathological kept fractions (here: constant-negative data, whose
    signed absmax is negative, so the reference threshold rule keeps every
    coefficient) the padded (index, value) pair stream costs more bytes
    than the dense rows — the sparse decompress path must fall back to
    dense transport (never ship more than dense) and still produce
    identical plotfiles."""
    from wavelet_tpu.pipeline import decompress_run

    box = np.full((1, 8, 8, 8), -5.0, np.float32)
    pf.write_plotfile(str(tmp_path / "data" / "plt00070"),
                      [[box]], [[(0, 0, 0)]], [[(8, 8, 8)]], ["a"], 0.5,
                      [0., 0., 0.], [1., 1., 1.], (2, 2, 2), (8, 8, 8),
                      [70])
    comp = str(tmp_path / "comp") + "/"
    compress_run(Config(data_dir=str(tmp_path / "data"),
                        min_time="plt00070", max_time="plt00070",
                        min_level=0, max_level=0, components=["a"],
                        keep=0.999, compressed_dir=comp))

    stats = {}
    for mode in ("dense", "sparse"):
        out = str(tmp_path / f"out_{mode}") + "/"
        stats[mode] = decompress_run(Config(compressed_dir=comp,
                                            out_dir=out, transfer=mode))

    # the fallback shipped dense bytes (not the larger pair stream)
    assert stats["sparse"]["host_to_device_bytes"] == \
        stats["dense"]["host_to_device_bytes"]

    for root, _dirs, files in os.walk(str(tmp_path / "out_dense")):
        for fn in files:
            a = os.path.join(root, fn)
            b = a.replace("out_dense", "out_sparse")
            assert filecmp.cmp(a, b, shallow=False), fn


def test_adaptive_sparse_cap_shrinks_transfer():
    """The fetched pair buffers are trimmed on device to the observed max
    kept count (power-of-2 rounded) — even a shape's FIRST batch, whose
    compaction capacity is the cold 25% default, ships only ~kept bytes."""
    import numpy as np

    from wavelet_tpu.runtime import batching, engine as eng_mod

    eng = eng_mod.CodecEngine()
    rng = np.random.default_rng(4)
    smooth = np.fromfunction(
        lambda n, i, j, k: np.sin(0.02 * i) + 0.01 * j + 0.005 * k + 0 * n,
        (8, 16, 16, 16)).astype(np.float32)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(8)]

    def one_batch():
        return batching.plan_batches(
            [(it, smooth[i]) for i, it in enumerate(items)])[0]

    s1, _ = eng.compress_shapebatch_sparse(one_batch(), 0.9)
    s2, _ = eng.compress_shapebatch_sparse(one_batch(), 0.9)
    max_kept = int(s1.counts.max())
    assert s1.cap <= max(128, 2 * max_kept)   # first batch already trimmed
    assert s2.cap <= s1.cap
    # undersized caps must not change results: pairs identical
    for i in range(8):
        i1, v1 = s1.item_pairs(i, 0.0)
        i2, v2 = s2.item_pairs(i, 0.0)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


# ---------------------------------------------------------------------------
# decompress-side sparse transfer (transfer=sparse on -d)
# ---------------------------------------------------------------------------

def _fixture_roundtrip(tmp_path, compress_extra, decompress_transfer):
    import filecmp

    from conftest import FIXTURES, fixture
    from wavelet_tpu.pipeline import decompress_run

    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / f"out_{decompress_transfer}") + os.sep
    compress_run(Config(
        data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
        min_level=0, max_level=1, components=["temp", "pressure"],
        keep=0.999, compressed_dir=comp, **compress_extra))
    decompress_run(Config(compressed_dir=comp, out_dir=out,
                          transfer=decompress_transfer))
    for plt in ("plt00074", "plt00075"):
        src = fixture(plt)
        for root, _d, names in os.walk(src):
            rel = os.path.relpath(root, src)
            for n in names:
                assert filecmp.cmp(
                    os.path.join(root, n),
                    os.path.join(out, plt, rel, n),
                    shallow=False), (plt, rel, n)


@pytest.mark.parametrize("compress_extra", [
    {},
    {"archive": "bundle"},
    {"codec": "raw"},
    {"scales": 2},
    {"threshold_mode": "global", "keep_fraction": 0.5},
], ids=["default", "bundle", "raw", "scales2", "global"])
def test_sparse_decompress_byte_identical(tmp_path, compress_extra):
    """transfer=sparse on the decompress side regenerates byte-identical
    plotfiles for every archive flavor (same coefficients, same inverse
    arithmetic — only the host->device transport differs)."""
    _fixture_roundtrip(tmp_path, compress_extra, "sparse")


def test_sparse_decompress_equals_dense_on_q16(tmp_path):
    """q16 payloads dequantize identically through both transports."""
    import filecmp

    from conftest import FIXTURES
    from wavelet_tpu.pipeline import decompress_run

    comp = str(tmp_path / "comp") + os.sep
    compress_run(Config(
        data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
        min_level=0, max_level=1, components=["temp", "pressure"],
        keep=0.999, compressed_dir=comp, payload="q16"))
    outs = []
    for mode in ("dense", "sparse"):
        out = str(tmp_path / f"out_{mode}") + os.sep
        decompress_run(Config(compressed_dir=comp, out_dir=out,
                              transfer=mode))
        outs.append(out)
    for root, _d, names in os.walk(outs[0]):
        rel = os.path.relpath(root, outs[0])
        for n in names:
            assert filecmp.cmp(os.path.join(root, n),
                               os.path.join(outs[1], rel, n),
                               shallow=False), (rel, n)


def test_sparse_decompress_malformed_payload_matches_dense(tmp_path):
    """On corrupt RLE streams the sparse path must reconstruct exactly what
    the dense path does (the reference's skip-increment semantics)."""
    from wavelet_tpu.core import rle
    from wavelet_tpu.io import archive
    from wavelet_tpu.runtime import batching, engine

    dims = (4, 4, 4)
    total = 64
    # out-of-range pair mid-stream + negative run: exercises both bounds
    runs = np.array([2, 100, -50, 1], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    payload = archive.serialize_payload(dims, runs, vals)
    comp = tmp_path / "comp"
    comp.mkdir()
    with open(comp / archive.payload_filename(0, 0, 0, 0), "wb") as f:
        f.write(archive.encode_blob(payload, "xz", 6))

    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=0)]
    packer = engine.HostPacker()
    dense = batching.empty_batch(items, dims)
    packer.unpack_into(str(comp), dense)
    idx, svals = packer.unpack_sparse(
        str(comp), batching.ShapeBatch(shape=dims, data=None, items=items,
                                       n_valid=1))
    scattered = np.zeros(total, np.float32)
    keep = idx[0] < total
    scattered[idx[0][keep]] = svals[0][keep]
    assert np.array_equal(scattered,
                          np.asarray(dense.item_view(0)).reshape(-1))


def test_sparse_decompress_rejects_total_mismatch(tmp_path):
    """A corrupt header whose total disagrees with dimensions.raw raises a
    clean ValueError (the dense path hits it as a reshape failure; the
    sparse path must not silently drop the out-of-range coefficients)."""
    from wavelet_tpu.io import archive
    from wavelet_tpu.runtime import batching, engine

    dims = (4, 4, 4)
    runs = np.array([0], np.int32)
    vals = np.array([1.0], np.float32)
    payload = archive.serialize_payload(dims, runs, vals)
    # forge the total field (int32 after the three dims)
    forged = bytearray(payload)
    forged[12:16] = np.int32(128).tobytes()
    comp = tmp_path / "comp"
    comp.mkdir()
    with open(comp / archive.payload_filename(0, 0, 0, 0), "wb") as f:
        f.write(archive.encode_blob(bytes(forged), "xz", 6))

    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=0)]
    packer = engine.HostPacker()
    with pytest.raises(ValueError, match="total"):
        packer.unpack_sparse(
            str(comp), batching.ShapeBatch(shape=dims, data=None,
                                           items=items, n_valid=1))


def test_decompress_run_reports_h2d_bytes(tmp_path):
    """decompress_run returns host_to_device_bytes, and the sparse
    transport's figure is smaller than the dense one at low kept
    fractions."""
    from conftest import FIXTURES
    from wavelet_tpu.pipeline import decompress_run

    comp = str(tmp_path / "comp") + os.sep
    compress_run(Config(
        data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
        min_level=0, max_level=1, components=["temp", "pressure"],
        keep=0.999, compressed_dir=comp))
    h2d = {}
    for mode in ("dense", "sparse"):
        out = str(tmp_path / f"out_{mode}") + os.sep
        stats = decompress_run(Config(compressed_dir=comp, out_dir=out,
                                      transfer=mode))
        h2d[mode] = stats["host_to_device_bytes"]
    assert h2d["dense"] > 0 and h2d["sparse"] > 0
    # fixtures are constant boxes: almost nothing is kept, so the padded
    # pair arrays are far smaller than the dense coefficient rows
    assert h2d["sparse"] < h2d["dense"]


def test_sparse_compact_sharded_matches_unsharded():
    """The compact stage on a mesh-sharded batch: the mesh engine's sparse
    pairs must equal the meshless engine's bitwise (rows are independent),
    and indivisible batches must fall back unsharded."""
    from wavelet_tpu.runtime import mesh as mesh_lib

    import jax

    mesh = mesh_lib.data_mesh(jax.devices("cpu")[:8])
    rng = np.random.default_rng(5)
    for n in (8, 16, 5):            # divisible x2 + the fallback case
        data = (rng.standard_normal((n, 8, 8, 8)).astype(np.float32)
                * (rng.random((n, 8, 8, 8)) < 0.03))
        items = [batching.WorkItem(0, 0, 0, b) for b in range(n)]
        entries = [(it, data[i]) for i, it in enumerate(items)]
        eng_m = engine.CodecEngine(mesh=mesh)
        [bm] = batching.plan_batches(entries, pad_multiple=mesh.size,
                                     pad_fn=eng_m.pad_multiple_for)
        sp_m, t32_m = eng_m.compress_shapebatch_sparse(bm, 0.999)
        eng_1 = engine.CodecEngine()
        [b1] = batching.plan_batches(entries, pad_fn=eng_1.pad_multiple_for)
        sp_1, t32_1 = eng_1.compress_shapebatch_sparse(b1, 0.999)
        np.testing.assert_array_equal(t32_m[:n], t32_1[:n])
        for i in range(n):
            im, vm = sp_m.item_pairs(i, float(t32_m[i]))
            i1, v1 = sp_1.item_pairs(i, float(t32_1[i]))
            np.testing.assert_array_equal(im, i1, err_msg=f"n={n} row {i}")
            np.testing.assert_array_equal(vm, v1, err_msg=f"n={n} row {i}")


def test_sparse_rejects_giant_shapes():
    """transfer_mode routes giant shapes dense; the sparse entry points
    enforce that themselves instead of trusting every caller."""
    from wavelet_tpu.runtime import mesh as mesh_lib

    import jax

    mesh = mesh_lib.data_mesh(jax.devices("cpu")[:4])
    eng = engine.CodecEngine(mesh=mesh, giant_box_bytes=1024)
    dims = (16, 8, 8)
    assert eng.giant_ok(dims)
    assert eng.transfer_mode(dims, "sparse") == "dense"
    item = batching.WorkItem(0, 0, 0, 0)
    arr = np.zeros(dims, np.float32)
    [batch] = batching.plan_batches([(item, arr)],
                                    pad_fn=eng.pad_multiple_for)
    with pytest.raises(ValueError, match="giant"):
        eng.compress_shapebatch_sparse(batch, 0.999)
    with pytest.raises(ValueError, match="giant"):
        eng.decompress_shapebatch_sparse(
            batch, np.zeros((1, 128), np.int32),
            np.zeros((1, 128), np.float32))
