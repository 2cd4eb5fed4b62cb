"""Regression tests for round-2 advisor findings (ADVICE.md) and judge
items (VERDICT.md): RLE malformed-payload backend agreement, truncated
sidecar error handling, histogram overflow safety, and the unified
device/host global-threshold selection."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from wavelet_tpu.core import rle
from wavelet_tpu.core import threshold as thr
from wavelet_tpu.io import archive
from wavelet_tpu import native


# ---------------------------------------------------------------------------
# ADVICE: rle_decode must replicate the reference's skip-increment semantics
# (decompressor.cpp:14-30) so the python and native backends agree on
# malformed payloads
# ---------------------------------------------------------------------------

def _reference_decode(pairs, total):
    """Literal transcription of decompressor.cpp:14-30 (+ the >=0 lower
    bound both our backends add)."""
    out = np.zeros(total, dtype=np.float32)
    idx = 0
    for run, val in pairs:
        idx += run
        if 0 <= idx < total:
            out[idx] = val
            idx += 1
    return out


@pytest.mark.parametrize("pairs,total", [
    ([(2, 1.0), (100, 2.0), (0, 3.0)], 8),     # overflow mid-stream
    ([(5, 1.0), (-3, 2.0), (0, 3.0)], 8),      # negative run, in range
    ([(-9, 1.0), (0, 2.0)], 4),                # negative position
    ([(3, 1.0), (3, 2.0), (3, 3.0)], 6),       # overflow, then stuck
    ([(0, 1.0), (0, 2.0)], 2),                 # well-formed fast path
])
def test_rle_decode_matches_reference_on_malformed(pairs, total):
    runs = np.array([p[0] for p in pairs], np.int32)
    vals = np.array([p[1] for p in pairs], np.float32)
    got = rle.rle_decode(runs, vals, total)
    np.testing.assert_array_equal(got, _reference_decode(pairs, total))


@pytest.mark.skipif(not native.available(), reason="native codec not built")
@pytest.mark.parametrize("pairs,total", [
    ([(2, 1.0), (100, 2.0), (0, 3.0)], 8),
    ([(5, 1.0), (-3, 2.0), (0, 3.0)], 8),
    ([(-9, 1.0), (0, 2.0)], 4),
    ([(3, 1.0), (3, 2.0), (3, 3.0)], 6),
])
def test_native_and_python_agree_on_malformed_payload(tmp_path, pairs, total):
    """Write a payload with corrupt runs; both backends must reconstruct
    identical data."""
    runs = np.array([p[0] for p in pairs], np.int32)
    vals = np.array([p[1] for p in pairs], np.float32)
    shape = (total, 1, 1)
    blob = archive.xz_compress(archive.serialize_payload(shape, runs, vals))
    path = str(tmp_path / "corrupt.xz")
    with open(path, "wb") as f:
        f.write(blob)

    py = rle.rle_decode(runs, vals, total)
    out, shapes = native.unpack_batch([path], total)
    np.testing.assert_array_equal(out[0], py)


# ---------------------------------------------------------------------------
# ADVICE: truncated sidecars must raise ValueError (clean CLI error), not
# StopIteration / IndexError / struct.error
# ---------------------------------------------------------------------------

def test_truncated_boxcounts_raises_valueerror(tmp_path):
    archive.write_boxcounts([[2, 1], [2, 1]], str(tmp_path))
    p = os.path.join(str(tmp_path), "boxcounts.raw")
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[:4])  # 1 of 4 counts
    with pytest.raises(ValueError, match="boxcounts"):
        archive.read_boxcounts(str(tmp_path), 2, 2)


def test_truncated_locations_raises_valueerror(tmp_path):
    locs = [[[(0, 0, 0), (8, 0, 0)]]]
    archive.write_locdim(locs, str(tmp_path), "locations.raw")
    p = os.path.join(str(tmp_path), "locations.raw")
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[:8])
    with pytest.raises(ValueError, match="locations"):
        archive.read_locdim(str(tmp_path), "locations.raw", [[2]])


def test_truncated_runinfo_raises_valueerror(tmp_path):
    info = archive.RunInfo(["plt1", "plt2"], 0, 1, ["temp"], [0])
    archive.write_runinfo(info, str(tmp_path))
    p = os.path.join(str(tmp_path), "runinfo.raw")
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="runinfo"):
        archive.read_runinfo(str(tmp_path))


def test_truncated_amrexinfo_raises_valueerror(tmp_path):
    info = archive.AMReXInfo([[0., 0., 0., 1., 1., 1.]], [2], ["0.5"],
                             [[7]], 8, 8, 8)
    archive.write_amrexinfo(info, str(tmp_path))
    p = os.path.join(str(tmp_path), "amrexinfo.raw")
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[:20])
    with pytest.raises(ValueError, match="amrexinfo"):
        archive.read_amrexinfo(str(tmp_path))


# ---------------------------------------------------------------------------
# VERDICT: int64-safe histogram all-reduce across processes
# ---------------------------------------------------------------------------

def test_histogram_allreduce_is_int64_safe():
    """The two-limb int32 gather must survive counts past 2^31 (a plain
    int32 gather would wrap negative)."""
    from wavelet_tpu.pipeline.compress import _allreduce_histogram

    hist = np.zeros(thr.EXP_HIST_BINS, np.int64)
    hist[100] = (1 << 33) + 12345     # > int32 range
    hist[200] = 7
    out = _allreduce_histogram(hist)  # single process: identity
    np.testing.assert_array_equal(out, hist)


def test_abs_exponent_histogram_is_uint32():
    h = thr.abs_exponent_histogram(jnp.asarray(np.ones(16, np.float32)))
    assert h.dtype == jnp.uint32
    assert int(np.asarray(h).sum()) == 16


# ---------------------------------------------------------------------------
# payload codec extension: codec=raw and xzpreset=N (host-pack bottleneck
# relief)
# ---------------------------------------------------------------------------

def _codec_synth(tmp_path):
    from wavelet_tpu.io import plotfile as pf

    rng = np.random.default_rng(4)
    smooth = np.fromfunction(
        lambda i, j, k: np.sin(0.2 * i) + 0.1 * j * k, (16, 8, 8)
    ).astype(np.float32)
    noisy = (smooth + 0.05 * rng.standard_normal(smooth.shape)
             ).astype(np.float32)
    pf.write_plotfile(str(tmp_path / "data" / "plt00030"),
                      [[np.stack([smooth, noisy])]], [[(0, 0, 0)]],
                      [[(16, 8, 8)]], ["a", "b"], 0.5, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (16, 8, 8), [30])
    return str(tmp_path / "data")


@pytest.mark.parametrize("extra", [
    {"codec": "raw"},
    {"xz_preset": 1},
], ids=["raw", "xz1"])
def test_codec_extension_roundtrip(tmp_path, extra):
    from wavelet_tpu.io import plotfile as pf
    from wavelet_tpu.pipeline import (Config, compress_run, decompress_run)

    data_dir = _codec_synth(tmp_path)
    comp_dir = str(tmp_path / "comp") + os.sep
    out_dir = str(tmp_path / "out") + os.sep
    cfg = Config(data_dir=data_dir, min_time="plt00030", max_time="plt00030",
                 min_level=0, max_level=0, components=["a", "b"],
                 keep=0.999, compressed_dir=comp_dir, **extra)
    compress_run(cfg)
    meta = archive.read_meta(comp_dir)
    assert meta["codec"] == extra.get("codec", "xz")
    assert meta["xz_preset"] == extra.get("xz_preset", 6)
    # decompression is self-describing via the meta sidecar
    decompress_run(Config(compressed_dir=comp_dir, out_dir=out_dir))
    orig = pf.read_level(data_dir + "/plt00030", 0, [0, 1])
    regen = pf.read_level(out_dir + "plt00030", 0, [0, 1])
    # keep=0.999 on smooth+noise: reconstruction within lossy tolerance,
    # and identical to what the default-codec pipeline produces
    assert np.abs(regen.boxes[0] - orig.boxes[0]).mean() < 0.05


def test_raw_codec_native_python_identical(tmp_path):
    """codec=raw bytes from the native packer == python packer."""
    from wavelet_tpu.runtime import batching, engine as eng_mod

    rng = np.random.default_rng(9)
    flat = np.zeros((4, 512), np.float32)
    for i in range(4):
        idx = rng.choice(512, 20, replace=False)
        flat[i, idx] = rng.standard_normal(20)
    t32 = np.zeros(4, np.float32)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(4)]
    batch = batching.ShapeBatch(shape=(8, 8, 8), data=flat.reshape(4, 8, 8, 8),
                                items=items, n_valid=4)
    outs = {}
    for use_native in ((True, False) if native.available() else (False,)):
        d = tmp_path / ("n" if use_native else "p")
        os.makedirs(d)
        packer = eng_mod.HostPacker(use_native=use_native, codec="raw")
        packer.pack(str(d), batch, t32)
        outs[use_native] = {f: open(os.path.join(d, f), "rb").read()
                            for f in sorted(os.listdir(d))}
    if len(outs) == 2:
        assert outs[True] == outs[False]
    # raw blobs are the CRC32-framed serialized payload (no xz stream)
    blob = next(iter(outs[False].values()))
    assert not blob.startswith(b"\xfd7zXZ")
    assert blob.startswith(b"WTCR")
    payload = archive.decode_blob(blob, "raw")
    shape, total, runs, vals = archive.deserialize_payload(payload)
    assert shape == (8, 8, 8) and total == 512
    # a flipped payload byte must fail the CRC, in BOTH backends
    bad = bytearray(blob)
    bad[-1] ^= 0x40
    with pytest.raises(ValueError, match="CRC mismatch"):
        archive.decode_blob(bytes(bad), "raw")
    # legacy frameless raw members (round-2 archives) still decode
    assert archive.decode_blob(payload, "raw") == payload


def test_xz_delta_filter_end_to_end(tmp_path):
    """xzdelta=8 (delta filter at the 8-byte pair stride): smaller archives
    on smooth-field data, byte-identical across backends, and decompression
    needs NO knob — the xz stream declares its own filter chain."""
    from wavelet_tpu.pipeline import Config, compress_run, decompress_run
    from wavelet_tpu.runtime import batching, engine as eng_mod

    from wavelet_tpu.io import plotfile as pf2

    # a substantial smooth box: the delta win comes from correlated float
    # bit patterns and needs enough kept pairs to beat the filter-chain
    # header overhead (tiny payloads don't)
    d = 32
    smooth_big = np.fromfunction(
        lambda i, j, k: np.sin(0.1 * i) * np.cos(0.07 * j) + 0.01 * k,
        (d, d, d)).astype(np.float32)
    pf2.write_plotfile(str(tmp_path / "bigdata" / "plt00031"),
                       [[smooth_big[None]]], [[(0, 0, 0)]], [[(d, d, d)]],
                       ["a"], 0.5, [0., 0., 0.], [1., 1., 1.], (2, 2, 2),
                       (d, d, d), [31])
    sizes = {}
    for name, delta in (("plain", 0), ("delta", 8)):
        comp = str(tmp_path / name) + "/"
        compress_run(Config(data_dir=str(tmp_path / "bigdata"),
                            min_time="plt00031", max_time="plt00031",
                            min_level=0, max_level=0,
                            components=["a"], keep=0.9,
                            compressed_dir=comp, xz_delta=delta))
        sizes[name] = sum(
            os.path.getsize(os.path.join(comp, f))
            for f in os.listdir(comp) if f.endswith(".xz"))
        out = str(tmp_path / f"out_{name}") + "/"
        decompress_run(Config(compressed_dir=comp, out_dir=out))
        assert os.path.isdir(os.path.join(out, "plt00031"))
    assert sizes["delta"] < 0.7 * sizes["plain"]   # smooth data: delta wins

    # both backends must produce identical delta-filtered bytes
    smooth = np.fromfunction(
        lambda n, i, j, k: np.sin(0.2 * i) + 0.1 * j * k + 0 * n,
        (4, 8, 8, 8)).astype(np.float32)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(4)]
    batch = batching.ShapeBatch(shape=(8, 8, 8), data=smooth,
                                items=items, n_valid=4)
    t32 = np.full(4, np.float32(0.01))
    outs = {}
    for use_native in ((True, False) if native.available() else (False,)):
        d = tmp_path / ("dn" if use_native else "dp")
        os.makedirs(d)
        packer = eng_mod.HostPacker(use_native=use_native, xz_delta=8)
        packer.pack(str(d), batch, t32)
        # xz container framing differs slightly between liblzma and the
        # python module (block-header size fields) for EVERY xz flavor —
        # the compatibility property is payload equality after a generic
        # decode, same as the plain-xz backend tests
        outs[use_native] = {
            f: archive.xz_decompress(
                open(os.path.join(d, f), "rb").read())
            for f in sorted(os.listdir(d))}
    if len(outs) == 2:
        assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# fast in-memory estimate (fastestimate=1): identical numbers, no scratch dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {},
    {"threshold_mode": "global", "keep_fraction": 0.1},
    {"payload": "q16"},
    {"codec": "raw"},
    {"scales": 2},
    {"scales": 2, "threshold_mode": "global", "keep_fraction": 0.1},
    # bundle: the fast path must model the .wtb container's exact
    # magic+index+trailer overhead, not just sum blob lengths
    {"archive": "bundle", "codec": "raw"},
], ids=["box", "global", "q16", "raw", "scales2", "scales2_global",
        "bundle_raw"])
def test_fast_estimate_matches_disk_estimate(tmp_path, extra):
    from wavelet_tpu.pipeline import Config, estimate_run

    data_dir = _codec_synth(tmp_path)
    base = dict(data_dir=data_dir, min_time="plt00030", max_time="plt00030",
                min_level=0, max_level=0, components=["a", "b"], keep=0.99,
                **extra)
    slow = estimate_run(Config(**base))
    fast = estimate_run(Config(fast_estimate=True, **base))
    for name in ("a", "b"):
        assert fast["components"][name]["rmse"] == \
            slow["components"][name]["rmse"]
        assert fast["components"][name]["adjusted_loss"] == \
            slow["components"][name]["adjusted_loss"]
    # sizes agree modulo xz container framing: the disk path's native
    # liblzma writes slightly different (larger) block headers than
    # python's lzma — a few bytes per item, same payload (cf.
    # test_native.py::test_packer_backends_byte_identical)
    assert fast["compressed_size_pct"] == pytest.approx(
        slow["compressed_size_pct"], rel=2e-2)


def test_cli_fastestimate_key():
    from wavelet_tpu import cli

    mode, cfg = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'minlevel=0', 'components=x',
        'keep=0.999', 'fastestimate=1', '-estimate'])
    assert mode == "estimate" and cfg.fast_estimate


# ---------------------------------------------------------------------------
# keep sweep (keep="k1 k2 ...") in estimate mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["scratch", "fast"])
def test_estimate_keep_sweep_matches_individual_runs(tmp_path, fast):
    """One invocation sweeping three keeps must report exactly the numbers
    three independent runs report (the fast path shares the forward — the
    signed absmax is keep-independent)."""
    from wavelet_tpu.pipeline import Config, estimate_run

    data_dir = _codec_synth(tmp_path)
    keeps = [0.99, 0.999, 0.9999]
    base = dict(data_dir=data_dir, min_time="plt00030", max_time="plt00030",
                min_level=0, max_level=0, components=["a", "b"],
                fast_estimate=fast)
    swept = estimate_run(Config(keep=keeps[0], keep_sweep=keeps, **base))
    assert set(swept["keep_sweep"]) == {repr(k) for k in keeps}
    for k in keeps:
        single = estimate_run(Config(keep=k, **base))
        got = swept["keep_sweep"][repr(k)]
        assert got == single


@pytest.mark.parametrize("fast", [False, True], ids=["scratch", "fast"])
def test_estimate_keepfraction_sweep_matches_individual_runs(tmp_path,
                                                             fast):
    """Global-mode sweep: one invocation over several keep fractions must
    match individual runs (the fast path shares the forward + histogram,
    which are fraction-independent)."""
    from wavelet_tpu.pipeline import Config, estimate_run

    data_dir = _codec_synth(tmp_path)
    fracs = [0.02, 0.1]
    base = dict(data_dir=data_dir, min_time="plt00030", max_time="plt00030",
                min_level=0, max_level=0, components=["a", "b"],
                keep=0.999, threshold_mode="global", fast_estimate=fast)
    swept = estimate_run(Config(keep_fraction=fracs[0],
                                keep_fraction_sweep=fracs, **base))
    assert set(swept["keep_fraction_sweep"]) == {repr(f) for f in fracs}
    for f in fracs:
        single = estimate_run(Config(keep_fraction=f, **base))
        got = swept["keep_fraction_sweep"][repr(f)]
        assert got["components"] == single["components"]
        assert got["compressed_size_pct"] == single["compressed_size_pct"]


def test_cli_keep_sweep_parsing():
    from wavelet_tpu import cli

    mode, cfg = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'minlevel=0', 'components=x',
        'keep=0.99 0.999 0.9999', '-estimate'])
    assert mode == "estimate"
    assert cfg.keep_sweep == [0.99, 0.999, 0.9999]
    assert cfg.keep == 0.99
    # single keep: no sweep
    _mode, cfg1 = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'minlevel=0', 'components=x',
        'keep=0.999', '-estimate'])
    assert cfg1.keep_sweep is None and cfg1.keep == 0.999
    # a compression run writes one archive at one keep
    with pytest.raises(SystemExit):
        cli.parse_argv([
            'datadir=/d', 'minfile=a1', 'maxfile=a2', 'minlevel=0',
            'maxlevel=0', 'components=x', 'keep=0.99 0.999',
            'compresseddir=/c/', '-c'])
    # global mode thresholds by keepfraction: a sweep there is a clean
    # error, not a float() traceback
    with pytest.raises(SystemExit, match="box threshold mode"):
        cli.parse_argv([
            'datadir=/d', 'minfile=a1', 'minlevel=0', 'components=x',
            'thresholdmode=global', 'keepfraction=0.02',
            'keep=0.99 0.999', '-estimate'])
    # ...but a KEEPFRACTION sweep is the global-mode equivalent
    _m, cfg2 = cli.parse_argv([
        'datadir=/d', 'minfile=a1', 'minlevel=0', 'components=x',
        'thresholdmode=global', 'keepfraction=0.02 0.1', '-estimate'])
    assert cfg2.keep_fraction_sweep == [0.02, 0.1]
    assert cfg2.keep_fraction == 0.02
    with pytest.raises(SystemExit, match="only valid with -estimate"):
        cli.parse_argv([
            'datadir=/d', 'minfile=a1', 'maxfile=a2', 'minlevel=0',
            'maxlevel=0', 'components=x', 'thresholdmode=global',
            'keepfraction=0.02 0.1', 'compresseddir=/c/', '-c'])


# ---------------------------------------------------------------------------
# code-review round-2 regressions
# ---------------------------------------------------------------------------

def test_x_block_never_one_for_even_x():
    """The forward transforms along X at every even X, including X=2 (one
    pair): bitwise equal to the oracle, batched."""
    from wavelet_tpu.core import haar, oracle

    rng = np.random.default_rng(4)
    for dims in ((2, 8, 8), (4, 2, 6), (64, 4, 2), (6, 10, 14)):
        boxes = rng.standard_normal((3,) + dims).astype(np.float32)
        got = np.asarray(haar.forward_flat(jnp.asarray(boxes)))
        for i in range(3):
            np.testing.assert_array_equal(
                got[i].view(np.int32),
                oracle.haar_forward_oracle(boxes[i]).view(np.int32))


def test_interleaved_bitwise_at_forced_two_row_blocks():
    """The plain interleaved stencil run on separate two-row X blocks (as
    the giant-box shards run it) must still transform along X and equal
    the oracle after the layout permutation."""
    from wavelet_tpu.core import interleave, oracle

    rng = np.random.default_rng(3)
    x, y, z = 4, 64, 64
    box = rng.standard_normal((x, y, z)).astype(np.float32)
    blocks = [np.asarray(interleave.forward_block(jnp.asarray(box[i:i + 2])))
              for i in range(0, x, 2)]
    whole = np.asarray(interleave.forward_block(jnp.asarray(box)))
    # the X pass pairs rows within each block, so blocking changes only the
    # Y/Z-independent X pairing, which is block-local for 2-row blocks
    np.testing.assert_array_equal(np.concatenate(blocks).view(np.int32),
                                  whole.view(np.int32))
    px, py, pz = (interleave.interleave_perm(v) for v in (x, y, z))
    want = oracle.haar_forward_oracle(box).reshape(x, y, z)
    np.testing.assert_array_equal(
        whole[np.ix_(px, py, pz)].view(np.int32), want.view(np.int32))


def test_device_threshold_integer_boundary_matches_host():
    """keep_fraction*total just below an integer count (e.g. 0.29*100 =
    28.9999...): the device compare must floor like the host's int-vs-f64
    compare, not round the target up to 29.0 (regression)."""
    for kf, total, top in ((0.29, 100, 29), (0.57, 100, 57),
                           (0.57, 300, 171), (0.5, 58, 29)):
        hist = np.zeros(thr.EXP_HIST_BINS, np.int64)
        hist[100] = total - top
        hist[200] = top              # above[101..200] == top, the boundary
        t_host = thr.threshold_from_histogram(hist, kf)
        t_dev = thr.threshold_from_histogram_device(
            jnp.asarray(hist.astype(np.uint32)), kf, total)
        assert np.float32(t_host).tobytes() == \
            np.asarray(t_dev, np.float32).tobytes(), (kf, total)
