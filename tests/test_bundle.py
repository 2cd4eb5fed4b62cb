"""Bundled-archive container mode (``archive=bundle``, io/bundle.py).

The bundle is a pure container change: member payload bytes are identical
to the per-file mode's ``.xz`` outputs, so every mode (box/global, dense/
sparse transfer, f32/q16, xz/raw, multi-scale) must round-trip identically
through it; these tests pin that, plus the container's own durability
properties (atomic close, resume generations, corrupt-member detection).
"""

import glob
import os

import numpy as np
import pytest

from conftest import FIXTURES, fixture
from wavelet_tpu.io import archive, bundle
from wavelet_tpu.pipeline import Config, compress_run, decompress_run
from wavelet_tpu.pipeline.check import check_run

PLT74 = fixture("plt00074")


# ---------------------------------------------------------------------------
# container unit tests
# ---------------------------------------------------------------------------

def test_bundle_writer_reader_roundtrip(tmp_path):
    path = str(tmp_path / bundle.bundle_name(0, 0))
    w = bundle.BundleWriter(path)
    blobs = {(0, 0, 0, 0): b"alpha", (0, 1, 2, 3): b"beta-beta",
             (0, 0, 5, 1): b""}
    for (t, lv, c, b), blob in blobs.items():
        w.add(t, lv, c, b, blob)
    assert not os.path.exists(path)          # invisible until closed
    total = w.close()
    assert os.path.exists(path) and total == os.path.getsize(path)

    bs = bundle.BundleSet(str(tmp_path))
    assert len(bs) == 3
    for key, blob in blobs.items():
        assert bs.blob(*key) == blob
    with pytest.raises(FileNotFoundError):
        bs.blob(9, 9, 9, 9)


def test_bundle_generation_wins_member_collision(tmp_path):
    """Ordering is by parsed (t, p, g), not lexicographic — '-g1' would
    sort before its base name — so a generation's member shadows the
    base's on a key collision."""
    w = bundle.BundleWriter(str(tmp_path / bundle.bundle_name(0, 0)))
    w.add(0, 0, 0, 0, b"old")
    w.close()
    w = bundle.BundleWriter(
        str(tmp_path / bundle.bundle_name(0, 0, generation=1)))
    w.add(0, 0, 0, 0, b"new")
    w.close()
    assert bundle.list_bundles(str(tmp_path)) == [
        bundle.bundle_name(0, 0), bundle.bundle_name(0, 0, generation=1)]
    assert bundle.BundleSet(str(tmp_path)).blob(0, 0, 0, 0) == b"new"


def test_bundle_empty_writer_leaves_nothing(tmp_path):
    w = bundle.BundleWriter(str(tmp_path / bundle.bundle_name(1, 0)))
    assert w.close() == 0
    assert os.listdir(tmp_path) == []


def test_bundle_abort_removes_tmp(tmp_path):
    w = bundle.BundleWriter(str(tmp_path / bundle.bundle_name(0, 0)))
    w.add(0, 0, 0, 0, b"x")
    w.abort()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("damage", ["truncate", "magic", "trailer"])
def test_bundle_malformed_container_raises(tmp_path, damage):
    path = str(tmp_path / bundle.bundle_name(0, 0))
    w = bundle.BundleWriter(path)
    w.add(0, 0, 0, 0, b"payload-bytes")
    w.close()
    data = bytearray(open(path, "rb").read())
    if damage == "truncate":
        data = data[:-9]
    elif damage == "magic":
        data[:4] = b"XXXX"
    else:
        data[-4:] = b"YYYY"
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError):
        bundle.read_index(path)


def test_bundle_in_flight_tmp_invisible(tmp_path):
    w = bundle.BundleWriter(str(tmp_path / bundle.bundle_name(0, 0)))
    w.add(0, 0, 0, 0, b"x")
    # not closed: list_bundles must not surface the .tmp
    assert bundle.list_bundles(str(tmp_path)) == []
    w.abort()


# ---------------------------------------------------------------------------
# pipeline round trips
# ---------------------------------------------------------------------------

def _dirs_identical(p1, p2):
    import filecmp

    for root, _dirs, names in os.walk(p1):
        rel = os.path.relpath(root, p1)
        for n in names:
            b = os.path.join(p2, rel, n)
            if not os.path.exists(b) or not filecmp.cmp(
                    os.path.join(root, n), b, shallow=False):
                return False
    return True


def test_bundle_roundtrip_byte_identical(tmp_path):
    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp, archive="bundle")
    stats = compress_run(cfg)
    assert stats["files"] == 16
    # no per-item files; one bundle per timestep; meta declares the layout
    assert glob.glob(os.path.join(comp, "compressed-wavelet-*")) == []
    names = bundle.list_bundles(comp)
    assert names == [bundle.bundle_name(0, 0), bundle.bundle_name(1, 0)]
    assert archive.read_meta(comp)["archive"] == "bundle"
    assert stats["output_bytes"] == sum(
        os.path.getsize(os.path.join(comp, n)) for n in names)

    decompress_run(Config(compressed_dir=comp, out_dir=out))
    for plt in ("plt00074", "plt00075"):
        assert _dirs_identical(fixture(plt), os.path.join(out, plt)), plt


def test_bundle_members_equal_per_file_bytes(tmp_path):
    """The container is a pure layout change: each member's bytes must be
    exactly what the per-file mode writes for the same item."""
    comp_f = str(tmp_path / "files") + os.sep
    comp_b = str(tmp_path / "bundle") + os.sep
    base = dict(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                min_level=0, max_level=1, components=["temp", "pressure"],
                keep=0.999)
    compress_run(Config(**base, compressed_dir=comp_f))
    compress_run(Config(**base, compressed_dir=comp_b, archive="bundle"))
    bs = bundle.BundleSet(comp_b)
    assert len(bs) == 16
    for (t, lv, c, b) in bs.keys():
        per_file = os.path.join(
            comp_f, archive.payload_filename(t, lv, c, b))
        with open(per_file, "rb") as f:
            assert f.read() == bs.blob(t, lv, c, b), (t, lv, c, b)


@pytest.mark.parametrize("extra", [
    {"codec": "raw"},
    {"codec": "raw", "transfer": "sparse"},
    {"payload": "q16"},
    {"scales": 2},
    {"threshold_mode": "global", "keep_fraction": 0.5},
])
def test_bundle_roundtrip_extension_modes(tmp_path, extra):
    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp, archive="bundle", **extra)
    compress_run(cfg)
    decompress_run(Config(compressed_dir=comp, out_dir=out))
    if extra.get("payload") == "q16":
        # quantized payloads are lossy on non-power-of-two values; just
        # require valid plotfiles with the right structure
        assert os.path.isdir(os.path.join(out, "plt00074"))
    else:
        for plt in ("plt00074", "plt00075"):
            assert _dirs_identical(fixture(plt),
                                   os.path.join(out, plt)), (plt, extra)


def test_bundle_python_backend_identical_bytes(tmp_path):
    """Native and python packers must agree on every bundle member.

    With ``codec=raw`` the container bytes are the payload itself, so the
    bundles must be byte-identical.  Under xz the two encoders (liblzma
    one-shot vs Python's lzma) emit slightly different — both valid —
    block headers (a pre-existing property of the per-file mode too), so
    there the *decoded payloads* must match."""
    import wavelet_tpu.runtime.engine as eng_mod

    base = dict(data_dir=FIXTURES, min_time="plt00074", max_time="plt00074",
                min_level=0, max_level=1, components=["temp", "pressure"],
                keep=0.999, archive="bundle")
    orig = eng_mod.HostPacker.__init__

    def no_native(self, *a, **kw):
        kw["use_native"] = False
        orig(self, *a, **kw)

    for codec in ("raw", "xz"):
        comp_n = str(tmp_path / f"native-{codec}") + os.sep
        comp_p = str(tmp_path / f"python-{codec}") + os.sep
        compress_run(Config(**base, compressed_dir=comp_n, codec=codec))
        eng_mod.HostPacker.__init__ = no_native
        try:
            compress_run(Config(**base, compressed_dir=comp_p, codec=codec))
        finally:
            eng_mod.HostPacker.__init__ = orig
        if codec == "raw":
            for name in bundle.list_bundles(comp_n):
                with open(os.path.join(comp_n, name), "rb") as a, \
                     open(os.path.join(comp_p, name), "rb") as b:
                    assert a.read() == b.read(), name
        else:
            bn, bp = bundle.BundleSet(comp_n), bundle.BundleSet(comp_p)
            assert set(bn.keys()) == set(bp.keys()) and len(bn) == 8
            for key in bn.keys():
                assert (archive.decode_blob(bn.blob(*key), "xz")
                        == archive.decode_blob(bp.blob(*key), "xz")), key


# ---------------------------------------------------------------------------
# resume + check
# ---------------------------------------------------------------------------

def test_bundle_resume_appends_generation(tmp_path):
    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp, archive="bundle")
    compress_run(cfg)
    # simulate a crash that lost timestep 1's bundle
    os.remove(os.path.join(comp, bundle.bundle_name(1, 0)))
    cfg.resume = True
    stats = compress_run(cfg)
    # only t=1's 8 items redone; t=0's members were found in the index
    assert stats["skipped"] == 8
    assert stats["files"] == 8
    # t=0's immutable bundle untouched; t=1 rewritten (no generation file —
    # its base name was free again)
    assert bundle.list_bundles(comp) == [bundle.bundle_name(0, 0),
                                         bundle.bundle_name(1, 0)]
    decompress_run(Config(compressed_dir=comp, out_dir=out))
    for plt in ("plt00074", "plt00075"):
        assert _dirs_identical(fixture(plt), os.path.join(out, plt)), plt


def test_bundle_resume_generation_when_base_exists(tmp_path):
    """A partially-complete timestep resumes into a -g1 generation file and
    readers merge both."""
    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp, archive="bundle")
    compress_run(cfg)
    # rewrite t=1's bundle keeping only its first 3 members (a partial run)
    full = os.path.join(comp, bundle.bundle_name(1, 0))
    entries = bundle.read_index(full)
    bs = bundle.BundleSet(comp)
    keep3 = entries[:3]
    blobs = {e[:4]: bs.blob(*e[:4]) for e in keep3}
    bs.close()
    os.remove(full)
    w = bundle.BundleWriter(full)
    for key, blob in blobs.items():
        w.add(*key, blob)
    w.close()

    cfg.resume = True
    stats = compress_run(cfg)
    assert stats["skipped"] == 8 + 3
    assert stats["files"] == 5
    assert bundle.bundle_name(1, 0, generation=1) in bundle.list_bundles(comp)
    decompress_run(Config(compressed_dir=comp, out_dir=out))
    for plt in ("plt00074", "plt00075"):
        assert _dirs_identical(fixture(plt), os.path.join(out, plt)), plt


def test_bundle_check_mode(tmp_path):
    comp = str(tmp_path / "comp") + os.sep
    cfg = Config(data_dir=FIXTURES, min_time="plt00074", max_time="plt00075",
                 min_level=0, max_level=1, components=["temp", "pressure"],
                 keep=0.999, compressed_dir=comp, archive="bundle")
    compress_run(cfg)
    result = check_run(Config(compressed_dir=comp))
    assert result["files"] == 16 and result["errors"] == []

    # corrupt one member's container bytes in place (xz CRC must fail)
    name = bundle.list_bundles(comp)[0]
    path = os.path.join(comp, name)
    entries = bundle.read_index(path)
    off, size = entries[0][4], entries[0][5]
    with open(path, "r+b") as f:
        f.seek(off + size // 2)
        f.write(b"\xff\xff\xff\xff")
    result = check_run(Config(compressed_dir=comp))
    assert len(result["errors"]) == 1
    assert "decode failed" in result["errors"][0]

    # a missing member (drop a whole bundle) is reported per item
    os.remove(path)
    result = check_run(Config(compressed_dir=comp))
    assert all("missing bundle member" in e for e in result["errors"])
    assert len(result["errors"]) == len(entries)


def test_bundle_cli_key(tmp_path):
    from wavelet_tpu import cli

    comp = str(tmp_path / "comp") + os.sep
    out = str(tmp_path / "out") + os.sep
    rc = cli.main([f"datadir={FIXTURES}", "minfile=plt00074",
                   "maxfile=plt00074", "minlevel=0", "maxlevel=0",
                   "components=temp pressure", "keep=0.999",
                   f"compresseddir={comp}", "archive=bundle", "-c"])
    assert rc == 0
    assert bundle.list_bundles(comp) == [bundle.bundle_name(0, 0)]
    rc = cli.main([f"compresseddir={comp}", "-check"])
    assert rc == 0
    rc = cli.main([f"compresseddir={comp}", f"out={out}", "-d"])
    assert rc == 0
