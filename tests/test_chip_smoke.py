"""chip_smoke.py's generator and checks, rehearsed on the CPU at a tiny
size (the real run needs a GPU and a >= 1 GiB dataset)."""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

# 32^3 level 0, one 32^3 box at level 1, eight at level 2
TINY = {"base_dims": (32, 32, 32), "fractions": (0.5, 0.5), "min_bytes": 0,
        "min_oracle_boxes": 8, "stage_shape": (4, 16)}
# 40^3 level 0 and a 40^3 level 1 (32- and 8-wide boxes), 64^3 level 2:
# giant and data-parallel boxes on the 4-device mesh
TINY_MIXED = dict(TINY, base_dims=(40, 40, 40), fractions=(0.5, 0.4))


def test_one_card_path_passes_every_check(tmp_path, capsys):
    check = chip_smoke.Checks()
    chip_smoke.one_card(str(tmp_path), 0, TINY, check)
    out = capsys.readouterr().out
    assert check.failed == [], out[-3000:]
    for name in ("-c keep=0.999", "-d", "-c transfer=sparse",
                 "-d transfer=sparse",
                 "-c thresholdmode=global keepfraction=0.01"):
        assert f'"phase": "{name}"' in out, name
    assert out.count("CHECK PASS") >= 10


def test_four_cards_path_matches_one_card(tmp_path, capsys):
    import jax

    assert len(jax.devices()) >= 4
    check = chip_smoke.Checks()
    chip_smoke.four_cards(str(tmp_path), 0, TINY_MIXED, check)
    out = capsys.readouterr().out
    assert check.failed == [], out[-3000:]
    assert out.count("byte-identical to 1-card") == 3
    assert "CHECK PASS 4-card run has giant and data-parallel boxes" in out


def test_four_cards_dataset_mixes_giant_and_mesh_boxes():
    """The --four-cards dataset keeps the full dataset's box shapes, so
    both the giant path and the data mesh run on the cards."""
    from wavelet_tpu.io import synth

    shapes = {}
    for name in ("FULL", "FOUR_CARDS"):
        cfg = getattr(chip_smoke, name)
        layout = synth.amr_layout(cfg["base_dims"], cfg["fractions"],
                                  seed=0)
        shapes[name] = {tuple(d) for lev in layout.dimensions for d in lev}
    assert shapes["FOUR_CARDS"] == shapes["FULL"]
    sizes = {int(np.prod(s)) * 4 for s in shapes["FOUR_CARDS"]}
    assert min(sizes) < chip_smoke.GIANT_BYTES <= max(sizes)


def test_main_refuses_without_gpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert "needs a GPU" in out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_sample_boxes_cover_levels_and_components():
    from wavelet_tpu.io import synth

    layout = synth.amr_layout(chip_smoke.FULL["base_dims"],
                              chip_smoke.FULL["fractions"], seed=0)
    samples = chip_smoke.sample_boxes(layout, 0)
    assert {lev for lev, _b, _c in samples} == {0, 1, 2}
    assert {c for _l, _b, c in samples} == set(range(4))
    assert len(samples) >= chip_smoke.FULL["min_oracle_boxes"]
    for lev, box, _c in samples:
        assert 0 <= box < len(layout.dimensions[lev])
    # the full dataset is the one the contract asks for
    assert (layout.cells() * len(chip_smoke.COMPONENTS) * 4
            >= chip_smoke.FULL["min_bytes"])


def test_oracle_check_catches_a_corrupted_payload(tmp_path, capsys):
    """Mutation check: one archived coefficient changed must fail the
    payload comparison."""
    from wavelet_tpu.io import archive

    data = str(tmp_path / "data")
    layout, paths = chip_smoke.make_dataset(data, 0, (16, 16, 16), (0.5,),
                                            times=(0.0,))
    comp = str(tmp_path / "c") + os.sep
    chip_smoke.cli([f"datadir={data}", "minfile=plt00100",
                    "maxfile=plt00100", "minlevel=0", "maxlevel=1",
                    "components=" + " ".join(chip_smoke.COMPONENTS),
                    "keep=0.999", f"compresseddir={comp}", "-c"])
    samples = [(0, 0, 0)]
    name = os.path.join(comp, archive.payload_filename(0, 0, 0, 0))
    blob = archive.decode_blob(open(name, "rb").read(), "xz")
    shape, _total, runs, vals = archive.deserialize_payload(blob)
    vals = vals.copy()
    vals[0] = np.float32(vals[0] + 1.0)
    with open(name, "wb") as f:
        f.write(archive.encode_blob(
            archive.serialize_payload(shape, runs, vals), "xz", 6))
    check = chip_smoke.Checks()
    chip_smoke.oracle_checks(check, paths, samples, comp, None, keep=0.999,
                             min_boxes=1)
    assert check.failed and "archived payload" in capsys.readouterr().out


def test_tree_digest_sees_any_byte(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "f").write_bytes(b"xyz")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    assert chip_smoke.tree_digest(str(tmp_path / "a")) == \
        chip_smoke.tree_digest(str(tmp_path / "b"))
    (tmp_path / "b" / "f").write_bytes(b"xyZ")
    assert chip_smoke.tree_digest(str(tmp_path / "a")) != \
        chip_smoke.tree_digest(str(tmp_path / "b"))
