"""Chip smoke test: the codec's main path on one GPU, checked bitwise
against the scalar oracle.

    python chip_smoke.py                # one card, full-size dataset
    python chip_smoke.py --four-cards   # the 4-card path vs the 1-card run

It generates a seeded AMReX dataset (``--seed``): BASELINE.json config 3's
four components (density Temp pressure x_velocity), levels 0-2 at AMReX's
3-D defaults (``amr.ref_ratio`` 2, ``amr.blocking_factor`` 8,
``amr.max_grid_size`` 32), over 1 GiB of float32 cells per timestep, two
timesteps, written as real plotfiles.  Then, in this one process (a second
JAX process could not open the card), through the CLI and API entry points:

- ``-c keep=0.999``, ``-d``, ``-estimate`` on level 0 (host and device
  RMSE),
  ``-c thresholdmode=global keepfraction=0.01``, ``-c transfer=sparse``
  and ``-d transfer=sparse``, each timed with compilation split out;
- for at least 64 boxes per timestep across every level and component:
  coefficients, kept set, archived payload and decompressed cells against
  core/oracle.py, bitwise (every step is an add or a multiply by 0.5);
- sparse archives and plotfiles byte-identical to dense ones; device RMSE
  within 1e-6 relative of the double-accumulation estimator; a
  constant-box plotfile regenerated byte for byte;
- the compact and scatter stage rates behind ``transfer=auto``.

``--four-cards`` runs only the multi-card path: ``-c devices=4`` with
``giantbox`` lowered so the largest (32^3) boxes take the X-sharded giant
path while the smaller ones shard over the 4-card data mesh,
``thresholdmode=global`` (its histogram psum crosses the cards) and
``-d devices=4``, each compared byte for byte with the 1-card run.  Its
dataset is cut to 0.14 GiB per timestep (a 64^3 level 0; same components,
levels, AMR defaults and box shapes): the giant path transforms one box
at a time across the cards, so at full size the 4-card phases would take
about eight times their 1/8-size wall, and four cards are charged four
times over.  The check is byte identity, which every box shape of the
full dataset exercises at this size.

The last line of standard output is one JSON object, printed only when
every check passed; the script exits non-zero otherwise, and when JAX
finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

COMPONENTS = ["density", "Temp", "pressure", "x_velocity"]
GIB = 1 << 30
# level-0 domain, then per-level refined-region fractions: 128^3 + 200^3 +
# 392^3 cells = 70.3M cells, x 4 components x 4 B = 1.05 GiB per timestep.
# 24 sampled boxes per level = 72 oracle boxes per timestep.  The stage
# rates run at 128 x 64^3 (bench.sparse_stages).
FULL = {"base_dims": (128, 128, 128), "fractions": (0.8, 0.77),
        "min_bytes": GIB, "min_oracle_boxes": 64, "stage_shape": (128, 64)}
# --four-cards: a 64^3 level 0 with the same {8, 32}^3 box shapes (64^3 +
# 104^3 + 200^3 cells, 0.14 GiB per timestep); see the module docstring
FOUR_CARDS = dict(FULL, base_dims=(64, 64, 64), fractions=(0.85, 0.8),
                  min_bytes=0)
# 32^3 float32 boxes (128 KiB) and up take the giant path on 4 cards
GIANT_BYTES = 32 ** 3 * 4
TIMES = (0.0, 0.5)
SAMPLES_PER_LEVEL = 24


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Sums JAX's compile-event durations, so each phase's compile time can
    be split from its steady time."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


@contextlib.contextmanager
def phase(name: str, clock: CompileClock, nbytes: int | None = None):
    """Time one phase; print its wall, compile and steady seconds (and the
    input rate when ``nbytes`` is given)."""
    c0, t0 = clock.seconds, time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    comp = clock.seconds - c0
    line = {"phase": name, "wall_s": wall, "compile_s": comp,
            "steady_s": wall - comp}
    if nbytes:
        line["input_gbps"] = nbytes / 1e9 / wall
    log("PHASE " + json.dumps(line))


def cli(args) -> None:
    """One in-process CLI invocation; any non-zero return fails the run."""
    from wavelet_tpu import cli as cli_mod

    rc = cli_mod.main(list(args))
    if rc != 0:
        raise RuntimeError(f"CLI {' '.join(args)} returned {rc}")


def tree_digest(root: str) -> dict:
    """{relative path: sha256} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


class Checks:
    """Collects named pass/fail results; printed as they happen."""

    def __init__(self):
        self.failed = []

    def __call__(self, name: str, ok: bool, detail: str = "") -> bool:
        log(f"CHECK {'PASS' if ok else 'FAIL'} {name}"
            + (f": {detail}" if detail else ""))
        if not ok:
            self.failed.append(name)
        return ok


def make_dataset(root: str, seed: int, base_dims, fractions, times=TIMES):
    """Write the seeded dataset; returns (layout, plotfile paths)."""
    from wavelet_tpu.io import synth

    layout = synth.amr_layout(base_dims, fractions, ref_ratio=2,
                              blocking_factor=8, max_grid_size=32, seed=seed)
    paths = synth.write_amr_dataset(root, layout, COMPONENTS, times,
                                    seed=seed)
    return layout, paths


def sample_boxes(layout, seed: int, per_level: int = SAMPLES_PER_LEVEL):
    """[(level, box, comp_idx)]: ``per_level`` boxes per level (all of a
    level's boxes if it has fewer), components cycling through all four,
    the level's first and last box always included (edge boxes are the
    ragged ones)."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for lev, dims in enumerate(layout.dimensions):
        n = len(dims)
        picks = sorted({0, n - 1} | set(rng.choice(
            n, size=min(per_level, n), replace=False).tolist()))
        for i, b in enumerate(picks):
            out.append((lev, int(b), i % len(COMPONENTS)))
    return out


def decoded_payload(comp_dir: str, t: int, lev: int, comp: int, box: int):
    """The archived coefficients of one item, decoded to a dense vector."""
    from wavelet_tpu.core import rle
    from wavelet_tpu.io import archive

    with open(os.path.join(comp_dir, archive.payload_filename(
            t, lev, comp, box)), "rb") as f:
        blob = f.read()
    _shape, total, runs, vals = archive.deserialize_payload(
        archive.decode_blob(blob, "xz"))
    return rle.rle_decode(runs, vals, total)


def oracle_checks(check: Checks, paths, samples, comp_dir: str,
                  out_dir: str | None, keep: float | None = None,
                  global_t: float | None = None, label: str = "",
                  min_boxes: int = 64) -> None:
    """For each sampled box of each timestep: the engine's coefficients and
    kept set, the archived payload and (with ``out_dir``) the decompressed
    cells against the oracle, all bitwise.  ``keep`` selects the per-box
    rule, ``global_t`` the global threshold."""
    from wavelet_tpu.core import oracle
    from wavelet_tpu.io import plotfile
    from wavelet_tpu.runtime import engine

    eng = engine.CodecEngine()
    for t, path in enumerate(paths):
        name = os.path.basename(path)
        by_level: dict = {}
        for lev, box, comp in samples:
            by_level.setdefault(lev, []).append((box, comp))
        bad = []
        n = 0
        for lev, picks in sorted(by_level.items()):
            orig = plotfile.read_level(path, lev, list(range(len(COMPONENTS))))
            regen = (plotfile.read_level(os.path.join(out_dir, name), lev,
                                         list(range(len(COMPONENTS))))
                     if out_dir else None)
            for box, comp in picks:
                n += 1
                cells = orig.boxes[box][comp]
                want = oracle.haar_forward_oracle(cells)
                got, t32 = eng.compress_batch_raw(cells[None], keep or 0.0)
                if global_t is not None:
                    t32 = np.full(1, global_t, np.float32)
                    mask_want = np.abs(want) > np.float32(global_t)
                else:
                    mask_want = oracle.threshold_oracle(want, keep)[0]
                masked = np.where(mask_want, want, np.float32(0.0))
                tag = (lev, box, COMPONENTS[comp])
                if not np.array_equal(got[0].view(np.int32),
                                      want.view(np.int32)):
                    bad.append((tag, "coefficients"))
                    continue
                if not np.array_equal(np.abs(got[0]) > t32[0], mask_want):
                    bad.append((tag, "kept set"))
                    continue
                payload = decoded_payload(comp_dir, t, lev, comp, box)
                if not np.array_equal(payload.view(np.int32),
                                      masked.view(np.int32)):
                    bad.append((tag, "archived payload"))
                    continue
                if regen is not None:
                    rec = oracle.haar_inverse_oracle(masked, *cells.shape)
                    if not np.array_equal(regen.boxes[box][comp].view(
                            np.int32), rec.view(np.int32)):
                        bad.append((tag, "decompressed cells"))
        levels = sorted(by_level)
        comps = sorted({c for _l, _b, c in samples})
        check(f"oracle {label} {name}", not bad and n >= min_boxes,
              f"{n} boxes, levels {levels}, components "
              f"{[COMPONENTS[c] for c in comps]}"
              + (f", mismatches {bad[:5]}" if bad else ""))


def constant_plotfile_check(check: Checks, work: str) -> None:
    """A constant-box plotfile regenerates byte-identically (constant
    boxes survive the lossy codec exactly)."""
    from wavelet_tpu.io import synth

    src = os.path.join(work, "const")
    synth.write_constant_fixture(src)
    comp = os.path.join(work, "const_c") + os.sep
    out = os.path.join(work, "const_d") + os.sep
    cli([f"datadir={src}", "minfile=plt00074", "maxfile=plt00075",
         "minlevel=0", "maxlevel=1", "components=temp pressure",
         "keep=0.999", f"compresseddir={comp}", "-c"])
    cli([f"compresseddir={comp}", f"out={out}", "-d"])
    same = all(tree_digest(os.path.join(src, p))
               == tree_digest(os.path.join(out, p))
               for p in ("plt00074", "plt00075"))
    check("constant plotfile regenerates byte-identically", same)


def rmse_check(check: Checks, data: str, paths, level: int = 0) -> None:
    """-estimate on one level (the estimator's unit): device RMSE
    (float32, summed in another order) within 1e-6 relative of the
    double-accumulation estimator, and the same compressed size."""
    import wavelet_tpu

    first = os.path.basename(paths[0])
    host = wavelet_tpu.estimate(data, min_time=first, components=COMPONENTS,
                                min_level=level, keep=0.999)
    dev = wavelet_tpu.estimate(data, min_time=first, components=COMPONENTS,
                               min_level=level, keep=0.999,
                               fast_estimate=True, device_metrics=True)
    worst = 0.0
    for c in COMPONENTS:
        a, b = host["components"][c]["rmse"], dev["components"][c]["rmse"]
        worst = max(worst, abs(a - b) / max(abs(a), 1e-300))
    log("ESTIMATE " + json.dumps({"host": host, "device": dev}))
    check("device RMSE vs double-accumulation estimator", worst <= 1e-6,
          f"worst relative difference {worst:.3e}")
    check("estimate compressed size (fast path == disk path)",
          host["compressed_size_pct"] == dev["compressed_size_pct"],
          f"{host['compressed_size_pct']} vs {dev['compressed_size_pct']}")


def same_tree(check: Checks, name: str, a: str, b: str) -> None:
    da, db = tree_digest(a), tree_digest(b)
    diff = sorted(k for k in set(da) | set(db) if da.get(k) != db.get(k))
    check(name, not diff and bool(da),
          f"{len(da)} files" + (f", differing {diff[:5]}" if diff else ""))


def one_card(work: str, seed: int, dataset: dict, check: Checks) -> None:
    import bench
    import wavelet_tpu

    clock = CompileClock()
    data = os.path.join(work, "data")
    with phase("generate dataset", clock):
        layout, paths = make_dataset(data, seed, dataset["base_dims"],
                                     dataset["fractions"])
    n_comp = len(COMPONENTS)
    per_t = layout.cells() * n_comp * 4
    total = per_t * len(paths)
    shapes = sorted({tuple(d) for lev in layout.dimensions for d in lev})
    log("DATASET " + json.dumps({
        "float32_bytes_per_timestep": per_t, "timesteps": len(paths),
        "boxes_per_timestep": layout.n_boxes(),
        "items_per_timestep": layout.n_boxes() * n_comp,
        "boxes_per_level": [len(d) for d in layout.dimensions],
        "shapes": [list(s) for s in shapes]}))
    check("dataset >= 1 GiB of float32 cells per timestep",
          per_t >= dataset["min_bytes"], f"{per_t / GIB:.3f} GiB")
    first, last = (os.path.basename(p) for p in (paths[0], paths[-1]))
    max_level = len(layout.dimensions) - 1
    base = [f"datadir={data}", f"minfile={first}", f"maxfile={last}",
            "minlevel=0", f"maxlevel={max_level}",
            "components=" + " ".join(COMPONENTS)]
    dirs = {k: os.path.join(work, k) + os.sep
            for k in ("c_dense", "d_dense", "c_global", "c_sparse",
                      "d_sparse")}
    samples = sample_boxes(layout, seed)

    with phase("-c keep=0.999", clock, total):
        cli(base + ["keep=0.999", f"compresseddir={dirs['c_dense']}", "-c"])
    with phase("-d", clock, total):
        cli([f"compresseddir={dirs['c_dense']}", f"out={dirs['d_dense']}",
             "-d"])
    with phase("oracle checks (dense)", clock):
        oracle_checks(check, paths, samples, dirs["c_dense"],
                      dirs["d_dense"], keep=0.999, label="keep=0.999",
                      min_boxes=dataset["min_oracle_boxes"])
    with phase("-estimate level 0 (host and device metrics)", clock):
        rmse_check(check, data, paths)
    with phase("-c thresholdmode=global keepfraction=0.01", clock, total):
        stats = wavelet_tpu.compress(
            data, dirs["c_global"], min_time=first, max_time=last,
            components=COMPONENTS, min_level=0, max_level=max_level,
            threshold_mode="global", keep_fraction=0.01)
    gt = float(stats["global_threshold"])
    log(f"global threshold {gt!r}")
    with phase("oracle checks (global)", clock):
        oracle_checks(check, paths, samples, dirs["c_global"], None,
                      global_t=gt, label="global keepfraction=0.01",
                      min_boxes=dataset["min_oracle_boxes"])
    with phase("-c transfer=sparse", clock, total):
        cli(base + ["keep=0.999", "transfer=sparse",
                    f"compresseddir={dirs['c_sparse']}", "-c"])
    same_tree(check, "sparse archive byte-identical to dense",
              dirs["c_dense"], dirs["c_sparse"])
    with phase("-d transfer=sparse", clock, total):
        cli([f"compresseddir={dirs['c_sparse']}", f"out={dirs['d_sparse']}",
             "transfer=sparse", "-d"])
    same_tree(check, "sparse plotfiles byte-identical to dense",
              dirs["d_dense"], dirs["d_sparse"])
    with phase("constant plotfile round trip", clock):
        constant_plotfile_check(check, work)
    with phase("stage rates (compact, scatter)", clock):
        rates = bench.sparse_stages(*dataset["stage_shape"])
    log("STAGES " + json.dumps(rates))
    check("compact/scatter stage outputs", rates["checks_ok"])


def four_cards(work: str, seed: int, dataset: dict, check: Checks) -> None:
    clock = CompileClock()
    data = os.path.join(work, "data")
    with phase("generate dataset", clock):
        layout, paths = make_dataset(data, seed, dataset["base_dims"],
                                     dataset["fractions"])
    per_t = layout.cells() * len(COMPONENTS) * 4
    total = per_t * len(paths)
    sizes = [int(np.prod(d)) * 4 for lev in layout.dimensions for d in lev]
    n_giant = sum(b >= GIANT_BYTES for b in sizes)
    log("DATASET " + json.dumps({
        "float32_bytes_per_timestep": per_t, "timesteps": len(paths),
        "boxes_per_timestep": len(sizes), "giant_boxes": n_giant}))
    check("4-card run has giant and data-parallel boxes",
          0 < n_giant < len(sizes), f"{n_giant} of {len(sizes)} giant")
    first, last = (os.path.basename(p) for p in (paths[0], paths[-1]))
    max_level = len(layout.dimensions) - 1
    base = [f"datadir={data}", f"minfile={first}", f"maxfile={last}",
            "minlevel=0", f"maxlevel={max_level}",
            "components=" + " ".join(COMPONENTS)]
    giant = f"giantbox={GIANT_BYTES}"
    runs = {}
    for cards in (1, 4):
        dev = [f"devices={cards}"] + ([giant] if cards > 1 else [])
        c = os.path.join(work, f"c{cards}") + os.sep
        g = os.path.join(work, f"g{cards}") + os.sep
        d = os.path.join(work, f"d{cards}") + os.sep
        with phase(f"-c devices={cards}", clock, total):
            cli(base + ["keep=0.999", f"compresseddir={c}", "-c"] + dev)
        with phase(f"-c devices={cards} thresholdmode=global", clock, total):
            cli(base + ["thresholdmode=global", "keepfraction=0.01",
                        f"compresseddir={g}", "-c"] + dev)
        with phase(f"-d devices={cards}", clock, total):
            cli([f"compresseddir={c}", f"out={d}", "-d"] + dev)
        runs[cards] = (c, g, d)
    for i, what in enumerate(("archive", "global archive", "plotfiles")):
        same_tree(check, f"4-card {what} byte-identical to 1-card",
                  runs[1][i], runs[4][i])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path and its 1-card twin")
    args = ap.parse_args(argv)

    import jax

    import bench

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
        return 2
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        log(f"needs {want} cards, JAX found {len(jax.devices())}")
        return 2
    from wavelet_tpu import native
    from wavelet_tpu.runtime import debug

    debug.enable_compilation_cache()
    log(bench.card_line())
    log(f"jax devices: {jax.devices()}")
    log(f"native codec built: {native.available()}")
    check = Checks()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            four_cards(work, args.seed, FOUR_CARDS, check)
        else:
            one_card(work, args.seed, FULL, check)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if check.failed:
        log(f"FAILED: {check.failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
