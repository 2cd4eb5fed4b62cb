"""Shared pipeline pieces: config, file/level discovery, data collection.

CLI contract mirrors the reference (argparse.cpp): ``datadir= minfile=
maxfile= minlevel= maxlevel= components="..." keep= compresseddir= out=``
plus the ``-c/-d/-estimate`` mode flags, so the same invocations drive both
tools.  Unlike the reference (which logs missing keys and continues with
uninitialized fields, SURVEY.md §5.6.7), missing keys raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from wavelet_tpu.io import archive, plotfile

__all__ = ["Config", "clean_string", "format_files", "format_levels",
           "RunData", "collect_run", "RunMeta", "collect_run_meta"]


@dataclass
class Config:
    """Reference ``Config`` (argparse.h:7-16)."""

    data_dir: str = ""
    min_time: str = ""
    max_time: str = ""
    min_level: int = 0
    max_level: int = 0
    components: list = field(default_factory=list)
    keep: float = 0.999
    compressed_dir: str = ""
    out_dir: str = ""
    # new TPU-native options (absent in the reference)
    threshold_mode: str = "box"       # "box" (parity) | "global" (quantile)
    keep_fraction: float | None = None
    resume: bool = False              # skip already-written .xz outputs
    scales: int = 1                   # wavelet scales (1 = reference parity)
    payload: str = "f32"              # "f32" (parity) | "q16" (quantized)
    codec: str = "xz"                 # "xz" (parity) | "raw" (no entropy stage)
    xz_preset: int = 6                # xz preset (6 = reference parity)
    xz_delta: int = 0                 # xz delta-filter distance (0 = off;
                                      #   8 aligns with the pair stride —
                                      #   2.3-3.5x smaller on smooth-field
                                      #   coefficients; decode is automatic)
    archive: str = "files"            # "files" (parity) | "bundle" (one
                                      #   container per timestep+process)
    transfer: str = "dense"           # "dense" | "sparse" (on-device
                                      #   compaction) | "auto" (dense for
                                      #   now: engine.transfer_mode)
    device_metrics: bool = False      # estimate RMSE on device (f32 fast path)
    fast_estimate: bool = False       # in-memory estimate (no scratch dir)
    keep_sweep: list | None = None    # estimate mode: several keeps in one
                                      #   run (fastestimate shares the
                                      #   forward transform across them)
    keep_fraction_sweep: list | None = None  # estimate+global: several
                                      #   keepfractions in one run (the
                                      #   histogram is fraction-independent)
    levels_upto: int | None = None    # decompress: partial retrieval —
                                      #   only archive levels <= this
                                      #   (None = all; the timestep and
                                      #   component filters reuse
                                      #   min_time/max_time/components)
    preview: int = 0                  # decompress: regenerate the low-band
                                      #   approximation at 1/2**preview
                                      #   resolution per axis (0 = full
                                      #   resolution, the reference behavior)
    out_precision: str = "f64"        # decompress: FAB real width of the
                                      #   regenerated plotfiles — "f64"
                                      #   (reference parity, byte-identical)
                                      #   | "f32" (half the bytes; values
                                      #   identical, the codec is f32)
    giant_box_bytes: int | None = None  # route boxes >= this many bytes
                                      #   through the X-sharded giant-box
                                      #   transform (needs a multi-device
                                      #   mesh; None = 1 GiB default, see
                                      #   engine.CodecEngine.giant_ok).
                                      #   CLI key: giantbox=BYTES
    giant_mesh: str = "local"         # "local" (giant boxes shard within
                                      #   this process's devices) |
                                      #   "global" (opt-in: shard over the
                                      #   whole multi-process mesh; giant
                                      #   items become collective across
                                      #   processes — for boxes beyond one
                                      #   host's devices).  CLI: giantmesh=
    global_cache_bytes: int | None = None  # global threshold mode: budget
                                      #   for caching pass-1 coefficients in
                                      #   host RAM so pass 2 skips re-reading
                                      #   + re-transforming cached timesteps
                                      #   (None = 4 GiB default, env
                                      #   WAVELET_TPU_GLOBALCACHE overrides;
                                      #   0 = always re-read, the bounded-
                                      #   memory round-4 behavior).
                                      #   CLI key: globalcache=BYTES
    prefetch: int = 0                 # 1 = overlap next timestep's plotfile
                                      #   read (compress) / this timestep's
                                      #   plotfile write (decompress) with the
                                      #   codec; peak RSS becomes TWO
                                      #   timesteps instead of one


def clean_string(filename: str) -> int:
    """Digits-only numeric key of a file name; -1 if none (argparse.cpp:103-129)."""
    digits = "".join(ch for ch in filename if ch.isdigit())
    if not digits:
        return -1
    return int(digits)


def format_files(data_dir: str, min_time: str, max_time: str):
    """Discover timestep directories whose numeric key falls in
    [clean(min), clean(max)], sorted by key (argparse.cpp:133-166)."""
    first, last = clean_string(min_time), clean_string(max_time)
    # deviation from the reference: it keys on the *full* path
    # (argparse.cpp:146), so digits in parent directories pollute the numeric
    # range; we key on the entry basename (the intended semantics).
    files = [os.path.join(data_dir, e) for e in os.listdir(data_dir)
             if first <= clean_string(e) <= last]
    files.sort(key=lambda p: clean_string(os.path.basename(p)))
    if not files:
        # an empty selection would otherwise crash deep in the metadata
        # collectors (base_dims stays None); name the range instead
        raise ValueError(
            f"no plotfiles in {data_dir} match minfile={min_time} .. "
            f"maxfile={max_time}")
    return files


def format_levels(min_level: int, max_level: int):
    return list(range(int(min_level), int(max_level) + 1))


@dataclass
class RunData:
    """Everything one compression run needs (reference ``AllData``,
    box-structs.h:53-62): per (t, lev) box lists + geometry sidecar info.

    ``components`` holds the selected names *in plotfile-Header order* —
    the order of ``comp_idxs`` and of every per-component array.  (The
    reference requires the user to list components in Header order,
    README.md; re-deriving the order here means a differently-ordered user
    list can't silently mislabel outputs.)"""

    levels_data: list          # [t][lev] -> plotfile.LevelBoxes
    comp_idxs: list            # header indices of selected components
    components: list           # selected names, Header order
    min_values: np.ndarray     # per component, over the whole run
    max_values: np.ndarray
    amrexinfo: archive.AMReXInfo
    files: list
    levels: list


@dataclass
class RunMeta:
    """Sidecar-sufficient metadata of a run — everything ``write_sidecars``
    needs, WITHOUT any box data in memory.  This is what makes the streaming
    pipeline's peak RSS independent of the number of timesteps: pass 0
    parses headers + ``Cell_H`` box lists (a few KB per level), writes the
    five sidecars, and only then does the per-timestep read→compress→free
    loop touch FAB payloads."""

    locations: list            # [t][lev] -> list of int triples
    dimensions: list           # [t][lev] -> list of int triples
    counts: list               # [t][lev] -> box count
    comp_idxs: list
    components: list           # selected names, Header order
    amrexinfo: archive.AMReXInfo
    files: list
    levels: list


def _select_ref_ratio(h, levels, fname: str) -> list:
    """The single per-axis ratio triple the archive stores, from the
    boundaries the selection actually spans (levels lo..hi span boundaries
    lo..hi-1; a single-level selection spans none).  A Header whose
    SPANNED boundaries refine at different ratios (line "2 4") cannot be
    represented — reject it rather than silently regenerate a wrong
    Header.  (The reference is equally limited but silent:
    preprocess.cpp:212-224 reads only ratio[0].)"""
    used = h.ref_ratio[min(levels):max(levels)] if levels else []
    if len(set(used)) > 1:
        raise ValueError(
            f"plotfile {fname} refines with non-uniform ratios "
            f"{h.ref_ratio[:h.finest_level]} across the selected levels; "
            "the archive format stores a single ratio — restrict "
            "minlevel/maxlevel to a uniformly-refined range")
    r = used[0] if used else (h.ref_ratio[0] if h.ref_ratio else 2)
    return [r, r, r]


def collect_run_meta(files, components, levels) -> RunMeta:
    """Metadata-only preprocessing pass (geometry of preprocess.cpp:107-307
    without the box-data copies)."""
    comp_idxs = None
    names_ordered = list(components)
    geom, true_times, lvl_steps = [], [], []
    ref_ratios = None
    base_dims = None
    locations, dimensions, counts = [], [], []
    for f in files:
        h = plotfile.read_header(f)
        if comp_idxs is None:
            comp_idxs = h.component_indices(components)
            names_ordered = [h.component_names[i] for i in comp_idxs]
            ref_ratios = _select_ref_ratio(h, levels, f)
            base_dims = h.domain_dims(0)
        geom.append(list(h.prob_lo) + list(h.prob_hi))
        true_times.append(np.longdouble(h.time_str))
        lvl_steps.append([h.level_steps[l] if l < len(h.level_steps) else 0
                          for l in levels])
        locs_t, dims_t, counts_t = [], [], []
        for lev in levels:
            locs, dims = plotfile.read_level_meta(f, lev)
            locs_t.append(locs)
            dims_t.append(dims)
            counts_t.append(len(locs))
        locations.append(locs_t)
        dimensions.append(dims_t)
        counts.append(counts_t)
    info = archive.AMReXInfo(geom, ref_ratios, true_times, lvl_steps,
                             base_dims[0], base_dims[1], base_dims[2])
    return RunMeta(locations=locations, dimensions=dimensions, counts=counts,
                   comp_idxs=comp_idxs, components=names_ordered,
                   amrexinfo=info, files=list(files), levels=list(levels))


def collect_run(files, components, levels) -> RunData:
    """Read the selected (timestep, level) slices of all plotfiles
    (reference ``preprocess_data``, preprocess.cpp:107-307)."""
    levels_data = []
    comp_idxs = None
    minv = np.full(len(components), np.inf, np.float64)
    maxv = np.full(len(components), -np.inf, np.float64)
    geom, true_times, lvl_steps = [], [], []
    ref_ratios = None
    base_dims = None
    names_ordered = list(components)
    for t, f in enumerate(files):
        h = plotfile.read_header(f)
        if comp_idxs is None:
            comp_idxs = h.component_indices(components)
            names_ordered = [h.component_names[i] for i in comp_idxs]
            # intended semantics: per-dim ratio replicated from the per-level
            # scalar (the reference's stream-parse quirk yields {r,0,0};
            # SURVEY.md notes its own test expects {r,r,r}); same spanned-
            # range selection/rejection as the streaming metadata pass
            ref_ratios = _select_ref_ratio(h, levels, f)
            base_dims = h.domain_dims(0)
        geom.append(list(h.prob_lo) + list(h.prob_hi))
        true_times.append(np.longdouble(h.time_str))
        lvl_steps.append([h.level_steps[l] if l < len(h.level_steps) else 0
                          for l in levels])
        per_lev = []
        for lev in levels:
            lv = plotfile.read_level(f, lev, comp_idxs)
            per_lev.append(lv)
            minv = np.minimum(minv, lv.min_values.astype(np.float64))
            maxv = np.maximum(maxv, lv.max_values.astype(np.float64))
        levels_data.append(per_lev)
    info = archive.AMReXInfo(geom, ref_ratios, true_times, lvl_steps,
                             base_dims[0], base_dims[1], base_dims[2])
    return RunData(levels_data=levels_data, comp_idxs=comp_idxs,
                   components=names_ordered,
                   min_values=minv.astype(np.float32),
                   max_values=maxv.astype(np.float32),
                   amrexinfo=info, files=list(files), levels=list(levels))
