"""Decompression pipeline (reference: ``decompress(Config)``, modes.cpp:115-204).

Stages:
  1. host: read sidecars (runinfo/boxcounts/locations/dimensions/amrexinfo)
  2. streaming loop, one timestep at a time: parallel read + xz decode + RLE
     scatter into flat coefficient rows, device inverse Haar on
     shape-bucketed batches, then regenerate that timestep's plotfile
     byte-identically (io/plotfile.write_plotfile) and free — unlike the
     reference, which materializes every regenerated box of every timestep
     before writing anything (modes.cpp:151-199), peak RSS here is bounded
     by one timestep.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os

import numpy as np

from wavelet_tpu.io import archive, plotfile
from wavelet_tpu.pipeline import common
from wavelet_tpu.runtime import batching, debug, engine

log = logging.getLogger("wavelet_tpu")

__all__ = ["decompress_run", "iter_decompressed_timesteps"]


def _unpack_bucket(cfg, eng, packer, pad, dims, bucket_items, transfer,
                   preview=0, arena=None):
    """HOST stage of one shape bucket: read + decode + (for sparse) the
    transport decision.  Returns ``(kind, payload, h2d)`` where kind is
    "dense" (payload = a filled ShapeBatch), "sparse" (payload =
    (shell batch, idx, vals)) or "preview" (payload = a LOGICAL-order
    coefficient batch; h2d is decided by the device stage) — no device
    work happens here, so a prefetch worker can run it behind the
    previous bucket's inverse."""
    pad = eng.pad_multiple_for(dims) if pad > 1 else pad
    if preview:
        batch = batching.empty_batch(bucket_items, dims,
                                     pad_multiple=pad, layout="halves",
                                     scales=eng.eff_scales(dims),
                                     arena=arena)
        packer.unpack_into(cfg.compressed_dir, batch)
        return "preview", batch, 0
    transfer = eng.transfer_mode(dims, transfer)
    if transfer == "sparse":
        batch = batching.ShapeBatch(shape=dims, data=None,
                                    items=bucket_items,
                                    n_valid=len(bucket_items))
        idx, vals = packer.unpack_sparse(cfg.compressed_dir, batch)
        dense_nbytes = batching.dense_batch_nbytes(
            len(bucket_items), dims, pad_multiple=pad)
        if idx.nbytes + vals.nbytes < dense_nbytes:
            return "sparse", (batch, idx, vals), idx.nbytes + vals.nbytes
        # sparse transport must never ship MORE than dense: at high kept
        # fractions (pairs are 8 B/coefficient vs 4 B dense, padded to a
        # shared power-of-2 capacity) the pair stream can exceed the dense
        # rows — scatter the decoded pairs into dense rows on host and
        # take the dense device path instead (same bytes on the link, no
        # device scatter)
        log.info("sparse transfer: kept fraction too high for shape %s "
                 "(%d pair bytes >= %d dense) — falling back to dense "
                 "transport", dims, idx.nbytes + vals.nbytes, dense_nbytes)
        dense = batching.empty_batch(bucket_items, dims,
                                     pad_multiple=pad,
                                     layout=eng.coeff_layout(dims),
                                     scales=eng.eff_scales(dims),
                                     arena=arena)
        m = int(np.prod(dims))
        row = np.zeros(m, np.float32)
        for i in range(len(bucket_items)):
            k = idx[i] < m
            row[:] = 0.0
            row[idx[i][k]] = vals[i][k]
            dense.item_write(i, row.reshape(dims))
        return "dense", dense, dense.data.nbytes
    batch = batching.empty_batch(bucket_items, dims,
                                 pad_multiple=pad,
                                 layout=eng.coeff_layout(dims),
                                 scales=eng.eff_scales(dims),
                                 arena=arena)
    packer.unpack_into(cfg.compressed_dir, batch)
    return "dense", batch, batch.data.nbytes


def _decompress_timestep(cfg, eng, packer, pad, comp_idxs, t, num_levels,
                         counts, dimensions, transfer="dense", preview=0,
                         arena=None):
    """Decode + inverse-transform every box of timestep ``t``.

    Returns ``(regen, h2d_bytes)`` with ``regen``: [lev][box] ->
    (C, X, Y, Z) float32.  ``transfer="sparse"`` ships only the kept
    (position, value) pairs to the device and scatters there — the mirror
    of the compress-side sparse path, for slow host->device links.
    ``preview=p`` regenerates the low-band approximation instead — regen
    boxes are (C, X>>p, Y>>p, Z>>p) (engine.preview_shapebatch).

    ``prefetch=1`` additionally pipelines WITHIN the timestep: a single
    worker runs bucket i+1's host stage (read + decode) behind bucket i's
    device inverse (one extra bucket of coefficients in memory).
    """
    buckets = {}
    for li in range(num_levels):
        for b in range(counts[t][li]):
            dims = tuple(dimensions[t][li][b])
            for comp_idx in comp_idxs:
                buckets.setdefault(dims, []).append(
                    batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                      box=b))
    comp_pos = {c: k for k, c in enumerate(comp_idxs)}
    ncomp = len(comp_idxs)
    regen = [[None] * counts[t][li] for li in range(num_levels)]
    h2d_bytes = 0
    order = list(buckets.items())

    def host_stage(j):
        dims, bucket_items = order[j]
        return _unpack_bucket(cfg, eng, packer, pad, dims, bucket_items,
                              transfer, preview, arena)

    def device_stage(j, prepared):
        nonlocal h2d_bytes
        dims, bucket_items = order[j]
        kind, payload, h2d = prepared
        if kind == "preview":
            arr, h2d = eng.preview_shapebatch(payload, preview)
            out_dims = tuple(arr.shape[1:])
            item = arr.__getitem__
        else:
            if kind == "sparse":
                batch, idx, vals = payload
                out = eng.decompress_shapebatch_sparse(batch, idx, vals)
            else:
                out = eng.decompress_shapebatch(payload)
            out_dims = dims
            item = out.item_view
        h2d_bytes += h2d
        for i, it in enumerate(bucket_items):
            if regen[it.level][it.box] is None:
                regen[it.level][it.box] = np.zeros(
                    (ncomp,) + out_dims, dtype=np.float32)
            regen[it.level][it.box][comp_pos[it.comp_idx]] = item(i)
        # the device stage fetched its results above, so the input buffer
        # can be recycled for a later bucket's unpack (BufferArena contract)
        if arena is not None and kind in ("dense", "preview") \
                and payload.data is not None:
            arena.release(payload.data)

    if cfg.prefetch > 0 and len(order) > 1:
        with cf.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(host_stage, 0)
            for j in range(len(order)):
                prepared = nxt.result()
                if j + 1 < len(order):
                    nxt = pool.submit(host_stage, j + 1)
                device_stage(j, prepared)
    else:
        for j in range(len(order)):
            device_stage(j, host_stage(j))
    return regen, h2d_bytes


def iter_decompressed_timesteps(cfg: common.Config, mesh=None, stats=None):
    """Generator over regenerated timesteps: yields
    ``(t, plotfile_name, regen, locations_t, dimensions_t, info, amrex)``
    one timestep at a time, holding only that timestep's boxes — callers
    that consume and drop each item keep peak memory flat in the number of
    timesteps (asserted by tests/test_streaming.py).  A ``stats`` dict, if
    given, accumulates ``host_to_device_bytes`` (the actual transport
    bytes, padded arrays included — the number ``transfer=sparse`` is
    meant to shrink).  Multi-process: only timesteps THIS process owns
    are yielded (under ``giantmesh=global`` non-owned timesteps are still
    decoded — the giant inverse is collective — but never yielded), so
    writing every yielded timestep is always race-free.

    Partial retrieval (extension — the reference always regenerates the
    whole archive): ``cfg.min_time``/``cfg.max_time`` select timesteps by
    the same numeric-key rule as compression, ``cfg.components`` a subset
    of the archived components, ``cfg.levels_upto`` an archive-level
    prefix.  Only the selected payload files are ever read.

    Preview mode (extension): ``cfg.preview = p`` regenerates the wavelet
    low band instead of full resolution — plotfiles come out at
    ``1/2**p`` cells per axis on the same physical domain (cells grow
    ``2**p``x), each value the 2**p-cube block mean the Haar low-pass
    encodes.  For ``p <= scales`` this needs only the stored pyramid
    corner (8**-p of the coefficients cross the host->device link);
    composes with partial retrieval."""
    info = archive.read_runinfo(cfg.compressed_dir)
    full_levels = common.format_levels(info.min_level, info.max_level)
    num_times = len(info.files)
    counts = archive.read_boxcounts(cfg.compressed_dir, num_times,
                                    len(full_levels))
    locations = archive.read_locdim(cfg.compressed_dir, "locations.raw",
                                    counts)
    dimensions = archive.read_locdim(cfg.compressed_dir, "dimensions.raw",
                                     counts)
    amrex = archive.read_amrexinfo(cfg.compressed_dir)
    rr = amrex.ref_ratios
    if len(rr) == 3 and rr[0] > 0 and rr[1] == 0 and rr[2] == 0:
        # a REFERENCE-written archive: its Header parse stream-extracts 3
        # ints from a per-boundary scalar line (preprocess.cpp:211-221),
        # so it stores {r, 0, 0}.  The ratio is per-dim uniform in every
        # plotfile either tool writes; taking {r, r, r} regenerates the
        # correct domain dims where the raw triple would zero the y/z
        # extents and crash the Header write (round-5 interop review).
        log.info("amrexinfo ref_ratios %s normalized to {%d,%d,%d} "
                 "(reference writer quirk)", rr, rr[0], rr[0], rr[0])
        amrex = archive.AMReXInfo(
            amrex.geomcellinfo, [rr[0]] * 3, amrex.true_times,
            amrex.level_steps, amrex.x_dim, amrex.y_dim, amrex.z_dim)
    meta = archive.read_meta(cfg.compressed_dir)

    # --- selection (defaults = everything, the reference behavior) ------
    levels = full_levels
    if cfg.levels_upto is not None:
        levels = [lv for lv in full_levels if lv <= cfg.levels_upto]
        if not levels:
            raise ValueError(
                f"maxlevel={cfg.levels_upto} selects no archive level "
                f"(archive has levels {full_levels})")
    num_levels = len(levels)   # a PREFIX of the archive's level list
    if stats is not None:
        # reported even by a process whose yielded set is empty (under
        # giantmesh=global a process can own zero timesteps yet still
        # decode every one collectively)
        stats["levels_selected"] = num_levels
    if cfg.components:
        missing = [c for c in cfg.components if c not in info.components]
        if missing:
            raise ValueError(
                f"components not in archive: {missing} "
                f"(archive has {info.components})")
        chosen = set(cfg.components)
        sel = [(n, i) for n, i in zip(info.components, info.comp_idxs)
               if n in chosen]
        comp_names = [n for n, _ in sel]
        comp_idxs = [i for _, i in sel]
    else:
        comp_names, comp_idxs = list(info.components), list(info.comp_idxs)
    if cfg.min_time or cfg.max_time:
        lo = (common.clean_string(cfg.min_time) if cfg.min_time
              else -(1 << 62))
        hi = (common.clean_string(cfg.max_time) if cfg.max_time
              else (1 << 62))
        sel_times = [t for t, f in enumerate(info.files)
                     if lo <= common.clean_string(os.path.basename(f)) <= hi]
        if not sel_times:
            raise ValueError(
                f"minfile={cfg.min_time!r} maxfile={cfg.max_time!r} select "
                f"no archived timestep (archive has {info.files})")
    else:
        sel_times = list(range(num_times))
    # what the caller sees: the selected view of the run
    sel_info = archive.RunInfo(info.files, info.min_level,
                               levels[-1], comp_names, comp_idxs)
    if (len(sel_times) < num_times or num_levels < len(full_levels)
            or len(comp_names) < len(info.components)):
        log.info("Partial retrieval: %d of %d timesteps, levels %s of %s, "
                 "%d of %d components", len(sel_times), num_times, levels,
                 full_levels, len(comp_names), len(info.components))

    # --- preview mode (extension): low-band regeneration at 1/2**p -------
    preview = cfg.preview
    if preview:
        f = 1 << preview
        base = (amrex.x_dim, amrex.y_dim, amrex.z_dim)
        if any(d % f for d in base):
            raise ValueError(
                f"preview={preview} requires domain dims divisible by {f}; "
                f"archive domain is {base}")
        for t in sel_times:
            for li in range(num_levels):
                for b in range(counts[t][li]):
                    loc = locations[t][li][b]
                    dd = dimensions[t][li][b]
                    if any(v % f for v in loc) or any(v % f for v in dd):
                        raise ValueError(
                            f"preview={preview} requires box locations and "
                            f"dims divisible by {f}; timestep {t} level "
                            f"{li} box {b} has loc={loc} dims={dd}")
        # same physical domain over 2**p-coarser index space: cells grow
        # 2**p per axis, geometry (geomcellinfo), times and steps unchanged
        amrex = archive.AMReXInfo(
            amrex.geomcellinfo, amrex.ref_ratios, amrex.true_times,
            amrex.level_steps, amrex.x_dim >> preview,
            amrex.y_dim >> preview, amrex.z_dim >> preview)
        log.info("Preview mode: regenerating the wavelet low band at "
                 "1/%d resolution per axis", f)

    packer = engine.HostPacker(payload=meta.get("payload", "f32"),
                               codec=meta.get("codec", "xz"),
                               archive_format=meta.get("archive", "files"))
    eng = engine.CodecEngine(mesh=mesh, scales=meta.get("scales", 1),
                             giant_box_bytes=cfg.giant_box_bytes,
                             giant_mesh_mode=cfg.giant_mesh)
    pad = mesh.size if mesh is not None else 1
    # multi-host fan-out: timesteps are independent units (each regenerates
    # its own plotfile directory), so each process takes a contiguous slice.
    # giantmesh=global instead DECODES every timestep on every process
    # (the giant inverse is collective across processes — slicing would
    # deadlock the first giant box) but YIELDS only the timesteps this
    # process owns, so every consumer writes each plotfile exactly once.
    import jax

    owned_times = None
    if jax.process_count() > 1:
        from wavelet_tpu.runtime import mesh as mesh_lib

        sl = mesh_lib.process_local_slice(len(sel_times))
        if cfg.giant_mesh == "global":
            owned_times = set(sel_times[sl])
            if stats is not None:
                stats["owned_times"] = owned_times
        else:
            sel_times = sel_times[sl]
    arena = batching.BufferArena()   # same shape buckets recur every step
    for t in sel_times:
        # timestep boundary: the arena drops buffers a regrid left behind
        arena.new_generation()
        regen, h2d = _decompress_timestep(cfg, eng, packer, pad, comp_idxs,
                                          t, num_levels, counts, dimensions,
                                          transfer=cfg.transfer,
                                          preview=preview, arena=arena)
        if stats is not None:
            stats["host_to_device_bytes"] = (
                stats.get("host_to_device_bytes", 0) + h2d)
        if owned_times is not None and t not in owned_times:
            # giantmesh=global: this process decoded the timestep only to
            # participate in the collective giant inverse.  The gate lives
            # HERE, not in the caller — every consumer of this public
            # iterator (not just decompress_run) must see only the
            # timesteps this process may write, or two processes would
            # race writes to the same plotfile directory.
            continue
        name = os.path.join(cfg.out_dir, os.path.basename(info.files[t]))
        if preview:
            locs_t = [[tuple(v >> preview for v in loc)
                       for loc in locations[t][li]]
                      for li in range(num_levels)]
            dims_t = [[tuple(v >> preview for v in dd)
                       for dd in dimensions[t][li]]
                      for li in range(num_levels)]
        else:
            locs_t = locations[t][:num_levels]
            dims_t = dimensions[t][:num_levels]
        yield (t, name, regen, locs_t, dims_t, sel_info, amrex)


def decompress_run(cfg: common.Config, mesh=None) -> dict:
    info = archive.read_runinfo(cfg.compressed_dir)
    log.info("Decompressing data between timestep %s and %s, level %s and %s, "
             "for %s components", info.files[0], info.files[-1],
             info.min_level, info.max_level, len(info.components))

    os.makedirs(cfg.out_dir, exist_ok=True)
    n_boxes = 0
    n_times = 0
    num_levels = 0
    stats: dict = {}
    with debug.phase_timer(
            "decompress",
            message="Decompression completed in %s seconds.") as ph, \
            cf.ThreadPoolExecutor(1) as write_pool:
        # prefetch=1: timestep t's plotfile write runs on the worker while
        # t+1 decodes (independent output directories) — peak memory grows
        # to two timesteps' boxes; the single worker keeps writes ordered.
        pending = None
        for (t, name, regen, locs_t, dims_t, rinfo, amrex) in \
                iter_decompressed_timesteps(cfg, mesh, stats=stats):
            num_levels = len(locs_t)   # the SELECTED level prefix
            # giantmesh=global ownership is gated inside the iterator:
            # only timesteps this process may write are ever yielded
            log.info("%s", name)
            geom = amrex.geomcellinfo[t]
            job = (plotfile.write_plotfile,
                   name,
                   [regen[li] for li in range(num_levels)],
                   [locs_t[li] for li in range(num_levels)],
                   [dims_t[li] for li in range(num_levels)],
                   rinfo.components,
                   float(amrex.true_times[t]),
                   geom[0:3], geom[3:6],
                   amrex.ref_ratios,
                   (amrex.x_dim, amrex.y_dim, amrex.z_dim),
                   # slice to the selected level prefix: the Header emits
                   # one level-steps token per entry, and token-based
                   # AMReX parsers would mis-consume extras as geometry
                   amrex.level_steps[t][:num_levels],
                   cfg.out_precision)
            if cfg.prefetch > 0:
                if pending is not None:
                    pending.result()
                pending = write_pool.submit(*job)
            else:
                job[0](*job[1:])
            n_boxes += sum(len(per) for per in regen)
            n_times += 1
        if pending is not None:
            pending.result()
    log.info("Sucessfully wrote plotfiles.")
    stats.pop("owned_times", None)   # internal write gate, not a stat
    stats.update({"decompress_seconds": ph.seconds, "times": n_times,
                  # levels_selected, not the per-yield count: a process
                  # that owns zero timesteps (giantmesh=global with more
                  # processes than timesteps) must still report the
                  # selected level count, not 0
                  "levels": stats.pop("levels_selected", num_levels),
                  "boxes": n_boxes})
    return stats
