"""Compression pipeline (reference: ``compress(Config)``, modes.cpp:24-112).

Stages:
  1. host: discover files, parse headers + Cell_H box lists (metadata only)
  2. host: write the five sidecar files first — the archive is then
     resumable state, every later output is an independent file
     (SURVEY.md §7 checkpoint/resume property)
  3. streaming loop, one timestep at a time: read FAB boxes (io/plotfile),
     device codec (shape-bucketed batches -> fused Haar + absmax -> exact
     thresholds, runtime/engine), host RLE + serialize + xz in a thread
     pool, then free — peak RSS is bounded by one timestep, not the run
     (the reference materializes the whole run in ``AllData``; a framework
     for large AMR data cannot).

Multi-host: each process takes its slice of the global work-item sequence
and writes its own shard of ``.xz`` files (runtime/mesh.process_local_slice).
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import logging
import os

import numpy as np

from wavelet_tpu.io import archive, plotfile
from wavelet_tpu.pipeline import common
from wavelet_tpu.runtime import batching, debug, engine, mesh as mesh_lib

log = logging.getLogger("wavelet_tpu")

__all__ = ["compress_run", "compress_collected"]


def _iter_workitems(run: common.RunData):
    """Flatten the (t, lev, comp, box) space into codec work items."""
    for t, per_lev in enumerate(run.levels_data):
        for li, lv in enumerate(per_lev):
            for b, arr in enumerate(lv.boxes):
                for c, comp_idx in enumerate(run.comp_idxs):
                    yield (batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                             box=b), arr[c])


def write_sidecars_meta(meta: common.RunMeta, min_level, max_level,
                        out_dir: str):
    """The five metadata files of modes.cpp:71-89, byte-compatible, written
    from the metadata-only pass (no box data needed).
    Component names are recorded in Header order (matching comp_idxs)."""
    info = archive.RunInfo(meta.files, min_level, max_level,
                           list(meta.components), meta.comp_idxs)
    existing = os.path.join(out_dir, "runinfo.raw")
    if os.path.exists(existing):
        # mixed-archive guard: re-running the SAME selection (resume,
        # multi-process sidecar races) writes identical sidecars and is
        # benign, but a DIFFERENT run into a populated archive would
        # clobber the sidecars while stale payload files linger — a
        # corrupt archive that -check can't fully diagnose.  Refuse.
        try:
            old = archive.read_runinfo(out_dir)
        except (ValueError, OSError):
            old = None   # a corrupt runinfo is overwritten, not protected
        if old is not None and old != info:
            raise ValueError(
                f"{out_dir} already contains a different run's archive "
                f"(files {old.files[:2]}..., levels {old.min_level}-"
                f"{old.max_level}, components {old.components}); "
                "compress into an empty directory, or rerun the same "
                "selection (resume=1 skips finished items)")
    archive.write_runinfo(info, out_dir)
    archive.write_locdim(meta.locations, out_dir, "locations.raw")
    archive.write_locdim(meta.dimensions, out_dir, "dimensions.raw")
    archive.write_boxcounts(meta.counts, out_dir)
    archive.write_amrexinfo(meta.amrexinfo, out_dir)
    # meta LAST so its sidecar_crc32 block covers all five .raw files
    # (compress_run overwrites it with the run's extension settings, which
    # recomputes the same CRCs)
    archive.write_meta(out_dir)


def write_sidecars(run: common.RunData, min_level, max_level, out_dir: str):
    """Sidecars from an in-memory RunData (compress_collected callers)."""
    meta = common.RunMeta(
        locations=[[lv.locations for lv in per] for per in run.levels_data],
        dimensions=[[lv.dimensions for lv in per] for per in run.levels_data],
        counts=[[len(lv.boxes) for lv in per] for per in run.levels_data],
        comp_idxs=run.comp_idxs, components=list(run.components),
        amrexinfo=run.amrexinfo, files=run.files, levels=run.levels)
    write_sidecars_meta(meta, min_level, max_level, out_dir)


def _exists(out_dir: str, item, have=None) -> bool:
    """Is this item's output already in the archive?  ``have`` is the
    preloaded member-key set in bundle mode (finished bundles are immutable,
    so one index scan at run start stays valid); None = per-file checks."""
    if have is not None:
        return (item.t, item.level, item.comp_idx, item.box) in have
    return os.path.exists(os.path.join(
        out_dir, archive.payload_filename(item.t, item.level,
                                          item.comp_idx, item.box)))


def _have_index(out_dir: str, archive_format: str):
    """Resume index: a set of (t, lev, comp, box) already present (bundle
    mode), or None (files mode — _exists stats per file)."""
    if archive_format != "bundle":
        return None
    from wavelet_tpu.io import bundle as bundle_mod

    return set(bundle_mod.BundleSet(out_dir).keys())


def _pack_dense_or_sparse(batches, eng, packer, out_dir: str, keep: float,
                          transfer: str, owned=None):
    """The overlapped device-codec + host-pack loop for per-box (parity)
    thresholds: the device transforms batch i+1 while a pack thread runs
    the host RLE+xz+write of batch i.  Returns (n_files, in_bytes, out_bytes).

    ``owned`` (giantmesh=global): the set of WorkItems THIS process may
    write.  Cross-host giant batches contain every process's giant items
    (the sharded transform is collective), so the pack stage subsets to
    the owned ones; non-giant batches are always fully owned."""
    n_files = 0
    in_bytes = 0
    out_bytes = 0
    d2h_bytes = 0                 # device->host traffic (sparse-mode value)
    with cf.ThreadPoolExecutor(1) as pack_pool:
        pending = None
        for batch in batches:
            subset = None
            if owned is not None:
                mine = [i for i, it in enumerate(batch.items)
                        if it in owned]
                if len(mine) < len(batch.items):
                    subset = mine
            if eng.transfer_mode(batch.shape, transfer) == "sparse":
                # sparsification on device: only kept (index, value) pairs
                # cross the device->host link (never the giant path, so
                # subset is always None here — transfer_mode forces giant
                # shapes dense)
                sparse, t32 = eng.compress_shapebatch_sparse(batch, keep)
                d2h_bytes += sparse.transfer_bytes()
                job = (packer.pack_sparse, out_dir, sparse, t32)
            else:
                coeffs, t32 = eng.compress_shapebatch(batch, keep)
                d2h_bytes += coeffs.data.nbytes
                job = (functools.partial(packer.pack, subset=subset),
                       out_dir, coeffs, t32)
            if pending is not None:
                out_bytes += pending.result()
            pending = pack_pool.submit(*job)
            # stats count OWNED items only — a cross-host giant batch
            # contains every process's giant items (collective
            # transform), and counting them all would double-count giant
            # bytes process_count times across per-process stats
            n_packed = (len(subset) if subset is not None
                        else len(batch.items))
            n_files += n_packed
            in_bytes += n_packed * int(np.prod(batch.shape)) * 4
        if pending is not None:
            out_bytes += pending.result()
    return n_files, in_bytes, out_bytes, d2h_bytes


def _allreduce_histogram(hist: np.ndarray) -> np.ndarray:
    """Sum int64 histograms across processes.

    jax demotes int64 arrays to int32 when x64 is off, which would silently
    truncate counts past 2^31 (realistic across many processes); the gather therefore
    ships two int32 halves and recombines in int64 on host.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    halves = np.stack([(hist & 0x7FFFFFFF).astype(np.int32),
                       (hist >> 31).astype(np.int32)])
    gathered = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(halves))).reshape(jax.process_count(), 2, -1)
    gathered = gathered.astype(np.int64)
    return (gathered[:, 0].sum(0) + (gathered[:, 1].sum(0) << 31))


def compress_collected(run: common.RunData, keep: float, out_dir: str,
                       mesh=None, packer=None,
                       threshold_mode: str = "box",
                       keep_fraction: float | None = None,
                       resume: bool = False,
                       scales: int = 1,
                       payload: str = "f32",
                       transfer: str = "dense",
                       archive_format: str = "files",
                       giant_box_bytes: int | None = None) -> dict:
    """Device codec + host pack for already-collected data. Returns stats.

    ``threshold_mode``:
    - ``"box"`` (reference parity): per-(box, component) signed-absmax rule,
      ``thresh = max_val * (1 - keep)`` (compressor.cpp:212-216).
    - ``"global"`` (new TPU-native capability, BASELINE.json configs 4-5):
      one magnitude threshold for the whole run, the quantile keeping
      ``keep_fraction`` of all coefficients, computed from summed
      fixed-bin histograms (all-reduce-friendly).  The archive format is
      unchanged, so either mode decompresses identically.
    """
    eng = engine.CodecEngine(mesh=mesh, scales=scales,
                             giant_box_bytes=giant_box_bytes)
    packer = packer or engine.HostPacker(payload=payload,
                                         archive_format=archive_format)
    pad = mesh.size if mesh is not None else 1
    # multi-host fan-out: each process owns a contiguous slice of the work
    # items and writes its own shard of .xz files (the archive is a flat
    # directory, so shards compose); sidecar writes are identical on every
    # host — last-writer-wins is benign, slicing avoids duplicate codec work.
    items = list(_iter_workitems(run))
    import jax

    if jax.process_count() > 1:
        items = items[mesh_lib.process_local_slice(len(items))]
    skipped = 0

    have = _have_index(out_dir, packer.archive_format) if resume else None
    if resume and threshold_mode != "global":
        # every (t, lev, comp, box) output is an independent file written
        # after the sidecars, so a killed run restarts by skipping existing
        # outputs — the same idempotence the reference's archive layout
        # provides implicitly (SURVEY.md §7 checkpoint/resume).  In global
        # mode items are NOT filtered here: the histogram (and therefore the
        # threshold) must cover every item or a resumed archive would mix
        # two thresholds — only the pack stage skips existing files.
        kept_items = [p for p in items if not _exists(out_dir, p[0], have)]
        skipped = len(items) - len(kept_items)
        if skipped:
            log.info("Resume: skipping %d already-compressed items", skipped)
        items = kept_items
    batches = batching.plan_batches(items, pad_multiple=pad,
                                    pad_fn=eng.pad_multiple_for)
    if threshold_mode == "global":
        if keep_fraction is None:
            raise ValueError("global threshold mode requires keep_fraction")
        from wavelet_tpu.core import threshold as thr

        hist = np.zeros(thr.EXP_HIST_BINS, np.int64)
        coeff_batches = []
        for batch in batches:
            cb, h = eng.forward_hist_shapebatch(batch)
            coeff_batches.append(cb)
            hist += h
        if jax.process_count() > 1:
            # all-reduce the histogram so every host derives the
            # same global threshold
            hist = _allreduce_histogram(hist)
        t = thr.threshold_from_histogram(hist, keep_fraction)
        log.info("Global magnitude threshold (keep_fraction=%s): %s",
                 keep_fraction, t)
        n_files = 0
        in_bytes = 0
        out_bytes = 0
        for cb in coeff_batches:
            t32 = np.full(len(cb.items), t, np.float32)
            subset = None
            if resume:
                subset = [i for i, it in enumerate(cb.items)
                          if not _exists(out_dir, it, have)]
                skipped += len(cb.items) - len(subset)
            out_bytes += packer.pack(out_dir, cb, t32, subset=subset)
            n_files += len(subset) if subset is not None else len(cb.items)
            in_bytes += cb.n_valid * int(np.prod(cb.shape)) * 4
        bundle_bytes = packer.close_bundles()
        if packer.archive_format == "bundle":
            out_bytes = bundle_bytes
        return {"files": n_files, "input_bytes": in_bytes,
                "output_bytes": out_bytes, "global_threshold": float(t),
                "skipped": skipped}

    n_files, in_bytes, out_bytes, d2h = _pack_dense_or_sparse(
        batches, eng, packer, out_dir, keep, transfer)
    bundle_bytes = packer.close_bundles()
    if packer.archive_format == "bundle":
        out_bytes = bundle_bytes
    return {"files": n_files, "input_bytes": in_bytes,
            "output_bytes": out_bytes, "skipped": skipped,
            "device_to_host_bytes": d2h}


def _iter_timestep_items(meta: common.RunMeta, t: int, lv_boxes,
                         lo: int, hi: int, base: int, giant_pred=None,
                         owned_out: "set | None" = None):
    """This timestep's (WorkItem, array) pairs whose *global* item index
    falls in [lo, hi) — the multi-host slice — in the same (t, lev, box,
    comp) order as :func:`_iter_workitems`.

    ``giant_pred(dims)`` (giantmesh=global): ALSO yield out-of-slice
    items of giant shapes — their sharded transform is collective across
    processes, so every process must compute them; ``owned_out`` collects
    the in-slice WorkItems (the ones this process may write)."""
    g = base
    for li in range(len(meta.levels)):
        for b in range(meta.counts[t][li]):
            arr = lv_boxes[li].boxes[b]
            for c, comp_idx in enumerate(meta.comp_idxs):
                mine = lo <= g < hi
                if mine or (giant_pred is not None
                            and giant_pred(arr.shape[1:])):
                    item = batching.WorkItem(t=t, level=li,
                                             comp_idx=comp_idx, box=b)
                    if mine and owned_out is not None:
                        owned_out.add(item)
                    yield (item, arr[c])
                g += 1


def _iter_prefetched(n_times: int, read_one, depth: int):
    """Yield ``(t, read_one(t))`` for every timestep, reading timestep t+1
    in a background thread while the caller processes t when ``depth > 0``
    (``prefetch=1``): disk I/O overlaps the codec at the cost of holding at
    most TWO timesteps' boxes instead of one.  ``depth == 0`` reads inline
    (strict one-timestep peak RSS, the default)."""
    if depth <= 0:
        for t in range(n_times):
            yield t, read_one(t)
        return
    with cf.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(read_one, 0) if n_times else None
        for t in range(n_times):
            cur = nxt.result()
            nxt = (pool.submit(read_one, t + 1)
                   if t + 1 < n_times else None)
            yield t, cur


def _compress_streaming(cfg: common.Config, meta: common.RunMeta,
                        mesh) -> dict:
    """One-timestep-at-a-time compression: read → device codec → host pack →
    free.  Byte-identical output to :func:`compress_collected` (thresholds
    are per-item or from an order-independent summed histogram), but peak
    host RSS is bounded by the largest single timestep."""
    import jax

    eng = engine.CodecEngine(mesh=mesh, scales=cfg.scales,
                             giant_box_bytes=cfg.giant_box_bytes,
                             giant_mesh_mode=cfg.giant_mesh)
    packer = engine.HostPacker(payload=cfg.payload, codec=cfg.codec,
                               xz_preset=cfg.xz_preset,
                               xz_delta=cfg.xz_delta,
                               archive_format=cfg.archive)
    have = (_have_index(cfg.compressed_dir, cfg.archive)
            if cfg.resume else None)
    pad = mesh.size if mesh is not None else 1
    ncomp = len(meta.comp_idxs)
    per_t = [sum(meta.counts[t]) * ncomp for t in range(len(meta.files))]
    bases = np.concatenate([[0], np.cumsum(per_t)])
    total_items = int(bases[-1])
    if jax.process_count() > 1:
        sl = mesh_lib.process_local_slice(total_items)
        lo, hi = sl.start, sl.stop
    else:
        lo, hi = 0, total_items
    # giantmesh=global + multi-process: giant items are COLLECTIVE — every
    # process computes them over the global mesh (engine._giant_mesh), and
    # the `owned` set gates which process writes each payload
    crosshost = cfg.giant_mesh == "global" and jax.process_count() > 1
    giant_pred = (lambda dims: eng.giant_ok(tuple(dims))) if crosshost \
        else None

    def _t_has_giant(t):
        return any(giant_pred(d) for lev in meta.dimensions[t] for d in lev)

    def timestep_batches(t, resume_filter: bool):
        """Read timestep t and plan its batches (data freed when the
        returned batches are).  Timesteps entirely outside this process's
        item slice are skipped WITHOUT reading any FAB data — each host
        only pays I/O for its own share of the run (except cross-host
        giant timesteps, which every process must read to participate in
        the collective transform)."""
        if (bases[t + 1] <= lo or bases[t] >= hi) \
                and not (crosshost and _t_has_giant(t)):
            return [], 0, None
        lv_boxes = [plotfile.read_level(meta.files[t], lev, meta.comp_idxs)
                    for lev in meta.levels]
        owned = set() if crosshost else None
        items = list(_iter_timestep_items(meta, t, lv_boxes, lo, hi,
                                          int(bases[t]),
                                          giant_pred=giant_pred,
                                          owned_out=owned))
        n_skip = 0
        if resume_filter:
            # cross-host giant items are exempt: dropping one here would
            # desynchronize the collective transform across processes — a
            # resumed run recomputes them and atomically rewrites the
            # identical bytes
            kept = [p for p in items
                    if (giant_pred is not None
                        and giant_pred(p[1].shape))
                    or not _exists(cfg.compressed_dir, p[0], have)]
            n_skip = len(items) - len(kept)
            items = kept
        return batching.plan_batches(items, pad_multiple=pad,
                                     pad_fn=eng.pad_multiple_for), \
            n_skip, owned

    n_files = 0
    in_bytes = 0
    out_bytes = 0
    skipped = 0
    stats: dict = {}
    if cfg.threshold_mode == "global":
        if cfg.keep_fraction is None:
            raise ValueError("global threshold mode requires keep_fraction")
        from wavelet_tpu.core import threshold as thr

        # pass 1: streamed histogram.  Coefficients are RETAINED in host
        # RAM up to the globalcache budget (whole timesteps at a time, in
        # order) so pass 2 can skip re-reading + re-transforming them —
        # the round-4 verdict's "global mode costs 2x the binding
        # co-located stage" fix.  Past budget, pass 2 falls back to the
        # bounded-memory re-read.  Fixed float-bit bins merge by addition
        # across timesteps and hosts either way.
        budget = (cfg.global_cache_bytes
                  if cfg.global_cache_bytes is not None
                  else int(os.environ.get("WAVELET_TPU_GLOBALCACHE",
                                          4 << 30)))
        cache: dict = {}    # t -> (coefficient ShapeBatches, owned set)
        cache_used = 0
        hist = np.zeros(thr.EXP_HIST_BINS, np.int64)

        def _t_bytes_global(t):
            """Deterministic per-timestep PADDED size, identical on every
            process (from the headers every process reads): under
            giantmesh=global the admission decision gates COLLECTIVES
            (the pass-1 gather_giant and pass-2 re-transform), so it
            must not depend on per-process batch bytes — each process
            plans only its own item slice, and a divergent keep_t would
            have one process launch a collective its peer skips
            (deadlock).  Applies the same pad/quantum math
            plan_batches uses to the GLOBAL item multiset; any single
            process's padded allocation is <= this (its bucket counts
            are <= the global counts), so the budget still bounds
            per-process RAM — padding included."""
            from collections import Counter

            shape_counts: Counter = Counter()
            for lev in meta.dimensions[t]:
                for d in lev:
                    shape_counts[tuple(d)] += len(meta.comp_idxs)
            return sum(
                batching.dense_batch_nbytes(
                    n, shape, eng.pad_multiple_for(shape))
                for shape, n in shape_counts.items())

        for t, (batches, _, owned) in _iter_prefetched(
                len(meta.files),
                lambda t: timestep_batches(t, resume_filter=False),
                cfg.prefetch):
            # all-or-nothing per timestep: coefficient arrays are the same
            # size as the padded inputs, so the cost is known before the
            # forward runs, and pass 2 never has to re-read a plotfile for
            # just SOME of its batches
            t_bytes = (_t_bytes_global(t) if crosshost
                       else sum(b.data.nbytes for b in batches))
            keep_t = cache_used + t_bytes <= budget
            cbs = []
            for batch in batches:
                # cross-host giant batches: every process computes them,
                # but only the owner's histogram contribution counts —
                # double-counted giant coefficients would shift the
                # all-reduced global threshold
                hi_items = None
                if owned is not None and any(it not in owned
                                             for it in batch.items):
                    hi_items = [i for i, it in enumerate(batch.items)
                                if it in owned]
                # fetch_coeffs only when this timestep will be cached:
                # the histogram-only pass skips the d2h coefficient
                # fetch entirely for over-budget timesteps
                cb, h = eng.forward_hist_shapebatch(batch,
                                                    hist_items=hi_items,
                                                    fetch_coeffs=keep_t)
                hist += h
                if keep_t:
                    cbs.append(cb)
            if keep_t:
                # crosshost: cache_used must advance on EVERY process
                # whenever keep_t, even if this process's slice of the
                # timestep is empty — otherwise budgets drift apart and a
                # later giant timestep gets divergent keep_t decisions
                if batches:
                    cache[t] = (cbs, owned)
                if batches or crosshost:
                    cache_used += t_bytes
        if cache or budget:
            log.info("globalcache: retained %d/%d timesteps' coefficients "
                     "(%.2f of %.2f GiB budget); pass 2 re-reads the rest",
                     len(cache), len(meta.files), cache_used / 2**30,
                     budget / 2**30)
        stats["global_cached_timesteps"] = len(cache)
        if jax.process_count() > 1:
            hist = _allreduce_histogram(hist)
        tval = thr.threshold_from_histogram(hist, cfg.keep_fraction)
        log.info("Global magnitude threshold (keep_fraction=%s): %s",
                 cfg.keep_fraction, tval)
        stats["global_threshold"] = float(tval)

        def pass2_batches(t):
            """Cached coefficient batches, or (re-read + mark for forward).
            Popping in the (possibly prefetch-thread) reader frees each
            cached timestep as soon as it is consumed."""
            cached = cache.pop(t, None)
            if cached is not None:
                return cached[0], True, cached[1]
            b, _n, owned = timestep_batches(t, resume_filter=False)
            return b, False, owned

        # pass 2: streamed transform + pack at the one global threshold.
        # A single pack worker overlaps the host RLE+xz of batch i with the
        # device forward of batch i+1 (same pattern as _pack_dense_or_sparse;
        # one worker keeps pack order — and so bundle member order —
        # deterministic).
        bundle_bytes = 0
        with cf.ThreadPoolExecutor(1) as pack_pool:
            pending = None
            for t, (batches, is_coeff, owned) in _iter_prefetched(
                    len(meta.files), pass2_batches, cfg.prefetch):
                for batch in batches:
                    cb = (batch if is_coeff
                          else eng.forward_hist_shapebatch(batch)[0])
                    subset = None
                    if cfg.resume or owned is not None:
                        subset = [i for i, it in enumerate(cb.items)
                                  if (owned is None or it in owned)
                                  and not (cfg.resume and _exists(
                                      cfg.compressed_dir, it, have))]
                        if cfg.resume:
                            skipped += sum(
                                1 for it in cb.items
                                if (owned is None or it in owned)
                                and _exists(cfg.compressed_dir, it, have))
                        if len(subset) == len(cb.items):
                            subset = None
                    t32 = np.full(len(cb.items), tval, np.float32)
                    if pending is not None:
                        out_bytes += pending.result()
                    pending = pack_pool.submit(packer.pack,
                                               cfg.compressed_dir, cb, t32,
                                               subset=subset)
                    # packed items only: not the non-owned giant copies a
                    # cross-host batch carries, and not resume-skipped
                    # items (per-file mode filters those before batching,
                    # so its input_bytes excludes them too)
                    n_packed = (len(subset) if subset is not None
                                else len(cb.items))
                    n_files += n_packed
                    in_bytes += n_packed * int(np.prod(cb.shape)) * 4
                # a finished timestep's bundle is closed (atomic-renamed)
                # right away: a crash costs one timestep, like the per-file
                # mode (the pack worker must drain first)
                if pending is not None:
                    out_bytes += pending.result()
                    pending = None
                bundle_bytes += packer.close_bundles(t)
    else:
        d2h_bytes = 0
        bundle_bytes = 0
        for t, (batches, n_skip, owned) in _iter_prefetched(
                len(meta.files),
                lambda t: timestep_batches(t, resume_filter=cfg.resume),
                cfg.prefetch):
            skipped += n_skip
            nf, ib, ob, d2h = _pack_dense_or_sparse(
                batches, eng, packer, cfg.compressed_dir, cfg.keep,
                cfg.transfer, owned=owned)
            n_files += nf
            in_bytes += ib
            out_bytes += ob
            d2h_bytes += d2h
            bundle_bytes += packer.close_bundles(t)
        stats["device_to_host_bytes"] = d2h_bytes
        if skipped:
            log.info("Resume: skipped %d already-compressed items", skipped)
    bundle_bytes += packer.close_bundles()
    if packer.archive_format == "bundle":
        out_bytes = bundle_bytes
    stats.update({"files": n_files, "input_bytes": in_bytes,
                  "output_bytes": out_bytes, "skipped": skipped})
    return stats


def compress_run(cfg: common.Config, mesh=None) -> dict:
    """Full compression mode (modes.cpp:24-112), streaming per timestep."""
    files = common.format_files(cfg.data_dir, cfg.min_time, cfg.max_time)
    levels = common.format_levels(cfg.min_level, cfg.max_level)
    log.info("This run involves the following files:")
    for f in files:
        log.info("%s", f)

    log.info("Processing data...")
    with debug.phase_timer(
            "preprocess",
            message=("Successfully processed data in %s seconds. "
                     "Beginning compression...")) as pre:
        meta = common.collect_run_meta(files, cfg.components, levels)
        os.makedirs(cfg.compressed_dir, exist_ok=True)
        write_sidecars_meta(meta, cfg.min_level, cfg.max_level,
                            cfg.compressed_dir)
        archive.write_meta(cfg.compressed_dir,
                           threshold_mode=cfg.threshold_mode,
                           keep=cfg.keep, keep_fraction=cfg.keep_fraction,
                           scales=cfg.scales, payload=cfg.payload,
                           codec=cfg.codec, xz_preset=cfg.xz_preset,
                           xz_delta=cfg.xz_delta,
                           archive_format=cfg.archive)

    with debug.phase_timer(
            "compress", message="Compression completed in %s seconds.") as ph:
        stats = _compress_streaming(cfg, meta, mesh)
        ph.nbytes = stats["input_bytes"]
    stats["preprocess_seconds"] = pre.seconds
    stats["compress_seconds"] = ph.seconds
    return stats
