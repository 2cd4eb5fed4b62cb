"""Archive inspection: ``-check`` (integrity) and ``-info`` (summary).

Neither has a reference analogue.  ``-check`` walks a compressed archive
WITHOUT decompressing boxes to full data: validates the five sidecars'
mutual consistency, then every payload's container, header, and RLE
stream (decodable, shape agrees with ``dimensions.raw``, total count
matches, runs non-negative and in-bounds).  The operational tool for
large archives: a damaged or partially-written archive is diagnosed
file-by-file in one pass instead of failing mid-decompression.
``-info`` prints what an archive CONTAINS (timesteps, levels, components,
flavor, sizes, compression ratio) from sidecar metadata alone — no
payload is ever decoded.
"""

from __future__ import annotations

import logging
import lzma
import os

import numpy as np

from wavelet_tpu.io import archive
from wavelet_tpu.pipeline import common

log = logging.getLogger("wavelet_tpu")

__all__ = ["check_run", "info_run"]


def _check_payload(blob_or_path, dims, meta) -> str | None:
    """Returns an error string, or None if the payload is sound.  Accepts a
    file path (per-file archives) or member bytes (bundle archives)."""
    if isinstance(blob_or_path, str):
        if not os.path.exists(blob_or_path):
            return "missing payload file"
        try:
            with open(blob_or_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            return f"payload read failed: {e}"
    else:
        blob = blob_or_path
    try:
        payload = archive.decode_blob(blob, meta.get("codec", "xz"))
    except (ValueError, lzma.LZMAError, OSError) as e:
        return f"container decode failed: {e}"
    q16 = meta.get("payload") == "q16"
    head = 24 if q16 else 20
    pair_bytes0 = 6 if q16 else 8
    if len(payload) < head:
        return f"payload shorter than header ({len(payload)} B)"
    import struct

    n_pairs = struct.unpack_from("<i", payload, 16)[0]
    if n_pairs < 0:
        return f"negative pair count ({n_pairs})"
    if len(payload) < head + n_pairs * pair_bytes0:
        return (f"pair stream truncated (header claims {n_pairs} pairs, "
                f"{len(payload)} bytes)")
    try:
        if q16:
            shape, total, runs, _vals = archive.deserialize_payload_q16(
                payload)
        else:
            shape, total, runs, _vals = archive.deserialize_payload(payload)
    except Exception as e:  # noqa: BLE001 — any malformed header
        return f"payload deserialize failed: {e}"
    if tuple(shape) != tuple(dims):
        return f"payload shape {tuple(shape)} != dimensions.raw {tuple(dims)}"
    if total != int(np.prod(dims)):
        return f"total {total} != prod(shape) {int(np.prod(dims))}"
    if len(runs):
        runs64 = np.asarray(runs, np.int64)
        if runs64.min() < 0:
            return "negative RLE run"
        pos = np.cumsum(runs64 + 1) - 1
        if pos[-1] >= total:
            return f"RLE positions overflow total ({int(pos[-1])} >= {total})"
    return None


def info_run(cfg: common.Config) -> dict:
    """Summarize ``cfg.compressed_dir`` from sidecars + wtc-meta.json only.

    Logs a human-readable report and returns the same facts as a dict:
    what's archived (timesteps, levels, components with their Header
    indices), the codec flavor, payload/sidecar bytes on disk, the raw
    float32 equivalent (sum of box volumes x components x 4 B — what the
    reference's estimate mode calls the data size, modes.cpp:294-324),
    and the resulting size percentage.
    """
    d = cfg.compressed_dir
    info = archive.read_runinfo(d)
    if not info.files:
        # a zero-file runinfo parses cleanly; report it instead of an
        # IndexError at the Timesteps line below
        raise ValueError(f"{d}: archive records zero timesteps "
                         "(runinfo.raw file count is 0)")
    levels = common.format_levels(info.min_level, info.max_level)
    counts = archive.read_boxcounts(d, len(info.files), len(levels))
    dimensions = archive.read_locdim(d, "dimensions.raw", counts)
    amrex = archive.read_amrexinfo(d)
    if len(amrex.true_times) < len(info.files):
        # the same inconsistency check_run reports; -info must not die
        # with an IndexError in the per-time loop
        raise ValueError(
            f"{d}: amrexinfo.raw records {len(amrex.true_times)} times "
            f"but runinfo.raw records {len(info.files)} files")
    meta = archive.read_meta(d)

    bundled = meta.get("archive") == "bundle"
    bundle_set = None
    if bundled:
        from wavelet_tpu.io import bundle as bundle_mod

        bundle_set = bundle_mod.BundleSet(d)

    n_members = 0
    missing = 0
    payload_bytes = 0
    raw_bytes = 0
    per_time = []
    ncomp = len(info.comp_idxs)
    for t in range(len(info.files)):
        t_members = 0
        t_payload = 0
        t_raw = 0
        t_boxes = 0
        for li in range(len(levels)):
            for b in range(counts[t][li]):
                vol = int(np.prod(dimensions[t][li][b]))
                t_raw += vol * 4 * ncomp
                t_boxes += 1
                for comp_idx in info.comp_idxs:
                    if bundled:
                        loc = bundle_set.locate(t, li, comp_idx, b)
                        if loc is None:
                            missing += 1
                            continue
                        t_payload += loc[2]
                    else:
                        p = os.path.join(
                            d, archive.payload_filename(t, li, comp_idx, b))
                        if not os.path.exists(p):
                            missing += 1
                            continue
                        t_payload += os.path.getsize(p)
                    t_members += 1
        n_members += t_members
        payload_bytes += t_payload
        raw_bytes += t_raw
        per_time.append({"file": os.path.basename(info.files[t]),
                         "time": float(amrex.true_times[t]),
                         "boxes": t_boxes, "members": t_members,
                         "payload_bytes": t_payload, "raw_bytes": t_raw})

    sidecar_bytes = sum(
        os.path.getsize(os.path.join(d, n))
        for n in ("runinfo.raw", "locations.raw", "dimensions.raw",
                  "boxcounts.raw", "amrexinfo.raw")
        if os.path.exists(os.path.join(d, n)))
    if bundled:
        # container framing (member headers + index) counts as archive cost
        from wavelet_tpu.io import bundle as bundle_mod

        container_bytes = sum(
            os.path.getsize(os.path.join(d, n))
            for n in bundle_mod.list_bundles(d))
    else:
        container_bytes = payload_bytes
    total_bytes = sidecar_bytes + max(container_bytes, payload_bytes)
    size_pct = 100.0 * total_bytes / raw_bytes if raw_bytes else 0.0

    flavor = {k: meta.get(k) for k in
              ("codec", "payload", "archive", "scales", "threshold_mode",
               "xz_preset", "xz_delta") if meta.get(k) is not None}
    log.info("Archive: %s", d)
    log.info("Flavor: %s", " ".join(f"{k}={v}" for k, v in flavor.items()))
    log.info("Timesteps: %d (%s .. %s), levels %d-%d, components %s "
             "(header idxs %s)", len(info.files),
             os.path.basename(info.files[0]),
             os.path.basename(info.files[-1]), info.min_level,
             info.max_level, info.components, info.comp_idxs)
    for row in per_time:
        log.info("  %-12s t=%-12g boxes=%-5d members=%-6d payload=%d B",
                 row["file"], row["time"], row["boxes"], row["members"],
                 row["payload_bytes"])
    log.info("Payload members: %d (%d missing); payload %d B + sidecars "
             "%d B = %d B archived for %d B raw float32 (%.4f %%)",
             n_members, missing, payload_bytes, sidecar_bytes, total_bytes,
             raw_bytes, size_pct)
    return {"dir": d, "flavor": flavor, "times": len(info.files),
            "levels": levels, "components": list(info.components),
            "comp_idxs": list(info.comp_idxs), "members": n_members,
            "missing": missing, "payload_bytes": payload_bytes,
            "sidecar_bytes": sidecar_bytes, "total_bytes": total_bytes,
            "raw_bytes": raw_bytes, "size_pct": size_pct,
            "per_time": per_time}


def check_run(cfg: common.Config) -> dict:
    """Validate ``cfg.compressed_dir``; returns {'files': n, 'errors': [...]}.

    Sidecar problems are fatal (reported and returned immediately — the
    payload walk needs their geometry); payload problems are collected
    per file.
    """
    errors: list[str] = []
    d = cfg.compressed_dir
    try:
        info = archive.read_runinfo(d)
        levels = common.format_levels(info.min_level, info.max_level)
        counts = archive.read_boxcounts(d, len(info.files), len(levels))
        locations = archive.read_locdim(d, "locations.raw", counts)
        dimensions = archive.read_locdim(d, "dimensions.raw", counts)
        amrex = archive.read_amrexinfo(d)
        meta = archive.read_meta(d)
    except (ValueError, OSError) as e:
        log.error("sidecar error: %s", e)
        return {"files": 0, "errors": [f"sidecar: {e}"]}

    # sidecar integrity (extension: wtc-meta.json records each .raw
    # sidecar's CRC32 — the reference layout itself has no checksums, so
    # this is the only way a bit flip in e.g. locations.raw is caught
    # rather than silently shifting geometry)
    import zlib

    for name, want in meta.get("sidecar_crc32", {}).items():
        p = os.path.join(d, name)
        if not os.path.exists(p):
            errors.append(f"{name}: recorded in sidecar_crc32 but missing")
            continue
        with open(p, "rb") as f:
            got = zlib.crc32(f.read()) & 0xFFFFFFFF
        if got != int(want):
            errors.append(f"{name}: CRC32 mismatch (sidecar corrupted)")

    # sidecar cross-consistency
    if len(amrex.true_times) != len(info.files):
        errors.append(
            f"amrexinfo has {len(amrex.true_times)} times for "
            f"{len(info.files)} files")
    if len(info.components) != len(info.comp_idxs):
        errors.append("runinfo components/comp_idxs length mismatch")
    # read_locdim already rejects SHORT files; flag trailing excess too
    # (a sign of a boxcounts/locations disagreement the reads can't see)
    need = 3 * 4 * sum(int(c) for per in counts for c in per)
    for name in ("locations.raw", "dimensions.raw"):
        size = os.path.getsize(os.path.join(d, name))
        if size != need:
            errors.append(
                f"{name}: {size} bytes but boxcounts.raw implies {need}")

    bundled = meta.get("archive") == "bundle"
    bundle_set = None
    if bundled:
        from wavelet_tpu.io import bundle as bundle_mod

        try:
            bundle_set = bundle_mod.BundleSet(d)
        except (ValueError, OSError) as e:
            # OSError too: a bundle deleted/truncated at the OS level must
            # be a recorded finding, not a traceback — -check exists to
            # diagnose damaged archives
            log.error("bundle error: %s", e)
            return {"files": 0, "errors": errors + [f"bundle: {e}"]}

    def one(t, li, b, comp_idx):
        """-> (payload name, error string or None) for one member."""
        dims = dimensions[t][li][b]
        name = archive.payload_filename(t, li, comp_idx, b)
        if bundled:
            try:
                blob = bundle_set.blob(t, li, comp_idx, b)
            except FileNotFoundError:
                return name, "missing bundle member"
            except (OSError, ValueError) as e:
                return name, f"bundle member read failed: {e}"
            return name, _check_payload(blob, dims, meta)
        return name, _check_payload(os.path.join(d, name), dims, meta)

    walk = [(t, li, b, c)
            for t in range(len(info.files))
            for li in range(len(levels))
            for b in range(counts[t][li])
            for c in info.comp_idxs]
    # the xz decode releases the GIL, so a thread pool checks a large
    # archive ~cores x faster than the old serial walk; map() preserves
    # walk order, so the errors list stays deterministic
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        results = list(pool.map(lambda a: one(*a), walk))
    n_files = len(results)
    errors.extend(f"{name}: {err}" for name, err in results if err)
    for e in errors:
        log.error("%s", e)
    if errors:
        log.error("Archive check FAILED: %d problem(s) in %d payloads",
                  len(errors), n_files)
    else:
        log.info("Archive check passed: %d payloads sound", n_files)
    return {"files": n_files, "errors": errors}
