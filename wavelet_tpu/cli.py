"""Reference-compatible command line (main.cpp + argparse.cpp).

Same invocation grammar as the C++ tool: ``key=value`` pairs plus one of
``-c`` / ``-d`` / ``-estimate``::

    python -m wavelet_tpu.cli datadir=... minfile=plt00074 maxfile=plt00075 \
        minlevel=0 maxlevel=1 components="temp pressure" keep=0.999 \
        compresseddir=out/ -c

Differences from the reference (intentional): missing keys are fatal instead
of silently leaving fields uninitialized (SURVEY.md §5.6.7), and
``devices=N`` selects a mesh size for sharded execution (see the README's
key table for the other extension keys).
"""

from __future__ import annotations

import logging
import os
import sys

from wavelet_tpu.pipeline import (Config, compress_run, decompress_run,
                                  estimate_run)

__all__ = ["main", "parse_argv"]

log = logging.getLogger("wavelet_tpu")


def _kv(args):
    out = {}
    for a in args:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            out[k] = v
    return out


_USAGE = """wavelet_tpu — wavelet compression for AMReX plotfiles

Modes (one required):
  -c         compress     datadir= minfile= maxfile= minlevel= maxlevel=
                          components="..." keep= compresseddir=
  -d         decompress   compresseddir= out=
                          [minfile=/maxfile=/components=/maxlevel= partial
                           retrieval] [preview=p low-band at 1/2^p res]
                          [outprec=f64|f32 FAB real width of the output]
  -estimate  quality/size estimate (compress keys; maxfile/maxlevel optional)
  -check     archive integrity validation        compresseddir=
  -info      archive summary (no decode)         compresseddir=

Extension keys (reference-compatible defaults):
  thresholdmode=box|global  keepfraction=F   scales=S      payload=f32|q16
  codec=xz|raw  xzpreset=N  xzdelta=D        archive=files|bundle
  transfer=dense|sparse|auto  prefetch=0|1   resume=1      fastestimate=1
  giantbox=BYTES (boxes >= this shard WITHIN the box over the mesh;
                  default 1 GiB — needs devices=N > 1)
  globalcache=BYTES (global mode: host-RAM budget for caching pass-1
                  coefficients so pass 2 skips the re-read; default 4 GiB,
                  0 = always re-read)
  giantmesh=local|global (global: giant boxes shard over the whole
                  multi-process mesh — for boxes beyond one host's devices;
                  -c/-d only)
  devices=N  coordinator=host:port processes=N processid=I  profile=DIR

Sweeps (-estimate only): keep="k1 k2 ..." or keepfraction="f1 f2 ..."
"""


def parse_argv(argv):
    """-> (mode, Config) ; mode in {'c', 'd', 'estimate', 'check', 'info'}."""
    flags = {a for a in argv if a.startswith("-")}
    kv = _kv(argv)
    if "-h" in flags or "--help" in flags:
        raise SystemExit(_USAGE)
    if "-c" in flags:
        mode = "c"
    elif "-estimate" in flags:
        mode = "estimate"
    elif "-d" in flags:
        mode = "d"
    elif "-check" in flags:
        mode = "check"
    elif "-info" in flags:
        mode = "info"
    else:
        raise SystemExit("Specify a mode: -c for compression, -d for "
                         "decompression, -estimate for estimate mode, "
                         "-check for archive validation, or -info for an "
                         "archive summary! (-h for usage)")

    def need(key):
        if key not in kv:
            raise SystemExit(f"Missing {key}!")
        return kv[key]

    def transfer_key():
        t = kv.get("transfer", "dense")
        if t not in ("dense", "sparse", "auto"):
            # a typo'd transport would otherwise silently run dense
            raise SystemExit(f"Unknown transfer={t!r} (dense|sparse|auto)")
        return t

    def giantbox_key():
        if "giantbox" not in kv:
            return None
        v = int(kv["giantbox"])
        if v <= 0:
            raise SystemExit(f"giantbox={kv['giantbox']} must be a "
                             "positive byte count")
        return v

    def giantmesh_key():
        v = kv.get("giantmesh", "local")
        if v not in ("local", "global"):
            raise SystemExit(f"Unknown giantmesh={v!r} (local|global)")
        return v

    def globalcache_key():
        if "globalcache" not in kv:
            return None
        v = int(kv["globalcache"])
        if v < 0:
            raise SystemExit(f"globalcache={kv['globalcache']} must be a "
                             "non-negative byte count (0 disables)")
        return v

    cfg = Config()
    if mode in ("c", "estimate"):
        cfg.data_dir = need("datadir")
        cfg.min_time = need("minfile")
        cfg.max_time = need("maxfile") if mode == "c" else kv.get("maxfile", kv["minfile"])
        cfg.min_level = int(need("minlevel"))
        cfg.max_level = int(need("maxlevel")) if mode == "c" else int(kv.get("maxlevel", kv["minlevel"]))
        cfg.components = need("components").split()
        if not cfg.components:
            # an empty selection would surface as a numpy reshape error
            # deep in the plotfile reader
            raise SystemExit("components= must name at least one component")
        cfg.resume = kv.get("resume", "0") in ("1", "true", "yes")
        cfg.scales = int(kv.get("scales", "1"))
        cfg.payload = kv.get("payload", "f32")
        cfg.codec = kv.get("codec", "xz")
        cfg.xz_preset = int(kv.get("xzpreset", "6"))
        cfg.xz_delta = int(kv.get("xzdelta", "0"))
        cfg.archive = kv.get("archive", "files")
        cfg.transfer = transfer_key()
        cfg.prefetch = int(kv.get("prefetch", "0"))
        cfg.giant_box_bytes = giantbox_key()
        cfg.giant_mesh = giantmesh_key()
        cfg.global_cache_bytes = globalcache_key()
        cfg.device_metrics = kv.get("devicemetrics", "0") == "1"
        cfg.fast_estimate = kv.get("fastestimate", "0") == "1"
        cfg.threshold_mode = kv.get("thresholdmode", "box")
        if cfg.threshold_mode == "global":
            fracs = [float(v) for v in need("keepfraction").split()]
            if not fracs:
                raise SystemExit("Missing keepfraction!")
            if len(fracs) > 1:
                if mode != "estimate":
                    raise SystemExit(
                        "keepfraction sweep (several values) is only "
                        "valid with -estimate")
                cfg.keep_fraction_sweep = fracs
            cfg.keep_fraction = fracs[0]
            if len(kv.get("keep", "0.999").split()) > 1:
                raise SystemExit("keep sweep requires the box threshold "
                                 "mode (global mode thresholds by "
                                 "keepfraction)")
            cfg.keep = float(kv.get("keep", "0.999"))
        else:
            keeps = [float(v) for v in need("keep").split()]
            if not keeps:
                raise SystemExit("Missing keep!")
            if len(keeps) > 1:
                if mode != "estimate":
                    # a compression run writes ONE archive at ONE keep
                    raise SystemExit(
                        "keep sweep (several keep values) is only valid "
                        "with -estimate")
                cfg.keep_sweep = keeps
            cfg.keep = keeps[0]
        if mode == "c":
            cfg.compressed_dir = need("compresseddir")
        else:
            cfg.compressed_dir = kv.get("compresseddir", "")
    elif mode in ("check", "info"):
        cfg.compressed_dir = need("compresseddir")
    else:
        cfg.compressed_dir = need("compresseddir")
        cfg.out_dir = need("out")
        cfg.transfer = transfer_key()
        cfg.prefetch = int(kv.get("prefetch", "0"))
        cfg.giant_box_bytes = giantbox_key()
        cfg.giant_mesh = giantmesh_key()
        cfg.out_precision = kv.get("outprec", "f64")
        if cfg.out_precision not in ("f64", "f32"):
            raise SystemExit(
                f"Unknown outprec={cfg.out_precision!r} (f64|f32)")
        cfg.preview = int(kv.get("preview", "0"))
        if cfg.preview < 0:
            raise SystemExit(f"preview={cfg.preview} must be >= 0")
        if cfg.preview and cfg.transfer == "sparse":
            # preview ships only the tiny low-band corner already; the
            # sparse pair transport has nothing left to save there
            raise SystemExit("preview mode uses the dense transfer "
                             "(drop transfer=sparse)")
        # partial retrieval (extension): decompress only selected
        # timesteps / components / levels from the archive
        cfg.min_time = kv.get("minfile", "")
        cfg.max_time = kv.get("maxfile", "")
        if "components" in kv:
            cfg.components = kv["components"].split()
        if "maxlevel" in kv:
            cfg.levels_upto = int(kv["maxlevel"])
    return mode, cfg


def main(argv=None):
    # INFO default: a DEBUG root logger floods stdout with every jax
    # internal (cache keys, dispatch traces) — ~70 KB per small run,
    # enough to fill a 64 KB pipe and stall a coordinated multi-process
    # run whose parent drains pipes sequentially.  WAVELET_TPU_LOG=debug
    # restores the firehose when debugging.
    level_name = os.environ.get("WAVELET_TPU_LOG", "info").upper()
    level = logging.getLevelName(level_name)
    if not isinstance(level, int):    # unknown name -> fail, don't coerce
        raise SystemExit(
            f"WAVELET_TPU_LOG={level_name!r} is not a log level "
            "(debug/info/warning/error)")
    logging.basicConfig(level=level,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        mode, cfg = parse_argv(argv)
    except (KeyError, ValueError) as e:
        # malformed numeric values (minlevel=abc, keep=x, giantbox=2G …)
        # are user-input problems: the same clean error as below, not a
        # traceback from int()/float()
        log.error("bad argument: %s", e)
        return 1

    from wavelet_tpu.runtime import debug

    debug.enable_compilation_cache()
    debug.apply_env_debug_flags()

    mesh = None
    kv = _kv(argv)
    try:
        import jax

        from wavelet_tpu.runtime import mesh as mesh_lib

        if kv.get("coordinator"):
            # multi-process: coordinator=host:port processid=I processes=N
            if "processes" not in kv or "processid" not in kv:
                raise ValueError("coordinator= requires processes=N and "
                                 "processid=I")
            mesh_lib.init_distributed(kv["coordinator"],
                                      int(kv["processes"]),
                                      int(kv["processid"]))
        dev = jax.devices()[0]
        log.info("JAX backend: %s, %d device(s), kind %s", dev.platform,
                 len(jax.devices()), dev.device_kind)
        n_dev = int(kv.get("devices", "1"))
        if n_dev > 1:
            have = len(jax.devices())
            if n_dev > have:
                # jax.devices()[:n] would silently truncate and run the
                # "sharded" program on fewer devices than the user asked for
                raise ValueError(
                    f"devices={n_dev} but only {have} device(s) available")
            mesh = mesh_lib.data_mesh(jax.devices()[:n_dev])
    except (KeyError, ValueError) as e:
        log.error("bad argument: %s", e)
        return 1

    try:
        with debug.maybe_profile(kv.get("profile")):
            if mode == "c":
                compress_run(cfg, mesh=mesh)
            elif mode == "estimate":
                estimate_run(cfg, mesh=mesh)
            elif mode == "check":
                from wavelet_tpu.pipeline.check import check_run

                if check_run(cfg)["errors"]:
                    return 1
            elif mode == "info":
                from wavelet_tpu.pipeline.check import info_run

                info_run(cfg)
            else:
                decompress_run(cfg, mesh=mesh)
    except (KeyError, ValueError, OSError) as e:
        # user-input problems (bad component name, missing/corrupt archive
        # files) get a clean error instead of a traceback
        log.error("%s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
