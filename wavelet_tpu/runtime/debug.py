"""Observability and debugging aids (SURVEY.md §7 auxiliary subsystems).

The reference's tooling is coarse wall-clock phase logs (modes.cpp:35-95)
and ASan in debug builds.  Equivalents here:

- :func:`maybe_profile`: wraps a region in a ``jax.profiler`` trace when a
  directory is given (CLI key ``profile=DIR``); view with TensorBoard or
  xprof.
- debug switches via environment (no code changes needed at call sites):
  ``WAVELET_TPU_DEBUG_NANS=1`` enables ``jax_debug_nans`` (the analogue of
  the reference's sanitizer builds for numeric bugs) and
  ``WAVELET_TPU_DISABLE_JIT=1`` runs op-by-op for step debugging.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

log = logging.getLogger("wavelet_tpu")


# A fixed path: the cache directory is part of JAX's cache key, so a
# directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    no directory is set here; otherwise the cache lives at
    :data:`DEFAULT_CACHE_DIR` (``.jax_cache/`` in the checkout)."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def apply_env_debug_flags() -> None:
    """Install debug configuration from environment variables (call once at
    CLI startup; harmless if repeated)."""
    import jax

    if os.environ.get("WAVELET_TPU_DEBUG_NANS", "0") == "1":
        jax.config.update("jax_debug_nans", True)
        log.info("jax_debug_nans enabled")
    if os.environ.get("WAVELET_TPU_DISABLE_JIT", "0") == "1":
        jax.config.update("jax_disable_jit", True)
        log.info("jit disabled (op-by-op debugging mode)")


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Profile the enclosed region into ``trace_dir`` if set, else no-op."""
    if not trace_dir:
        yield
        return
    import jax

    log.info("Capturing jax.profiler trace to %s", trace_dir)
    with jax.profiler.trace(trace_dir):
        yield


class _Phase:
    """Mutable handle yielded by :func:`phase_timer`; set ``nbytes`` inside
    the block to get a GB/s figure, read ``seconds`` after it."""

    def __init__(self, nbytes):
        self.nbytes = nbytes
        self.seconds = 0.0


@contextlib.contextmanager
def phase_timer(name: str, nbytes: int | None = None,
                message: str | None = None):
    """Log a phase's wall time (and GB/s when a byte count is given) — this
    build's version of the reference's chrono phase logs (modes.cpp:93,
    107, 170), plus the throughput figure BASELINE.json's metric asks for.

    ``message`` overrides the default "name: N s" wording with a reference-
    parity log line (one ``%s`` placeholder receives the seconds)."""
    ph = _Phase(nbytes)
    t0 = time.perf_counter()
    yield ph
    ph.seconds = time.perf_counter() - t0
    text = (message % ph.seconds) if message else f"{name}: {ph.seconds:.3f} s"
    if ph.nbytes:
        text += " (%.3g GB/s)" % (ph.nbytes / 1e9 / max(ph.seconds, 1e-12))
    log.info("%s", text)
