"""wavelet_tpu — wavelet compression for AMReX AMR plotfiles on the GPU.

A JAX/XLA re-design of the capabilities of the carsonmw3/wavelet-compression
C++ tool:

- ``io``        AMReX plotfile (FAB) reader/writer, the compressed-archive
                byte formats (sidecars + per-box ``.xz`` payloads) and the
                seeded dataset generator, pure host Python/NumPy.
                (reference: preprocess.cpp, writeplotfile.cpp,
                readandwrite.cpp)
- ``core``      The codec math: batched 3D Haar transform (and its in-place
                interleaved form), exact-parity thresholding, RLE, metrics.
                Device code is plain jnp over ``[N, X, Y, Z]`` batches.
                (reference: compressor.cpp, decompressor.cpp, calc-loss.cpp)
- ``runtime``   Device mesh + sharding, shape-bucketed batching of ragged AMR
                boxes, host-side parallel pack/unpack executor.  (the
                reference has no runtime layer: iterator.h is a serial loop)
- ``pipeline``  The end-to-end modes: compress / decompress / estimate /
                check / info.  (reference: modes.cpp)

Unlike the reference — a serial, single-process CPU tool — this framework
batches same-shape boxes into dense ``[N, X, Y, Z]`` arrays, shards the batch
axis across a ``jax.sharding.Mesh`` of devices, computes thresholds with
XLA collectives, and keeps all transform math on device.
"""

__version__ = "0.1.0"

# Public programmatic API (api.py) — resolved lazily so that
# ``import wavelet_tpu`` stays free of jax/pipeline imports until a mode
# function or Config is actually touched.
_API_NAMES = ("compress", "decompress", "estimate", "check", "info")


def __getattr__(name):
    if name in _API_NAMES:
        from wavelet_tpu import api
        return getattr(api, name)
    if name == "Config":
        from wavelet_tpu.pipeline.common import Config
        return Config
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES) + ["Config"])
