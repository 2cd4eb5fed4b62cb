"""Device-stage benchmark of the codec's XLA path on one GPU.

    python bench.py            # prints one JSON object as its last line

Each stage is timed on the host clock around back-to-back calls on fresh
device inputs, ended by ``block_until_ready``, and reported as the median
of several trials:

- ``copy``: an elementwise negate of the same bytes (one read, one write)
  — the practical bandwidth ceiling the transform stages are held to;
- ``forward``: ``engine._compress_step`` (3-D Haar forward + signed
  absmax, donated input) at 128 x 64^3 and 32 x 128^3 float32;
- ``inverse``: ``engine._inverse_jit`` at the same shapes;
- ``compact``: ``engine._compact_step`` at about 1% kept (|N(0,1)| > 2.6);
- ``scatter``: ``engine._scatter_rows`` rebuilding dense rows from 2% pairs.

Rates are input bytes per second.  Roofline shares divide the bytes a stage
must move (read input + write output) by the card's published HBM rate,
taken from ``PEAK_HBM_BYTES_PER_S`` keyed by ``device_kind``; a card that
is not in the table is an error.  The forward is also checked bitwise
against the scalar oracle (core/oracle.py) on one box.  The script refuses
to run on anything but a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published HBM bandwidth by jax ``device_kind`` (NVIDIA H100 SXM data
# sheet: 80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

SHAPES = ((128, 64), (32, 128))     # (boxes, edge) of float32 cubes
KEPT_T = 2.6                        # P(|N(0,1)| > 2.6) ~= 0.93% kept


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    """The first device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


def per_call_seconds(fn, make_args, calls: int = 10, trials: int = 5):
    """Median seconds per call: ``trials`` runs of ``calls`` back-to-back
    calls, each run on freshly made inputs (``fn`` may donate them) and
    ended by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*make_args()))        # compile + warm
    runs = []
    for _ in range(trials):
        args = [make_args() for _ in range(calls)]
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        outs = [fn(*a) for a in args]
        jax.block_until_ready(outs)
        runs.append((time.perf_counter() - t0) / calls)
        del args, outs
    return float(np.median(runs))


def transform_stages(n: int, d: int, seed: int = 0) -> dict:
    """copy / forward / inverse rates at ``n`` boxes of ``d``^3 float32."""
    import jax
    import jax.numpy as jnp

    from wavelet_tpu.runtime import engine

    rng = np.random.default_rng(seed)
    host = rng.standard_normal((n, d, d, d), dtype=np.float32)
    base = jax.device_put(host)
    nbytes = host.nbytes
    fresh = jax.jit(lambda v: v * jnp.float32(1.0) + jnp.float32(0.0))
    negate = jax.jit(lambda v: -v)
    flat_base = jax.device_put(host.reshape(n, -1))
    dims = (d, d, d)
    t_copy = per_call_seconds(negate, lambda: (base,))
    t_fwd = per_call_seconds(engine._compress_step, lambda: (fresh(base),))
    t_inv = per_call_seconds(lambda f: engine._inverse_jit(f, dims),
                             lambda: (fresh(flat_base),))
    return {"shape": [n, d, d, d], "bytes": nbytes,
            "copy_s": t_copy, "forward_s": t_fwd, "inverse_s": t_inv,
            "copy_gbps": nbytes / 1e9 / t_copy,
            "forward_gbps": nbytes / 1e9 / t_fwd,
            "inverse_gbps": nbytes / 1e9 / t_inv,
            "forward_vs_copy": t_copy / t_fwd,
            "inverse_vs_copy": t_copy / t_inv}


def sparse_stages(n: int = 128, d: int = 64, seed: int = 1) -> dict:
    """Compact and scatter rates, normalized to the dense coefficient bytes
    they consume or rebuild, with each output checked against NumPy."""
    import jax
    import jax.numpy as jnp

    from wavelet_tpu.runtime import engine

    m = d ** 3
    rng = np.random.default_rng(seed)
    host = rng.standard_normal((n, m), dtype=np.float32)
    flat = jax.device_put(host)
    t32 = jnp.full((n,), KEPT_T, jnp.float32)
    # the adaptive cap settles at 1.5x the observed kept fraction
    # (engine.compress_shapebatch_sparse)
    cap = int(np.ceil(1.5 * 0.0093 * m / 128) * 128)
    nbytes = n * m * 4
    t_compact = per_call_seconds(lambda f: engine._compact_step(f, t32, cap),
                                 lambda: (flat,))
    counts, idx, vals = map(np.asarray, engine._compact_step(flat, t32, cap))
    ok = True
    for r in range(0, n, max(1, n // 8)):
        want = np.flatnonzero(np.abs(host[r]) > KEPT_T)
        k = min(len(want), cap)
        ok &= bool(int(counts[r]) == len(want)
                   and np.array_equal(idx[r, :k], want[:k])
                   and np.array_equal(vals[r, :k], host[r, want[:k]]))
    scap = int(np.ceil(0.02 * m / 128) * 128)
    sidx = np.empty((n, scap), np.int32)
    for r in range(n):
        sidx[r, : scap // 2] = np.sort(rng.choice(m, scap // 2, replace=False))
    sidx[:, scap // 2:] = m + np.arange(scap - scap // 2, dtype=np.int32)
    svals = rng.standard_normal((n, scap), dtype=np.float32)
    idx_d, vals_d = jax.device_put(sidx), jax.device_put(svals)
    t_scat = per_call_seconds(lambda i, v: engine._scatter_rows(i, v, m),
                              lambda: (idx_d, vals_d))
    rows = np.asarray(engine._scatter_rows(idx_d, vals_d, m))
    want = np.zeros((n, m), np.float32)
    np.put_along_axis(want, sidx[:, : scap // 2], svals[:, : scap // 2], 1)
    ok &= bool(np.array_equal(rows, want))
    return {"shape": [n, m], "kept_fraction": float(np.mean(counts) / m),
            "cap": cap, "compact_s": t_compact,
            "compact_gbps": nbytes / 1e9 / t_compact,
            "scatter_s": t_scat, "scatter_gbps": nbytes / 1e9 / t_scat,
            "checks_ok": ok}


def forward_matches_oracle(d: int = 32, seed: int = 2) -> bool:
    """One box through ``engine._compress_step`` against the scalar oracle,
    bitwise (every step is an add or a multiply by 0.5)."""
    import jax

    from wavelet_tpu.core import oracle
    from wavelet_tpu.runtime import engine

    box = np.random.default_rng(seed).standard_normal(
        (1, d, d, d), dtype=np.float32)
    flat, _ = engine._compress_step(jax.device_put(box))
    want = oracle.haar_forward_oracle(box[0])
    return bool(np.array_equal(np.asarray(flat)[0].view(np.int32),
                               want.view(np.int32)))


def main() -> int:
    dev = require_gpu()
    import jax

    from wavelet_tpu.runtime import debug

    debug.enable_compilation_cache()
    kind = dev.device_kind
    print(card_line(), flush=True)
    print(f"jax devices: {jax.devices()}", flush=True)
    if kind not in PEAK_HBM_BYTES_PER_S:
        raise SystemExit(f"no published peak for device_kind {kind!r}; add "
                         "it to PEAK_HBM_BYTES_PER_S with its source")
    peak = PEAK_HBM_BYTES_PER_S[kind]
    stages = [transform_stages(n, d) for n, d in SHAPES]
    for s in stages:
        for k in ("copy", "forward", "inverse"):
            s[k + "_roofline_share"] = 2 * s["bytes"] / s[k + "_s"] / peak
        print(json.dumps(s), flush=True)
    sparse = sparse_stages()
    print(json.dumps(sparse), flush=True)
    ok = forward_matches_oracle() and sparse["checks_ok"]
    print(json.dumps({
        "ok": ok, "stages": stages, "sparse": sparse,
        "device": {"platform": dev.platform, "kind": kind,
                   "count": len(jax.devices())},
        "peak_hbm_bytes_per_s": peak}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
