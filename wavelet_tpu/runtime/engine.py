"""The device codec engine: jitted, sharded compress/decompress steps.

This replaces the reference's per-box serial codec calls
(modes.cpp:100-103, 151-166).  One jit per box shape (XLA caches by shape);
batches shard their leading axis over the mesh, so the same code runs on
one device or across several unchanged.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np

from wavelet_tpu.core import haar, interleave, rle, threshold
from wavelet_tpu.io import archive, bundle
from wavelet_tpu.runtime import mesh as mesh_lib
from wavelet_tpu.runtime import batching
from wavelet_tpu.runtime.batching import ShapeBatch
from wavelet_tpu import native

log = logging.getLogger("wavelet_tpu")

__all__ = ["CodecEngine", "HostPacker", "resolve_signed_absmax"]


@functools.partial(jax.jit, donate_argnums=(0,))
def _compress_step(batch: jax.Array):
    """[N, X, Y, Z] -> (flat coeffs [N, XYZ], signed absmax [N]).

    The transform + reduction stays fused on device; the [N]-sized maxima are
    the only scalars the host needs to finish thresholding exactly
    (core/threshold.py).

    Donated input: handing XLA the input buffer lets the coefficients
    reuse it instead of allocating a second batch-sized buffer.  Every
    jitted step here whose device input is NOT reused by its caller
    donates it; ``_fwd_hist_only`` and ``_compact_step`` keep their inputs
    alive (callers re-fetch them).
    """
    flat = haar.forward_flat(batch)
    return flat, threshold.signed_absmax(flat, axis=-1)


@jax.jit
def _fwd_hist_only(coeffs: jax.Array):
    return threshold.abs_exponent_histogram(coeffs)


@jax.jit
def _rmse_step(a: jax.Array, b: jax.Array):
    """Per-item RMSE on device (north star: 'the RMSE/loss estimator runs
    on-device').  Two-stage float32 summation (rows then row-sums); the
    parity-exact double-accumulation estimator (core/metrics.py) remains the
    default — this is the fast path for large estimates."""
    n = a.shape[0]
    d = (a - b).reshape(n, -1)
    m = d.shape[1]
    sq = d * d
    # chunked summation keeps f32 error ~sqrt(chunks) smaller than naive
    chunks = max(1, m // 4096)
    pad = -m % chunks
    if pad:
        sq = jnp.pad(sq, ((0, 0), (0, pad)))
    partial_sums = jnp.sum(sq.reshape(n, chunks, -1), axis=2)
    return jnp.sqrt(jnp.sum(partial_sums, axis=1) / m)


@functools.partial(jax.jit, donate_argnums=(0,))
def _fwd_hist_step(batch: jax.Array):
    """[N, X, Y, Z] -> (flat coeffs [N, XYZ], magnitude histogram [EXP_HIST_BINS]).

    Device side of the global-threshold mode: fixed float-bit bins merge by
    addition across batches, shapes, devices and hosts.
    """
    flat = haar.forward_flat(batch)
    return flat, threshold.abs_exponent_histogram(flat)


_COMPACT_CHUNK = 512


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_step(flat: jax.Array, t32: jax.Array, cap: int):
    """On-device sparsification: keep-mask -> (counts, indices, values).

    The north-star requirement that 'coefficient sparsification/packing runs
    on-device': only ~cap entries per item cross the device->host link
    instead of the full coefficient array (kept fractions on real AMR data
    are a few percent).  Items with more than ``cap`` kept entries are
    detected host-side via ``counts`` and fall back to a dense fetch.

    Strategy: sort work scales with log^2(segment), so rows are compacted
    per 512-element CHUNK (stable argsort of ~mask within chunks) and
    assembled with an exclusive scan over per-chunk counts + a compare-all
    chunk lookup.  Rows too short or indivisible take the whole-row
    argsort (identical first-``count`` output either way).  A sort-free
    rank-select compact measured slower than this on an H100 (PERF.md).
    """
    m = flat.shape[1]
    mask = jnp.abs(flat) > t32[:, None]
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)
    c = _COMPACT_CHUNK
    if m % c or m < 4 * c:
        order = jnp.argsort(~mask, axis=1, stable=True)[:, :cap]
        vals = jnp.take_along_axis(flat, order, axis=1)
        return counts, order.astype(jnp.int32), vals
    n, C = flat.shape[0], m // c
    mch = mask.reshape(n, C, c)
    cnt = jnp.sum(mch, axis=2, dtype=jnp.int32)          # [n, C]
    offs = jnp.cumsum(cnt, axis=1) - cnt                 # exclusive scan
    order = jnp.argsort(~mch, axis=2, stable=True)       # kept-first/chunk
    ks = jnp.arange(cap, dtype=jnp.int32)
    # chunk of output slot k = last chunk whose offset <= k (broadcasted
    # compare-all over the C offsets: no gathers from long arrays)
    ch = (jnp.sum(offs[:, None, :] <= ks[None, :, None],
                  axis=2, dtype=jnp.int32) - 1)          # [n, cap]
    ch = jnp.clip(ch, 0, C - 1)
    loc = ks[None, :] - jnp.take_along_axis(offs, ch, axis=1)
    loc = jnp.clip(loc, 0, c - 1)
    j = jnp.take_along_axis(order.reshape(n, C * c), ch * c + loc, axis=1)
    idx = ch * c + j
    vals = jnp.take_along_axis(flat, idx, axis=1)
    # slots past `counts` carry in-bounds junk, exactly like the whole-row
    # argsort's tail; consumers read only the first count entries
    return counts, idx.astype(jnp.int32), vals


@functools.partial(jax.jit, static_argnames=("m",))
def _scatter_rows(idx: jax.Array, vals: jax.Array, m: int) -> jax.Array:
    """Sparse host->device decompress: per item, scatter padded (logical
    flat position, value) pairs into a zero row of m coefficients.
    Padding slots carry positions >= m (distinct per slot — the
    unique_indices contract requires ALL indices unique, including the
    dropped ones), discarded by scatter mode="drop"."""
    def one(idx_i, vals_i):
        return jnp.zeros((m,), jnp.float32).at[idx_i].set(
            vals_i, mode="drop", unique_indices=True)

    return jax.vmap(one)(idx, vals)


def _inverse_step(flat: jax.Array, dims):
    return haar.inverse_from_flat(flat, dims)


_inverse_jit = jax.jit(_inverse_step, static_argnums=1, donate_argnums=0)

_fwd_multi_jit = jax.jit(haar.haar3d_forward_multi, static_argnums=1,
                         donate_argnums=0)
_inv_multi_jit = jax.jit(haar.haar3d_inverse_multi, static_argnums=1,
                         donate_argnums=0)
# no donation: the lowpass output is 8**depth x smaller than its input, so
# the buffer could never be reused in place (donating only produces warnings)
_lowpass_jit = jax.jit(haar.haar3d_lowpass, static_argnums=1)


@dataclasses.dataclass
class SparseCoeffs:
    """Device-sparsified coefficients: per item, the kept (index, value)
    pairs in flatten order, capacity-bounded."""

    shape: tuple
    items: list
    counts: np.ndarray        # int32 [N_pad]
    idxs: np.ndarray          # int32 [N_pad, cap]
    vals: np.ndarray          # f32  [N_pad, cap]
    cap: int
    _flat_dev: object = None  # dense device array for overflow fallback

    _flat_np: object = None   # bulk dense fallback, fetched lazily once

    def transfer_bytes(self) -> int:
        """Actual device->host traffic this sparsification costs: the pair
        buffers PLUS the dense rows the overflow fallback fetches (a bulk
        fallback pulls the whole flat array once) — the honest number for
        the ``device_to_host_bytes`` stat."""
        n = len(self.items)
        total = self.counts.nbytes + self.idxs.nbytes + self.vals.nbytes
        n_over = int(np.sum(self.counts[:n] > self.cap))
        if not n_over:
            return total
        m = int(np.prod(self.shape))
        if n_over > max(2, n // 10) and self._flat_dev is not None:
            return total + int(np.prod(self._flat_dev.shape)) * 4
        return total + n_over * m * 4

    def item_pairs(self, i: int, t32_i: float):
        """(indices, values) of item i's kept coefficients."""
        k = int(self.counts[i])
        if k <= self.cap:
            return self.idxs[i, :k], self.vals[i, :k]
        # overflow: if it's widespread, one bulk fetch beats per-item round
        # trips (each costs a full host-link latency)
        if self._flat_np is None:
            n_over = int(np.sum(self.counts[: len(self.items)] > self.cap))
            if n_over > max(2, len(self.items) // 10):
                self._flat_np = np.asarray(self._flat_dev)
        if self._flat_np is not None:
            row = self._flat_np[i]
        else:
            row = np.asarray(self._flat_dev[i])
        idx = np.flatnonzero(np.abs(row) > t32_i)
        return idx.astype(np.int32), row[idx]


def resolve_signed_absmax(maxv: np.ndarray, minv: np.ndarray,
                          flat_dev=None, row_getter=None) -> np.ndarray:
    """Signed largest-|.| value from per-box (max, min) pairs.

    The giant-box path returns plain max/min reductions of its sharded
    coefficients; the signed extremum is whichever has the larger
    magnitude.  The only ambiguous case
    is an exact tie ``min == -max != 0`` where the reference picks whichever
    occurs *first* in flatten order (compressor.cpp:212-215); those rare
    boxes are resolved via ``flat_dev`` (an indexable [N, m] array) or
    ``row_getter(i)`` (per-item flat rows, e.g. strided packed views).
    """
    signed = np.where(np.abs(maxv) >= np.abs(minv), maxv, minv)
    tie = (minv == -maxv) & (maxv != 0)
    if tie.any():
        for i in np.flatnonzero(tie):
            if row_getter is not None:
                row = np.asarray(row_getter(int(i)))
            elif flat_dev is not None:
                row = np.asarray(flat_dev[int(i)])
            else:
                continue
            signed[i] = row[np.argmax(np.abs(row))]
    return signed


class CodecEngine:
    """Runs the device side of the codec over ShapeBatches.

    ``mesh=None`` uses the default device; otherwise batches are sharded on
    their leading axis (data parallelism over boxes/components/timesteps —
    the replacement for the reference's serial iterator.h).  Transforms are
    the plain jnp code of core/haar.py, compiled by XLA for whatever device
    JAX runs on; they are bitwise-identical to the reference semantics.
    """

    def __init__(self, mesh=None, scales: int = 1,
                 giant_box_bytes: int | None = None,
                 giant_mesh_mode: str = "local"):
        self.mesh = mesh
        self.scales = int(scales)
        # "local" (default): giant boxes shard over this process's
        # devices only; "global": over the whole multi-process mesh
        # (giantmesh=global, see _giant_mesh)
        self.giant_mesh_mode = giant_mesh_mode
        # boxes at or above this many bytes route through the X-sharded
        # giant-box transform when a multi-device mesh is present (the
        # single-chip batch path would need the whole box plus its
        # coefficients on one device).  CLI key: giantbox=BYTES.
        if giant_box_bytes is None:
            giant_box_bytes = int(os.environ.get("WAVELET_TPU_GIANTBOX",
                                                 1 << 30))
        self.giant_box_bytes = int(giant_box_bytes)
        self._giant_fns: dict = {}
        self._sparse_cap_hint: dict = {}   # shape -> adaptive cap fraction

    def eff_scales(self, dims) -> int:
        """Deepest pyramid this box shape supports, capped at the requested
        ``scales``.  AMR runs mix box sizes; a (8, 4, 2) box cannot take a
        2-scale transform (its z would recurse to an odd length), so each
        shape uses the deepest applicable pyramid.  Decompression derives
        the SAME value from dims + the meta ``scales``, so archives stay
        self-consistent."""
        s = self.scales
        while s > 1 and any(int(d) % (1 << s) for d in dims):
            s -= 1
        return s

    def coeff_layout(self, dims) -> str:
        """Layout the engine's coefficient batches use for this box shape:
        the X-sharded giant-box transform emits interleaved-layout
        coefficients (zero-collective pyramid; distributed.py), every
        other shape the reference's halves order."""
        return "interleaved" if self.giant_ok(dims) else "halves"

    def giant_ok(self, dims) -> bool:
        """Whether boxes of this shape route through the X-sharded
        giant-box transform (``distributed.make_sharded_box_*_interleaved``,
        the BASELINE.json config-5 'block-boundary halos' capability): a
        single box too large for one device's working set is laid out
        ``[X, Y, Z]`` with X sharded over the mesh, every pyramid pair
        shard-local (zero collectives).  Requires a multi-device mesh and
        X divisible by ``mesh.size * 2**scales`` (each shard's extent must
        hold whole pairs at every scale)."""
        gm = self._giant_mesh()
        if gm is None:
            return False
        if int(np.prod(dims)) * 4 < self.giant_box_bytes:
            return False
        eff = self.eff_scales(dims)
        return (interleave.interleaved_ok(dims, eff)
                and int(dims[0]) % (gm.size * (1 << eff)) == 0)

    _local_giant_mesh = None   # instance cache set on first use
    _global_giant_mesh = None

    def _giant_mesh(self):
        """Mesh the giant-box transform shards over.

        Default (``giant_mesh_mode="local"``): every device must be
        addressable by THIS process (the per-item ``device_put`` ships
        host data, and the coefficient fetch reads it back), so under
        multi-host the giant path uses the process's LOCAL devices: a box
        too large for one device shards within one host's devices with zero
        cross-process collectives — the multi-host fan-out keeps slicing
        work by whole boxes, each process sharding its own giant items
        locally.

        Opt-in (``giantmesh=global`` CLI key, round-4 verdict stretch
        item 8): giant boxes shard over the GLOBAL multi-process mesh —
        per-process X-slabs in via ``distributed.giant_from_process_
        slabs``, coefficients gathered back.  The tradeoff is
        explicit and logged: EVERY process serializes on each giant box's
        collective transform + gather, so this only pays for boxes beyond
        the memory of one host's devices; the pipelines make giant items
        collective across processes when this mode is on."""
        if self.giant_mesh_mode == "global" and jax.process_count() > 1:
            if CodecEngine._global_giant_mesh is None:
                CodecEngine._global_giant_mesh = mesh_lib.data_mesh(
                    jax.devices())
                log.info(
                    "giantmesh=global: giant boxes shard over all %d "
                    "devices across %d processes; every process "
                    "serializes on each giant box's collective "
                    "transform + gather (opt-in cross-host mode)",
                    CodecEngine._global_giant_mesh.size,
                    jax.process_count())
            return CodecEngine._global_giant_mesh
        m = self.mesh
        if m is not None and m.size > 1:
            pidx = jax.process_index()
            if all(d.process_index == pidx for d in m.devices.flat):
                return m
        if jax.process_count() > 1:
            if self._local_giant_mesh is None:
                loc = jax.local_devices()
                self._local_giant_mesh = (
                    mesh_lib.data_mesh(loc) if len(loc) > 1 else False)
            return self._local_giant_mesh or None
        return None

    def _giant_is_crosshost(self) -> bool:
        gm = self._giant_mesh()
        return (gm is not None
                and any(d.process_index != jax.process_index()
                        for d in gm.devices.flat))

    def _fetch_giant(self, c) -> np.ndarray:
        """Giant device array -> host numpy; an allgather when the giant
        mesh spans processes (np.asarray cannot read non-addressable
        shards), plain fetch otherwise."""
        if self._giant_is_crosshost():
            from wavelet_tpu.runtime import distributed

            return distributed.gather_giant(c)
        return np.asarray(c)

    def transfer_mode(self, dims, transfer: str) -> str:
        """Effective transport for this shape — the ONE place transport is
        decided.  ``auto`` resolves to dense: by device stage rates alone
        sparse would win on any PCIe-class link (an H100's argsort compact
        runs at ~96 GB/s and its scatter at ~1.2 TB/s of dense bytes), but
        sparse ``-c`` measured slower end to end on that card because its
        host pair packer is Python (PERF.md).  Giant boxes always take
        dense (they shard WITHIN the box; the sharded transform fetches
        their coefficients whole, so pairs cannot save anything)."""
        if transfer == "auto":
            transfer = "dense"
        if transfer == "sparse" and self.giant_ok(dims):
            return "dense"
        return transfer

    def pad_multiple_for(self, dims) -> int:
        """Batch-axis padding quantum for this shape (feeds plan_batches):
        mesh-data-parallel shapes pad to the device count so the leading
        axis shards evenly; giant shapes shard WITHIN the box, so their
        batches must not be padded with phantom giant boxes."""
        if self.mesh is None:
            return 1
        return 1 if self.giant_ok(dims) else self.mesh.size

    def _giant(self, kind: str, eff: int):
        """Cached sharded-box jits: 'fwd' / 'inv' (zero-collective
        interleaved transforms over the mesh) and 'maxmin' (sharded
        extrema; XLA inserts the all-reduce)."""
        key = (kind, eff)
        fn = self._giant_fns.get(key)
        if fn is None:
            from wavelet_tpu.runtime import distributed

            gm = self._giant_mesh()
            if kind == "fwd":
                fn = distributed.make_sharded_box_forward_interleaved(
                    gm, eff)
            elif kind == "inv":
                fn = distributed.make_sharded_box_inverse_interleaved(
                    gm, eff)
            else:
                fn = jax.jit(lambda c: (jnp.max(c), jnp.min(c)))
            self._giant_fns[key] = fn
        return fn

    def _put_giant(self, arr: np.ndarray):
        """One giant box [X, Y, Z] onto the mesh, X sharded.

        Cross-host giant mesh: every process holds the full box (the
        pipelines make giant items collective under ``giantmesh=global``)
        and contributes only its X-slab — the slab bounds come from the
        sharding's own index map, so device order never has to be
        assumed."""
        from jax.sharding import NamedSharding, PartitionSpec

        gm = self._giant_mesh()
        sh = NamedSharding(gm, PartitionSpec(mesh_lib.DATA_AXIS))
        if self._giant_is_crosshost():
            from wavelet_tpu.runtime import distributed

            pidx = jax.process_index()
            spans = [idx[0] for d, idx in
                     sh.devices_indices_map(arr.shape).items()
                     if d.process_index == pidx]
            lo = min(s.start or 0 for s in spans)
            hi = max(s.stop if s.stop is not None else arr.shape[0]
                     for s in spans)
            slab = np.ascontiguousarray(arr[lo:hi])
            return distributed.giant_from_process_slabs(gm, slab,
                                                        arr.shape)
        return jax.device_put(arr, sh)

    def _put(self, x):
        return mesh_lib.shard_batch(x, self.mesh)

    def forward_signed_batch(self, data: np.ndarray):
        """-> (coeffs f32 [N, XYZ], signed absmax f32 [N]): the transform
        and the keep-independent half of the threshold rule — a keep sweep
        (estimate mode) runs this once and derives each keep's exact
        thresholds from ``signed`` for free."""
        dev = self._put(jnp.asarray(data))
        eff = self.eff_scales(data.shape[1:])
        if eff > 1:
            c = _fwd_multi_jit(dev, eff)
            flat = c.reshape(c.shape[0], -1)
            signed = np.asarray(threshold.signed_absmax(flat, axis=-1))
        else:
            flat, signed_dev = _compress_step(dev)
            signed = np.asarray(signed_dev)
        return np.asarray(flat), signed

    def compress_batch_raw(self, data: np.ndarray, keep: float):
        """-> (coeffs f32 [N, XYZ], t32 f32 [N]): transform + exact per-item
        thresholds; masking is left to the consumer (the host packer applies
        ``|c| > t32`` during RLE, so no mask array crosses the wire)."""
        flat, signed = self.forward_signed_batch(data)
        return flat, threshold.exact_threshold32(signed, keep)

    def compress_batch(self, data: np.ndarray, keep: float):
        """-> (coeffs f32 [N, XYZ], mask bool [N, XYZ]) as NumPy arrays."""
        flat, t32 = self.compress_batch_raw(data, keep)
        return flat, np.abs(flat) > t32[:, None]

    def _compress_giant(self, batch: ShapeBatch, keep: float):
        """Giant-box compress: each item is one box X-sharded over the
        mesh, transformed with the zero-collective interleaved pyramid
        (distributed.make_sharded_box_forward_interleaved).  Coefficients,
        layout, tie resolution and thresholds are identical to the
        single-device interleaved path, so archive bytes match an
        unsharded run bit for bit (tests/test_giant_box.py)."""
        eff = self.eff_scales(batch.shape)
        fwd = self._giant("fwd", eff)
        maxmin = self._giant("maxmin", eff)
        n = batch.data.shape[0]
        log.info("Giant box path: %d box(es) of %s sharding X over %d "
                 "devices (zero collectives)", n, batch.shape,
                 self._giant_mesh().size)
        coeffs = np.empty_like(batch.data)
        maxs = np.empty(n, np.float32)
        mins = np.empty(n, np.float32)
        for i in range(n):
            c = fwd(self._put_giant(batch.data[i]))
            mx, mn = maxmin(c)
            coeffs[i] = self._fetch_giant(c)
            maxs[i], mins[i] = np.asarray(mx), np.asarray(mn)
        cb = dataclasses.replace(batch, data=coeffs, layout="interleaved",
                                 scales=eff)
        signed = resolve_signed_absmax(
            maxs, mins, row_getter=lambda i: cb.item_view(i).reshape(-1))
        return cb, threshold.exact_threshold32(signed, keep)

    def _decompress_giant(self, coeff_batch: ShapeBatch) -> ShapeBatch:
        """Inverse of :meth:`_compress_giant`: per item, interleaved
        coefficients X-sharded onto the mesh, zero-collective inverse."""
        eff = self.eff_scales(coeff_batch.shape)
        inv = self._giant("inv", eff)
        out = np.empty_like(coeff_batch.data)
        for i in range(coeff_batch.data.shape[0]):
            out[i] = self._fetch_giant(
                inv(self._put_giant(coeff_batch.data[i])))
        return dataclasses.replace(coeff_batch, data=out, layout="halves")

    def compress_shapebatch(self, batch: ShapeBatch, keep: float):
        """-> (coeff ShapeBatch — same geometry, data = coefficients,
        and t32 f32 per item incl. padding slots)."""
        if self.giant_ok(batch.shape):
            return self._compress_giant(batch, keep)
        dev = self._put(jnp.asarray(batch.data))
        eff = self.eff_scales(batch.shape)
        if eff > 1:
            c = _fwd_multi_jit(dev, eff)
            flat = c.reshape(c.shape[0], -1)
            signed = np.asarray(threshold.signed_absmax(flat, axis=-1))
            coeffs = np.asarray(c)
        else:
            flat, signed_dev = _compress_step(dev)
            coeffs = np.asarray(flat).reshape((-1,) + batch.shape)
            signed = np.asarray(signed_dev)
        t32 = threshold.exact_threshold32(signed, keep)
        return dataclasses.replace(batch, data=coeffs), t32

    def compress_shapebatch_sparse(self, batch: ShapeBatch, keep: float,
                                   cap_fraction: float | None = None):
        """Sparse-transfer compression: the transform AND sparsification run
        on device; only (counts, kept indices, kept values) come back.

        -> (SparseCoeffs, t32).  Capacity = ``cap_fraction`` of the
        coefficient count; rare overflowing items fall back to a dense
        single-row fetch (handled by :class:`SparseCoeffs.item_pairs`).
        The pair buffers are trimmed on device to the observed max kept
        count before fetching, and a batch with WIDESPREAD overflow ships
        the dense array alone (pairs would only add traffic) — sparse
        transport never fetches more than dense plus the counts.

        When ``cap_fraction`` is None it ADAPTS: the first batch of a
        shape uses 25%, later batches size the buffer to 1.5x the largest
        kept fraction observed so far (real AMR data keeps a few percent,
        so the transfer shrinks toward ~8x below the dense fetch; an
        undersized cap only costs overflow fallbacks, never correctness).

        ``scales > 1`` is supported: the pyramid transform runs on device
        and its coefficients are already in logical order.
        """
        if self.giant_ok(batch.shape):
            # self-enforcing invariant (round-5 review): transfer_mode
            # forces giant shapes dense, and coeff_layout's "interleaved"
            # answer for them means the SHARDED giant transform — routing
            # one through the per-device kernels below would run a whole
            # giant box unsharded on one device (the memory blow-up the giant
            # path exists to avoid), silently
            raise ValueError(
                f"sparse transfer does not take giant shapes {batch.shape}"
                " — transfer_mode routes them dense (sharded giant path)")
        adaptive = cap_fraction is None
        if adaptive:
            cap_fraction = self._sparse_cap_hint.get(batch.shape, 0.25)
        dims = batch.shape
        eff = self.eff_scales(dims)
        m = int(np.prod(dims))
        dev = self._put(jnp.asarray(batch.data))
        if eff > 1:
            c = _fwd_multi_jit(dev, eff)
            flat = c.reshape(c.shape[0], -1)
            signed = np.asarray(threshold.signed_absmax(flat, axis=-1))
        else:
            flat, signed_dev = _compress_step(dev)
            signed = np.asarray(signed_dev)
        t32 = threshold.exact_threshold32(signed, keep)
        # cap rounded UP to a multiple of 128, so nearby kept fractions
        # share one compiled compact
        cap = int(min(m, max(128, -(-int(m * cap_fraction) // 128) * 128)))
        counts, idxs, vals = _compact_step(flat, self._put(jnp.asarray(t32)),
                                           cap)
        counts = np.asarray(counts)
        if adaptive and batch.n_valid:
            observed = float(counts[: batch.n_valid].max()) / m
            self._sparse_cap_hint[batch.shape] = float(
                min(0.25, max(observed * 1.5, 64 / m)))
        # the counts (tiny) land first, so the transport can adapt BEFORE
        # the expensive device->host fetch.  Trim the pair buffers to the
        # observed max NON-overflowing count (overflowers never have their
        # pair rows read — item_pairs serves them from the dense fallback,
        # so one spiky box must not pin the whole batch at the cold cap);
        # power-of-2 trim widths keep the slice-op specializations bounded.
        n = batch.n_valid
        live = counts[:n][counts[:n] <= cap] if n else counts[:0]
        n_over = n - len(live)
        needed = int(live.max()) if len(live) else 0
        trim = int(min(cap, max(128, 1 << (max(needed, 1) - 1).bit_length())))
        # ship the dense array ALONE whenever pairs + the fallback fetches
        # item_pairs would actually perform (bulk flat fetch when overflow
        # is widespread — its latency heuristic — else per-item rows)
        # would cost at least as much (widespread overflow — e.g. the
        # reference's negative-absmax keep-everything quirk on zero-mean
        # fields — or even a single overflower in a tiny bucket): the
        # never-more-than-dense transport invariant
        dense_bytes = int(np.prod(flat.shape)) * 4
        fallback_bytes = (dense_bytes if n_over > max(2, n // 10)
                          else n_over * m * 4)
        pair_bytes = len(counts) * trim * 8 + fallback_bytes
        if n and n_over and pair_bytes >= dense_bytes:
            empty = np.zeros((len(counts), 0))
            return SparseCoeffs(shape=dims, items=batch.items,
                                counts=counts,
                                idxs=empty.astype(np.int32),
                                vals=empty.astype(np.float32),
                                cap=0, _flat_dev=flat,
                                _flat_np=np.asarray(flat)), t32
        if trim < cap:
            idxs, vals = idxs[:, :trim], vals[:, :trim]
            cap = trim
        return SparseCoeffs(shape=dims, items=batch.items,
                            counts=counts,
                            idxs=np.asarray(idxs), vals=np.asarray(vals),
                            cap=cap, _flat_dev=flat), t32

    def forward_hist_shapebatch(self, batch: ShapeBatch, hist_items=None,
                                fetch_coeffs: bool = True):
        """Global-threshold pass: -> (coeff ShapeBatch, histogram int64).

        ``hist_items`` (giantmesh=global only): indices whose histogram
        contribution to COUNT — cross-host giant batches are computed by
        every process, so only the owner may count each box or the
        all-reduced quantile would see giant coefficients process_count
        times.  The transform itself always runs for every item (it is
        the collective).

        ``fetch_coeffs=False`` returns ``(None, hist)`` without moving
        the coefficients device->host — the histogram-only pass 1 for
        timesteps the globalcache will NOT retain skips a full d2h pass
        (round-4 global mode paid that fetch and discarded the result)."""
        if self.giant_ok(batch.shape):
            eff = self.eff_scales(batch.shape)
            fwd = self._giant("fwd", eff)
            # phase-neutral wording: this runs in the pass-1 histogram
            # stream AND in pass-2 re-reads of uncached timesteps (where
            # the histogram output is discarded)
            log.info("Giant box path (global threshold): %d box(es) of %s "
                     "sharding X over %d devices", batch.data.shape[0],
                     batch.shape, self._giant_mesh().size)
            coeffs = np.empty_like(batch.data) if fetch_coeffs else None
            hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
            # abs_exponent_histogram accumulates uint32 on device, exact
            # only below 2^32 elements per call — and giant boxes are
            # exactly where that can be exceeded (a 16 GiB f32 box is
            # 4.3e9 coefficients; a smooth field concentrates most of
            # them in a few bins, which would WRAP silently and derive a
            # wrong global threshold).  Segment along X so each call
            # counts < 2^31 elements; the int64 accumulation happens
            # here on host.  Segment boundaries derive from the global
            # shape, so every process launches the identical collective
            # sequence.
            x, yz = int(batch.shape[0]), int(np.prod(batch.shape[1:]))
            seg = x if x * yz < (1 << 31) else max(1, (1 << 31) // yz)
            for i in range(batch.data.shape[0]):
                c = fwd(self._put_giant(batch.data[i]))
                # the histogram over global-mesh-sharded coefficients is
                # itself a collective (the reduction crosses processes),
                # so EVERY process must launch it — ownership only gates
                # whether the result is COUNTED.  Gating the launch would
                # desynchronize the SPMD program across processes (the
                # non-owner would proceed to a different collective) and
                # deadlock the run.
                h = np.zeros(threshold.EXP_HIST_BINS, np.int64)
                for lo in range(0, x, seg):
                    h += np.asarray(
                        _fwd_hist_only(c[lo:lo + seg][None]),
                        dtype=np.int64)
                if hist_items is None or i in hist_items:
                    hist += h
                if fetch_coeffs:
                    coeffs[i] = self._fetch_giant(c)
            if not fetch_coeffs:
                return None, hist
            return dataclasses.replace(batch, data=coeffs,
                                       layout="interleaved", scales=eff), hist
        if self.scales > 1:
            dev = self._put(jnp.asarray(batch.data))
            c = _fwd_multi_jit(dev, self.eff_scales(batch.shape))
            hist = np.asarray(_fwd_hist_only(c), dtype=np.int64)
            coeffs = np.asarray(c) if fetch_coeffs else None
        else:
            flat, hist = self.forward_hist_batch(
                batch.data.reshape((-1,) + batch.shape), n_pad_rows=0)
            coeffs = (np.asarray(flat).reshape((-1,) + batch.shape)
                      if fetch_coeffs else None)
            hist = np.asarray(hist, np.int64)
        # remove padding slots' zero coefficients from the zero bin
        n_pad = (batch.data.size // int(np.prod(batch.shape))) - batch.n_valid
        hist[0] -= n_pad * int(np.prod(batch.shape))
        if not fetch_coeffs:
            return None, hist
        return dataclasses.replace(batch, data=coeffs), hist

    def rmse_batch(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Per-item RMSE [N] computed on device (float32 fast path)."""
        return np.asarray(_rmse_step(self._put(jnp.asarray(a)),
                                     self._put(jnp.asarray(b))))

    def decompress_shapebatch(self, coeff_batch: ShapeBatch) -> ShapeBatch:
        """coefficients -> reconstructed boxes, same geometry (natural
        spatial layout regardless of the coefficient layout)."""
        if (self.giant_ok(coeff_batch.shape)
                and coeff_batch.layout == "interleaved"):
            return self._decompress_giant(coeff_batch)
        dev = self._put(jnp.asarray(coeff_batch.data))
        if self.scales > 1:
            out = _inv_multi_jit(dev, self.eff_scales(coeff_batch.shape))
        else:
            n = dev.shape[0]
            out = _inverse_jit(dev.reshape(n, -1),
                               tuple(int(d) for d in coeff_batch.shape))
        return dataclasses.replace(coeff_batch, data=np.asarray(out))

    def preview_shapebatch(self, batch: ShapeBatch, depth: int):
        """Low-band (LLL) preview at 1/2**depth resolution per axis.

        Extension — the reference can only regenerate full resolution
        (decompressor.cpp inverts every band unconditionally).  ``batch``
        holds LOGICAL-order coefficient rows (layout "halves", as
        :func:`HostPacker.unpack_into` fills them).  Returns
        ``(array [N, X>>depth, Y>>depth, Z>>depth], h2d_bytes)``.

        When ``depth <= eff_scales`` the preview is a pure corner slice of
        the stored pyramid plus the remaining inverse scales — only the
        corner (8**-depth of the coefficients) ever crosses the
        host->device link, and at ``depth == eff_scales`` no device work
        happens at all.  Deeper previews reconstruct fully and re-lowpass
        (``haar.haar3d_lowpass``) on device.
        """
        dims = tuple(int(d) for d in batch.shape)
        if any(d % (1 << depth) for d in dims):
            raise ValueError(
                f"preview={depth} requires box dims divisible by "
                f"{1 << depth}; got {dims}")
        s_box = self.eff_scales(dims)
        if depth > s_box and self.giant_ok(dims):
            # a deeper-than-stored preview reconstructs the FULL box on
            # one device before re-lowpassing — exactly what a giant box
            # cannot do; the corner path (depth <= scales) stays fine
            # since only 8**-depth of the coefficients reach the device
            raise ValueError(
                f"preview={depth} on a giant box {dims} would "
                f"reconstruct the whole box on one device; use preview "
                f"<= scales ({s_box}) for giant archives")
        cx, cy, cz = (d >> depth for d in dims)
        if depth <= s_box:
            corner = np.ascontiguousarray(batch.data[:, :cx, :cy, :cz])
            rem = s_box - depth
            if rem == 0:
                return corner, 0
            out = _inv_multi_jit(self._put(jnp.asarray(corner)), rem)
            return np.asarray(out), corner.nbytes
        dev = self._put(jnp.asarray(batch.data))
        h2d = batch.data.nbytes
        if s_box > 1:
            full = _inv_multi_jit(dev, s_box)
        else:
            full = _inverse_jit(dev.reshape(dev.shape[0], -1), dims)
        return np.asarray(_lowpass_jit(full, depth)), h2d

    def decompress_shapebatch_sparse(self, batch: ShapeBatch,
                                     idx: np.ndarray,
                                     vals: np.ndarray) -> ShapeBatch:
        """Sparse-transfer decompress: (logical position, value) pairs ->
        device scatter -> inverse transform.

        Only the kept pairs cross the host->device link (the mirror of the
        compress-side ``transfer=sparse`` path; kept fractions on real AMR
        data are a few percent).  The scatter builds plain logical rows for
        the same inverse as the dense path, so the output is bit-identical
        to it (same coefficients, same inverse arithmetic).
        """
        dims = tuple(int(d) for d in batch.shape)
        m = int(np.prod(dims))
        if self.giant_ok(dims):
            # mirror of the compress-side guard: transfer_mode routes
            # giant shapes dense; the per-device scatter/inverse below
            # would run a whole giant box unsharded on one device
            raise ValueError(
                f"sparse transfer does not take giant shapes {dims} — "
                "transfer_mode routes them dense (sharded giant path)")
        pad = self.mesh.size if self.mesh is not None else 1
        n = idx.shape[0]
        n_pad = (-n) % pad
        if n_pad:
            cap = idx.shape[1]
            pad_row = (m + np.arange(cap, dtype=idx.dtype))[None]
            idx = np.concatenate([idx, np.repeat(pad_row, n_pad, axis=0)])
            vals = np.concatenate(
                [vals, np.zeros((n_pad, vals.shape[1]), vals.dtype)])
        rows = _scatter_rows(self._put(jnp.asarray(idx)),
                             self._put(jnp.asarray(vals)), m)
        eff = self.eff_scales(dims)
        if eff > 1:
            out = _inv_multi_jit(rows.reshape((-1,) + dims), eff)
        else:
            out = _inverse_jit(rows, dims)
        return ShapeBatch(shape=dims, data=np.asarray(out),
                          items=batch.items, n_valid=batch.n_valid)

    def forward_hist_batch(self, data: np.ndarray, n_pad_rows: int = 0):
        """-> (flat [N, XYZ], magnitude histogram int64[EXP_HIST_BINS]).

        ``n_pad_rows`` all-zero padding rows are removed from the zero bin so
        the global quantile only counts real coefficients.
        """
        dev = self._put(jnp.asarray(data))
        eff = self.eff_scales(data.shape[1:])
        if eff > 1:
            c = _fwd_multi_jit(dev, eff)
            flat = c.reshape(c.shape[0], -1)
            hist = _fwd_hist_only(flat)
        else:
            flat, hist = _fwd_hist_step(dev)
        hist = np.asarray(hist, dtype=np.int64)
        hist[0] -= n_pad_rows * flat.shape[1]
        return np.asarray(flat), hist

    def decompress_batch(self, flat: np.ndarray, dims) -> np.ndarray:
        """flat f32 [N, X*Y*Z] -> boxes f32 [N, X, Y, Z]."""
        dims = tuple(int(d) for d in dims)
        dev = self._put(jnp.asarray(flat))
        if self.scales > 1:
            c = dev.reshape((dev.shape[0],) + dims)
            return np.asarray(_inv_multi_jit(c, self.eff_scales(dims)))
        return np.asarray(_inverse_jit(dev, dims))


def _atomic_write(path: str, blob: bytes) -> None:
    """Temp-name + rename so a crash mid-write never leaves a truncated
    output that a resumed run (resume=1) would skip as complete."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class HostPacker:
    """Parallel host-side pack/unpack + file I/O.

    Two backends with identical byte output:
    - native: the C++ library (native/wtc_codec.cpp) thresholds, RLE-packs,
      xz-encodes and writes every item on a worker pool — the framework's
      native replacement for the reference's serial per-file writes
      (compressor.cpp:250-291);
    - python: NumPy RLE + stdlib ``lzma`` (releases the GIL) on a thread
      pool, used when the shared library isn't available.

    Two archive layouts with identical member bytes:
    - ``files`` (reference-compatible): one ``.xz`` per (t, lev, comp, box);
    - ``bundle`` (extension, io/bundle.py): members appended to one
      container per (timestep, process) — removes the per-file open/write/
      rename cost that dominates once the codec runs at memory speed.
      Callers must :meth:`close_bundles` after the last pack (the pipelines
      do); unclosed bundles stay ``.tmp`` and are invisible to readers.
    """

    def __init__(self, workers: int | None = None,
                 use_native: bool | None = None, payload: str = "f32",
                 codec: str = "xz", xz_preset: int = 6,
                 archive_format: str = "files", xz_delta: int = 0):
        self.workers = workers or min(32, (os.cpu_count() or 4))
        if payload not in ("f32", "q16"):
            raise ValueError(f"unknown payload format {payload!r}")
        if codec not in ("xz", "raw"):
            raise ValueError(f"unknown payload codec {codec!r}")
        if archive_format not in ("files", "bundle"):
            raise ValueError(f"unknown archive format {archive_format!r}")
        self.payload = payload
        self.codec = codec
        # the preset word packs the optional delta-filter distance (high
        # byte); both encode backends unpack it — decode needs nothing
        # (the xz stream declares its filter chain)
        self.xz_preset = archive.pack_preset(xz_preset, xz_delta)
        self.archive_format = archive_format
        self._writers = {}          # (dir, t) -> BundleWriter
        self._bundle_sets = {}      # dir -> BundleSet (read side, lazy)
        if use_native is None:
            use_native = native.available()
        self.use_native = use_native and native.available()

    def _paths(self, dir_, items):
        return [os.path.join(dir_, archive.payload_filename(
            it.t, it.level, it.comp_idx, it.box)) for it in items]

    # ---- bundle plumbing ----

    def _writer(self, dir_: str, t: int) -> bundle.BundleWriter:
        key = (dir_, int(t))
        w = self._writers.get(key)
        if w is None:
            proc = jax.process_index()
            gen = 0
            while True:
                path = os.path.join(dir_, bundle.bundle_name(t, proc, gen))
                if not os.path.exists(path):
                    break
                # resume: finished bundles are immutable — append the
                # remaining items as a new generation
                gen += 1
            w = self._writers[key] = bundle.BundleWriter(path)
        return w

    def _append_members(self, dir_: str, items, blobs) -> int:
        """Append (item, blob) pairs in item order (deterministic bytes)."""
        total = 0
        for it, blob in zip(items, blobs):
            total += self._writer(dir_, it.t).add(
                it.t, it.level, it.comp_idx, it.box, blob)
        return total

    def close_bundles(self, t: int | None = None) -> int:
        """Finalize open bundles (index + trailer + atomic rename) — all of
        them, or only timestep ``t``'s (the streaming pipeline closes each
        timestep as it completes, so a crash costs one timestep, matching
        the per-file mode's resume granularity).  Returns total container
        bytes written."""
        total = 0
        for key in list(self._writers):
            if t is None or key[1] == int(t):
                total += self._writers.pop(key).close()
        return total

    def _bundle_set(self, dir_: str) -> bundle.BundleSet:
        bs = self._bundle_sets.get(dir_)
        if bs is None:
            bs = self._bundle_sets[dir_] = bundle.BundleSet(dir_)
        return bs

    @staticmethod
    def _geometry(batch: ShapeBatch):
        """(rows, row_len, row_stride) of one item inside batch.data: one
        contiguous run per item."""
        n = int(np.prod(batch.shape))
        return 1, n, n

    @staticmethod
    def _index_tables(batch: ShapeBatch):
        """Per-axis element-offset tables for the indexed native walk:
        logical (a, b, c) of an item lives at offsets[i] + ix[a] + iy[b]
        + iz[c] (covers the interleaved layout's per-axis permutation)."""
        x, y, z = batch.shape
        ix = interleave.interleave_perm(x) * (y * z)
        iy = interleave.interleave_perm(y) * z
        iz = interleave.interleave_perm(z)
        return ix, iy, iz

    def pack(self, out_dir: str, coeff_batch: ShapeBatch,
             t32: np.ndarray, subset=None) -> int:
        """Threshold+RLE+xz+write items of a coefficient ShapeBatch
        (padding slots ignored).  ``subset`` restricts to those item
        indices (global-mode resume: the histogram must cover every item,
        but already-written outputs are skipped here).  Returns total
        compressed bytes."""
        items = coeff_batch.items
        rows, row_len, row_stride = self._geometry(coeff_batch)
        sel = list(range(len(items))) if subset is None else list(subset)
        bundled = self.archive_format == "bundle"
        if self.use_native:
            if not sel:
                return 0
            offsets = coeff_batch.item_offsets()
            if coeff_batch.layout == "interleaved":
                if coeff_batch.scales > 1:
                    # multi-scale map is non-separable: full flat-map walk
                    if bundled:
                        blobs = native.encode_mapped(
                            coeff_batch.data, np.asarray(t32)[sel],
                            coeff_batch.shape, coeff_batch._logical_map(),
                            offsets[sel], self.workers,
                            payload=self.payload, codec=self.codec,
                            preset=self.xz_preset)
                        return self._append_members(
                            out_dir, [items[i] for i in sel], blobs)
                    return native.pack_mapped(
                        coeff_batch.data, np.asarray(t32)[sel],
                        coeff_batch.shape,
                        self._paths(out_dir, [items[i] for i in sel]),
                        coeff_batch._logical_map(), offsets[sel],
                        self.workers, payload=self.payload,
                        codec=self.codec, preset=self.xz_preset)
                ix, iy, iz = self._index_tables(coeff_batch)
                if bundled:
                    blobs = native.encode_indexed(
                        coeff_batch.data, np.asarray(t32)[sel],
                        coeff_batch.shape, ix, iy, iz, offsets[sel],
                        self.workers, payload=self.payload,
                        codec=self.codec, preset=self.xz_preset)
                    return self._append_members(
                        out_dir, [items[i] for i in sel], blobs)
                return native.pack_indexed(
                    coeff_batch.data, np.asarray(t32)[sel],
                    coeff_batch.shape,
                    self._paths(out_dir, [items[i] for i in sel]),
                    ix, iy, iz,
                    offsets[sel], self.workers, payload=self.payload,
                    codec=self.codec, preset=self.xz_preset)
            if bundled:
                blobs = native.encode_strided(
                    coeff_batch.data, np.asarray(t32)[sel],
                    coeff_batch.shape, rows, row_len, row_stride,
                    offsets[sel], self.workers, payload=self.payload,
                    codec=self.codec, preset=self.xz_preset)
                return self._append_members(
                    out_dir, [items[i] for i in sel], blobs)
            return native.pack_strided(
                coeff_batch.data, np.asarray(t32)[sel], coeff_batch.shape,
                self._paths(out_dir, [items[i] for i in sel]),
                rows, row_len, row_stride,
                offsets[sel], self.workers, payload=self.payload,
                codec=self.codec, preset=self.xz_preset)

        serialize = (archive.serialize_payload_q16 if self.payload == "q16"
                     else archive.serialize_payload)
        paths = None if bundled else self._paths(out_dir, items)

        def one(i):
            flat = np.ascontiguousarray(coeff_batch.item_view(i)).reshape(-1)
            mask = np.abs(flat) > t32[i]
            runs, vals = rle.rle_encode_mask(mask, flat)
            blob = archive.encode_blob(
                serialize(coeff_batch.shape, runs, vals),
                self.codec, self.xz_preset)
            if bundled:
                return blob
            _atomic_write(paths[i], blob)
            return len(blob)

        with cf.ThreadPoolExecutor(self.workers) as ex:
            results = list(ex.map(one, sel))
        if bundled:
            return self._append_members(
                out_dir, [items[i] for i in sel], results)
        return sum(results)

    def pack_sparse(self, out_dir: str, sparse: "SparseCoeffs",
                    t32: np.ndarray) -> int:
        """Pack from device-sparsified (index, value) pairs — no dense
        coefficient array ever reaches the host.  Bytes identical to the
        dense path (same mask, same RLE)."""
        bundled = self.archive_format == "bundle"
        paths = None if bundled else self._paths(out_dir, sparse.items)
        serialize = (archive.serialize_payload_q16 if self.payload == "q16"
                     else archive.serialize_payload)

        def one(i):
            idx, vals = sparse.item_pairs(i, float(t32[i]))
            runs = rle.rle_encode_pairs(idx)
            blob = archive.encode_blob(serialize(sparse.shape, runs, vals),
                                       self.codec, self.xz_preset)
            if bundled:
                return blob
            _atomic_write(paths[i], blob)
            return len(blob)

        with cf.ThreadPoolExecutor(self.workers) as ex:
            results = list(ex.map(one, range(len(sparse.items))))
        if bundled:
            return self._append_members(out_dir, sparse.items, results)
        return sum(results)

    def unpack_sparse(self, in_dir: str, batch: ShapeBatch):
        """Decode payloads to padded (logical position, value) pair arrays
        for the sparse-transfer decompress path: returns
        ``(idx int32 [n_items, cap], vals f32 [n_items, cap])`` where
        padding slots carry distinct positions >= X*Y*Z (dropped by the
        device scatter; distinct because the scatter asserts
        unique_indices).  Only kept pairs ever materialize — no dense rows
        on the host and only ~kept bytes over the host->device link.

        Decoding runs the Python codec path (lzma releases the GIL, so the
        thread pool still parallelizes) rather than the native dense walks
        — the mode targets rigs where the host->device LINK binds, not
        host decode; on fast-link hosts the dense path's native unpack is
        the faster choice."""
        items = batch.items
        dims = tuple(batch.shape)
        m = int(np.prod(dims))
        bundled = self.archive_format == "bundle"
        bs = self._bundle_set(in_dir) if bundled else None
        paths = None if bundled else self._paths(in_dir, items)
        deserialize = (archive.deserialize_payload_q16
                       if self.payload == "q16"
                       else archive.deserialize_payload)

        def one(i):
            if bundled:
                it = items[i]
                blob = bs.blob(it.t, it.level, it.comp_idx, it.box)
            else:
                with open(paths[i], "rb") as f:
                    blob = f.read()
            payload = archive.decode_blob(blob, self.codec)
            shape, total, runs, vals = deserialize(payload)
            if tuple(shape) != dims:
                raise ValueError(
                    f"payload shape {tuple(shape)} disagrees with "
                    f"dimensions.raw {dims}")
            if int(total) != m:
                # the dense path hits this as a reshape failure; reject the
                # corrupt header with the same clean-error contract instead
                # of silently dropping the out-of-range coefficients
                raise ValueError(
                    f"payload total {int(total)} disagrees with "
                    f"dimensions.raw volume {m}")
            # shared helper = the single home of the malformed-stream
            # semantics (reference's skip-increment rule), so sparse and
            # dense decompress can never drift apart on corrupt payloads
            pos, v = rle.rle_decode_pairs(runs, vals, total)
            return pos.astype(np.int32), v

        with cf.ThreadPoolExecutor(self.workers) as ex:
            pairs = list(ex.map(one, range(len(items))))
        cap = max([len(p) for p, _ in pairs] + [1])
        # round the pad capacity up so jit specializations are shared
        # across batches with similar kept counts — but never past the box
        # volume (a 256 floor on an m=64 box would ship MORE bytes than
        # the dense row)
        cap = min(max(256, 1 << (cap - 1).bit_length()),
                  1 << (m - 1).bit_length())
        # padding slots get distinct out-of-range positions m, m+1, ... —
        # all dropped by the device scatter, but unique as its
        # unique_indices contract requires
        idx = np.tile(m + np.arange(cap, dtype=np.int32),
                      (len(items), 1))
        vals = np.zeros((len(items), cap), np.float32)
        for i, (p, v) in enumerate(pairs):
            idx[i, :len(p)] = p
            vals[i, :len(p)] = v
        return idx, vals

    def unpack_into(self, in_dir: str, batch: ShapeBatch) -> None:
        """Read + xz-decode + RLE-scatter every item into ``batch.data``."""
        dims = batch.shape
        rows, row_len, row_stride = self._geometry(batch)
        bundled = self.archive_format == "bundle"
        if bundled:
            bs = self._bundle_set(in_dir)
            blobs = [bs.blob(it.t, it.level, it.comp_idx, it.box)
                     for it in batch.items]
        else:
            paths = self._paths(in_dir, batch.items)
        if self.use_native:
            if batch.layout == "interleaved" and batch.scales > 1:
                if bundled:
                    shapes = native.unpack_mapped_mem(
                        blobs, batch.data, batch._logical_map(),
                        batch.item_offsets(), self.workers,
                        payload=self.payload, codec=self.codec)
                else:
                    shapes = native.unpack_mapped(
                        paths, batch.data, batch._logical_map(),
                        batch.item_offsets(), self.workers,
                        payload=self.payload, codec=self.codec)
            elif batch.layout == "interleaved":
                ix, iy, iz = self._index_tables(batch)
                if bundled:
                    shapes = native.unpack_indexed_mem(
                        blobs, batch.data, ix, iy, iz,
                        batch.item_offsets(), self.workers,
                        payload=self.payload, codec=self.codec)
                else:
                    shapes = native.unpack_indexed(
                        paths, batch.data, ix, iy, iz, batch.item_offsets(),
                        self.workers, payload=self.payload,
                        codec=self.codec)
            else:
                if bundled:
                    shapes = native.unpack_strided_mem(
                        blobs, batch.data, rows, row_len, row_stride,
                        batch.item_offsets(), self.workers,
                        payload=self.payload, codec=self.codec)
                else:
                    shapes = native.unpack_strided(
                        paths, batch.data, rows, row_len, row_stride,
                        batch.item_offsets(), self.workers,
                        payload=self.payload, codec=self.codec)
            if not np.all(shapes == np.asarray(dims, np.int32)):
                raise ValueError(
                    f"payload shapes disagree with dimensions.raw {dims}")
            return

        deserialize = (archive.deserialize_payload_q16
                       if self.payload == "q16"
                       else archive.deserialize_payload)

        def one(i):
            if bundled:
                payload = archive.decode_blob(blobs[i], self.codec)
            else:
                with open(paths[i], "rb") as f:
                    payload = archive.decode_blob(f.read(), self.codec)
            shape, total, runs, vals = deserialize(payload)
            if tuple(shape) != tuple(dims):
                raise ValueError(
                    f"payload shape {shape} disagrees with dimensions.raw "
                    f"{dims}")
            batch.item_write(i, rle.rle_decode(
                runs, vals, total).reshape(dims))

        with cf.ThreadPoolExecutor(self.workers) as ex:
            list(ex.map(one, range(len(batch.items))))
