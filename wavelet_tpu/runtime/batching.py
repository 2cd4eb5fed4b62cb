"""Shape-bucketed batching of ragged AMR boxes.

XLA wants static shapes and large batches; AMR gives ragged per-level box
shapes (the fixture mixes 16x32x64 and 8x4x2 at one level).  The plan here
flattens the reference's (t, level, component, box) iteration space
(iterator.h:25-33) into one work item per *(box, component)* pair — every
item is codec-independent (SURVEY.md §2: embarrassing parallelism) — then
buckets items by box shape into dense ``[N, X, Y, Z]`` batches, padding N up
to a multiple of the mesh size so the leading axis shards evenly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import threading

import numpy as np

__all__ = ["WorkItem", "ShapeBatch", "plan_batches", "pad_to_multiple"]


@dataclass(frozen=True)
class WorkItem:
    """One (timestep, level, header-component-index, box-index) codec unit."""

    t: int
    level: int
    comp_idx: int     # plotfile-Header component index (file-name contract)
    box: int


@dataclass
class ShapeBatch:
    """A dense batch of same-shape items: ``data`` is ``[N, X, Y, Z]`` and
    ``data[i]`` belongs to ``items[i]``.

    ``n_valid`` <= N marks the unpadded prefix; padded slots are zeros and
    are ignored when unpacking results.
    """

    shape: tuple
    data: np.ndarray
    items: list               # length n_valid
    n_valid: int
    # coefficient layout: "halves" = each axis deinterleaved into
    # (low half, high half) — the reference's order; "interleaved" = lows
    # at even, highs at odd indices (the giant-box path's in-place layout;
    # the host packer walks core/interleave.interleave_perm to recover the
    # reference byte order).  ``scales`` is the pyramid depth the layout
    # encodes (the multi-scale interleaved map is non-separable; see
    # interleave.interleave_coords_multi).  Spatial (non-coefficient)
    # batches are always natural order and keep the defaults.
    layout: str = "halves"
    scales: int = 1
    # lazily built caches, EXCLUDED from dataclasses.replace (init=False):
    # the map depends on (scales, layout), which the engine routinely
    # rewrites via replace() — carrying a stale cache across a geometry
    # change would read coefficients at wrong offsets with no error
    _map_cache: object = field(default=None, init=False, repr=False,
                               compare=False)
    _offsets_cache: object = field(default=None, init=False, repr=False,
                                   compare=False)

    def _logical_map(self):
        """Flat logical->physical element offsets within an item region
        (cached: it is O(X*Y*Z) to build and shared by every item)."""
        if self._map_cache is None:
            from wavelet_tpu.core.interleave import interleave_map_multi

            x, y, z = self.shape
            self._map_cache = interleave_map_multi(
                self.shape, self.scales, y * z, z, 1)
        return self._map_cache

    def item_view(self, i: int) -> np.ndarray:
        """Item i's (X, Y, Z) array in LOGICAL (reference) order.

        A view into ``data`` for natural layouts; a gathered copy for
        ``layout == "interleaved"`` coefficient batches."""
        if self.layout != "interleaved":
            return self.data[i]
        x, y, z = self.shape
        off = int(self.item_offsets()[i])
        flat = self.data.reshape(-1)
        return flat[off + self._logical_map()].reshape(x, y, z)

    def item_write(self, i: int, logical: np.ndarray) -> None:
        """Store item i from a LOGICAL-order (X, Y, Z) array (scatters
        through the interleave map when needed)."""
        if self.layout != "interleaved":
            self.data[i] = logical
            return
        off = int(self.item_offsets()[i])
        flat = self.data.reshape(-1)
        flat[off + self._logical_map()] = logical.reshape(-1)

    def item_offsets(self) -> np.ndarray:
        """Flat-element offset of each item's first coefficient (for the
        native codec).  Cached — per-item accessors call this once per
        item."""
        if self._offsets_cache is None:
            n = len(self.items)
            self._offsets_cache = (np.arange(n, dtype=np.int64)
                                   * int(np.prod(self.shape)))
        return self._offsets_cache


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m if m > 1 else n


def dense_batch_nbytes(n_items: int, dims, pad_multiple: int = 1) -> int:
    """Bytes of the padded dense array :func:`empty_batch` would allocate
    — for transport-cost decisions without allocating it."""
    return pad_to_multiple(n_items, pad_multiple) * int(np.prod(dims)) * 4


class BufferArena:
    """Recycles decompress-side batch buffers across shape buckets and
    timesteps.

    A fresh ``np.zeros`` costs one page fault per 4 KiB on first write;
    measured on the build host that roughly HALVES the native unpack rate
    (host_codec.json cold vs warm rows).  Decompression regenerates the
    same shape buckets every timestep, so recycling turns every unpack
    after the first timestep into a warm-buffer run.

    Contract: ``release(arr)`` only after the device step that read the
    buffer has completed (the engine fetches results via ``np.asarray``
    before returning, so releasing after the pipeline's device stage is
    safe even with the prefetch worker unpacking the next bucket
    concurrently — that one acquires a different buffer by construction).

    Retention is generation-bounded: the pipeline calls
    :meth:`new_generation` at every timestep boundary, and a buffer idle
    for one full generation is dropped — an AMR dataset that REGRIDS
    (box shapes changing across timesteps) therefore cannot accumulate
    dead shapes without bound (round-4 review finding); retained bytes
    are bounded by the last two timesteps' buffers, the same bound
    ``prefetch=1`` already documents for peak RSS.
    """

    def __init__(self, keep_generations: int = 1):
        self._free: dict = {}          # shape -> [(gen_released, arr), ...]
        self._gen = 0
        self._keep = int(keep_generations)
        # acquire/release run from host-stage worker threads concurrently
        # with the main thread; new_generation rebuilds the free lists.
        # The lock makes all three safe regardless of caller thread — the
        # pipelines happen to call new_generation only after the per-
        # timestep pool has drained, but that contract was implicit and
        # one future caller away from double-handing a buffer (round-4
        # advisor finding).
        self._lock = threading.Lock()

    def acquire(self, shape) -> "np.ndarray | None":
        with self._lock:
            lst = self._free.get(tuple(shape))
            return lst.pop()[1] if lst else None

    def release(self, arr) -> None:
        if arr is not None and isinstance(arr, np.ndarray) \
                and arr.dtype == np.float32:
            with self._lock:
                self._free.setdefault(arr.shape, []).append((self._gen, arr))

    def new_generation(self) -> None:
        """Timestep boundary: evict buffers released more than
        ``keep_generations`` generations ago (i.e. never reacquired for a
        full timestep — the shapes a regrid left behind).  Thread-safe
        (guarded by the same lock as acquire/release), though buffers a
        worker still holds are naturally outside the arena's view."""
        with self._lock:
            self._gen += 1
            cut = self._gen - self._keep
            for shape in list(self._free):
                kept = [e for e in self._free[shape] if e[0] >= cut]
                if kept:
                    self._free[shape] = kept
                else:
                    del self._free[shape]


def empty_batch(items, dims, pad_multiple: int = 1,
                layout: str = "halves", scales: int = 1,
                arena: "BufferArena | None" = None) -> ShapeBatch:
    """Zero-filled ShapeBatch for ``items`` of one shape (decompress side).

    With ``arena``, a recycled buffer may be returned instead: only the
    padding slots (which ``unpack_into`` never rewrites — every real item's
    full footprint is) are re-zeroed."""
    n = len(items)
    arr_shape = (pad_to_multiple(n, pad_multiple),) + tuple(dims)
    data = arena.acquire(arr_shape) if arena is not None else None
    if data is None:
        data = np.zeros(arr_shape, dtype=np.float32)
    else:
        data[n:] = 0.0
    return ShapeBatch(shape=tuple(dims), data=data, items=list(items),
                      n_valid=n, layout=layout, scales=scales)


def plan_batches(entries, pad_multiple: int = 1, max_batch_bytes: int = 1 << 30,
                 pad_fn=None):
    """Group ``entries`` = iterable of (WorkItem, array[X,Y,Z] f32) into
    :class:`ShapeBatch` es.

    Batches are split so none exceeds ``max_batch_bytes``; N pads to a
    multiple of ``pad_multiple`` so the leading axis shards evenly over
    the mesh.  ``pad_fn(shape) -> int`` overrides ``pad_multiple`` per
    shape (``engine.pad_multiple_for``: giant shapes shard within the box,
    so their batches must not pad phantom giant boxes onto the leading
    axis).
    """
    buckets = {}
    for item, arr in entries:
        shape = tuple(arr.shape)
        buckets.setdefault(shape, []).append((item, arr))

    batches = []
    for shape in sorted(buckets, key=lambda s: (-int(np.prod(s)), s)):
        pairs = buckets[shape]
        quantum = int(pad_fn(shape)) if pad_fn is not None else pad_multiple
        per_item = int(np.prod(shape)) * 4
        chunk = max(quantum, (max_batch_bytes // max(per_item, 1)) or 1)
        # round DOWN to the quantum so a chunk never exceeds
        # max_batch_bytes by up to quantum-1 items (the unavoidable
        # single-quantum minimum is the only sanctioned overshoot)
        chunk = max(quantum, chunk - chunk % quantum)
        for start in range(0, len(pairs), chunk):
            part = pairs[start : start + chunk]
            n = len(part)
            data = np.zeros((pad_to_multiple(n, quantum),) + shape,
                            dtype=np.float32)
            for i, (_item, arr) in enumerate(part):
                data[i] = arr
            batches.append(ShapeBatch(shape=shape, data=data,
                                      items=[it for it, _ in part],
                                      n_valid=n))
    return batches
