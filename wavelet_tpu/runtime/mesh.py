"""Device mesh and sharding helpers.

Replaces the reference's (absent) distributed backend with JAX SPMD: a 1D
``data`` mesh axis over which box batches are sharded; XLA inserts the
collectives for the global reductions (per-component min/max, threshold
histograms, RMSE means) that the reference computes serially
(preprocess.cpp:81-94, modes.cpp:283-291).  The cards of one host are all
connected to each other, so the mesh follows the algorithm alone.

Multi-process: call :func:`init_distributed` before ``jax.devices()``; each
process then holds its shard of boxes and writes its shard of ``.xz``
outputs.
"""

from __future__ import annotations

import glob
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["data_mesh", "batch_sharding", "shard_batch", "init_distributed",
           "local_card_count", "process_local_slice"]

DATA_AXIS = "data"


def local_card_count() -> int:
    """Cards this host exposes, counted without starting a JAX backend
    (which ``jax.distributed.initialize`` must precede):
    ``CUDA_VISIBLE_DEVICES`` when set, else the host's ``/dev/nvidiaN``
    device files."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([v for v in visible.split(",") if v.strip()])
    return len(glob.glob("/dev/nvidia[0-9]*"))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-process JAX.

    With an explicit coordinator, each process opens exactly one local
    card, the one at its local rank ``process_id % local_card_count()``
    (one process per card, processes numbered host by host): left to
    itself every process would open every card of the host, and each
    would reserve most of each card's memory.  A host with no cards
    leaves the choice to JAX (the option concerns GPU clients only).

    Explicit topology without a coordinator address is rejected rather
    than silently dropped: ``jax.distributed.initialize()`` in
    auto-detect mode would ignore the caller's num_processes/process_id
    and (on a machine without env-based detection) come up as a 1-process
    world, mis-partitioning every process_local_slice with no error."""
    if coordinator is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "num_processes/process_id require a coordinator address "
                "(coordinator=host:port); without one jax auto-detects "
                "the topology and would ignore them")
        jax.distributed.initialize()
        return
    cards = local_card_count()
    local = [int(process_id) % cards] if cards > 0 else None
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local)


def data_mesh(devices=None) -> Mesh:
    """1D mesh over all (or the given) devices with a single ``data`` axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the mesh; trailing axes replicated."""
    return NamedSharding(mesh, P(DATA_AXIS))


def shard_batch(x, mesh: Mesh | None):
    """Device-put ``x`` sharded on its leading axis (or single-device if no
    mesh).  A leading axis not divisible by the mesh size falls back to the
    default single-device placement — the pipelines always pad to a mesh
    multiple, but direct API callers need not."""
    if mesh is None or mesh.size == 1:
        return jax.device_put(x)
    if x.shape[0] % mesh.size:
        return jax.device_put(x)
    return jax.device_put(x, batch_sharding(mesh))


def process_local_slice(n: int) -> slice:
    """This process's contiguous shard of ``n`` work items (multi-host fan-out:
    each host compresses and writes its own slice of the box list)."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n // p)
    return slice(i * per, min(n, (i + 1) * per))
