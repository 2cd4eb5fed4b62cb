"""Execution runtime: device mesh, shape-bucketed batching, codec engine.

The reference has no runtime layer — its entire scheduler is a serial
``for t / for level / for box`` loop (iterator.h:25-33).  Here the iteration
space is flattened into shape-bucketed ``[N, X, Y, Z]`` batches that shard
across a ``jax.sharding.Mesh`` of devices.
"""
