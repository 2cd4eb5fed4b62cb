"""The on-device sparsification step (engine._compact_step).

Contract under test: per row, ``counts`` is the number of coefficients with
``|c| > t32`` and the first ``min(count, cap)`` (index, value) pairs are the
kept coefficients in ascending flat order — what the reference's threshold
+ RLE walk visits (compressor.cpp:222-234).  Both strategies are covered:
the chunked argsort (row length a multiple of 512, at least 4 chunks) and
the whole-row argsort (any other length).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from wavelet_tpu.core import haar
from wavelet_tpu.runtime import engine


def _compact(flat, t32, cap):
    return [np.asarray(x) for x in engine._compact_step(
        jnp.asarray(flat), jnp.asarray(t32), cap)]


def _assert_matches_reference(flat, t32, cap):
    counts, idx, vals = _compact(flat, t32, cap)
    assert idx.shape == vals.shape == (flat.shape[0], cap)
    for i, row in enumerate(flat):
        want = np.flatnonzero(np.abs(row) > t32[i])
        assert int(counts[i]) == len(want)
        k = min(len(want), cap)
        np.testing.assert_array_equal(idx[i, :k], want[:k])
        np.testing.assert_array_equal(vals[i, :k].view(np.int32),
                                      row[want[:k]].view(np.int32))


@pytest.mark.parametrize("m,cap", [
    (8192, 512),          # chunked: 16 chunks
    (64 ** 3, 5248),      # chunked: a 64^3 box
    (13824, 517),         # 24^3: not a multiple of 512 -> whole-row sort
    (1024, 128),          # fewer than 4 chunks -> whole-row sort
    (32 ** 3, 640),       # a 32^3 box (the AMR max_grid_size default)
])
def test_random_rows_match_reference(m, cap):
    rng = np.random.default_rng(m + cap)
    n = 6
    flat = rng.standard_normal((n, m)).astype(np.float32)
    flat[rng.random((n, m)) < 0.01] *= 100
    _assert_matches_reference(flat, np.full(n, 5.0, np.float32), cap)


def test_real_coefficients_match_reference():
    """Haar coefficients of smooth+shock fields cluster their kept
    entries in the low-band corner and along the front."""
    rng = np.random.default_rng(11)
    dim = 32
    xs = np.linspace(0, 1, dim, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    boxes = [np.sin(6 * (X - rng.random())) + np.tanh(60 * (Y - 0.5))
             for _ in range(4)]
    flat = np.asarray(haar.forward_flat(
        jnp.asarray(np.stack(boxes, dtype=np.float32))))
    m = flat.shape[1]
    kth = max(1, int(0.01 * m))
    t32 = np.partition(np.abs(flat), m - kth, axis=1)[:, m - kth - 1]
    _assert_matches_reference(flat, t32, 2048)


def test_clustered_lines_match_reference():
    """Axis-aligned worst cases: a full x-line and a full x-slab kept."""
    m, dims = 64 ** 3, (64, 64, 64)
    flat = np.zeros((2, m), np.float32)
    flat.reshape(2, *dims)[0, :, 10, 20] = 9.0     # x-line (64 kept)
    flat.reshape(2, *dims)[1, 5, :, :] = 9.0       # x-slab (4096 kept)
    _assert_matches_reference(flat, np.full(2, 1.0, np.float32), 8192)


def test_periodic_rows_match_reference():
    """Kept positions periodic in the chunk length, in one batch with a
    spread-out row and an all-below-threshold row."""
    m = 65536
    flat = np.zeros((3, m), np.float32)
    flat[0, 5::512][:40] = 50.0
    flat[1, ::97] = 50.0
    _assert_matches_reference(flat, np.full(3, 5.0, np.float32), 2048)


def test_cap_overflow_rows_report_true_count():
    """A row with more kept entries than ``cap`` reports its full count
    (the engine serves such items from the dense fallback) and still
    returns its first ``cap`` pairs."""
    m = 8192
    flat = np.zeros((2, m), np.float32)
    flat[0, ::2] = 3.0                  # 4096 kept > cap
    flat[1, 100:110] = 3.0
    _assert_matches_reference(flat, np.full(2, 1.0, np.float32), 512)


def test_negative_threshold_keeps_everything():
    """The reference's negative-absmax quirk: t32 < 0 keeps every
    coefficient, zeros included."""
    m = 4096
    flat = np.zeros((1, m), np.float32)
    flat[0, 7] = -2.0
    counts, idx, _vals = _compact(flat, np.full(1, -0.5, np.float32), m)
    assert int(counts[0]) == m
    np.testing.assert_array_equal(idx[0], np.arange(m))


def test_sparse_compress_uses_compact_step(monkeypatch):
    """compress_shapebatch_sparse sparsifies through _compact_step."""
    from wavelet_tpu.runtime import batching

    calls = {}
    orig = engine._compact_step

    def spy(*a, **kw):
        calls["hit"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "_compact_step", spy)
    rng = np.random.default_rng(0)
    entries = [(batching.WorkItem(0, 0, 0, i),
                rng.standard_normal((16, 16, 16)).astype(np.float32))
               for i in range(3)]
    [batch] = batching.plan_batches(entries)
    engine.CodecEngine().compress_shapebatch_sparse(batch, keep=0.99)
    assert calls.get("hit")
