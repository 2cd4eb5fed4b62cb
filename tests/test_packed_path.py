"""The batch path: batching geometry, the strided native codec, and the
engine round trip against the scalar oracle."""

import numpy as np
import pytest

from wavelet_tpu import native
from wavelet_tpu.core import oracle
from wavelet_tpu.runtime import batching, engine


def _entries(n, dims, seed=0):
    rng = np.random.default_rng(seed)
    return [(batching.WorkItem(0, 0, 0, i),
             (rng.standard_normal(dims) * 20).astype(np.float32))
            for i in range(n)]


def test_plan_batches_packed_geometry():
    entries = _entries(5, (4, 8, 16))
    [batch] = batching.plan_batches(entries, pad_multiple=8)
    assert batch.data.shape == (8, 4, 8, 16)    # 5 -> padded to 8 items
    assert batch.n_valid == 5
    for i, (item, arr) in enumerate(entries):
        np.testing.assert_array_equal(batch.item_view(i), arr)
    assert not batch.data[5:].any()             # padding slots are zeros
    offs = batch.item_offsets()
    flat = batch.data.reshape(-1)
    for i, (item, arr) in enumerate(entries):
        assert flat[offs[i]] == arr[0, 0, 0]


@pytest.mark.skipif(not native.available(), reason="native codec not built")
def test_native_strided_pack_unpack_roundtrip(tmp_path):
    dims = (4, 8, 16)
    entries = _entries(6, dims, seed=2)
    [batch] = batching.plan_batches(entries)
    t32 = np.full(6, np.float32(0.5))
    packer = engine.HostPacker(use_native=True)
    packer.pack(str(tmp_path), batch, t32)

    dest = batching.empty_batch(batch.items, dims)
    packer.unpack_into(str(tmp_path), dest)
    for i, (item, arr) in enumerate(entries):
        want = np.where(np.abs(arr) > 0.5, arr, 0.0)
        np.testing.assert_array_equal(dest.item_view(i), want)


def test_strided_and_python_packers_agree(tmp_path):
    dims = (4, 8, 16)
    entries = _entries(4, dims, seed=3)
    [batch] = batching.plan_batches(entries)
    t32 = np.full(4, np.float32(0.25))
    d_py = tmp_path / "py"; d_py.mkdir()
    engine.HostPacker(use_native=False).pack(str(d_py), batch, t32)
    if native.available():
        d_nat = tmp_path / "nat"; d_nat.mkdir()
        engine.HostPacker(use_native=True).pack(str(d_nat), batch, t32)
        from wavelet_tpu.io import archive
        for it in batch.items:
            name = archive.payload_filename(it.t, it.level, it.comp_idx, it.box)
            a = archive.xz_decompress(open(d_nat / name, "rb").read())
            b = archive.xz_decompress(open(d_py / name, "rb").read())
            assert a == b


def test_engine_packed_roundtrip_interpret(tmp_path):
    """Engine compress -> mask -> decompress equals the scalar oracle
    bitwise, item by item."""
    dims = (4, 8, 16)
    entries = _entries(4, dims, seed=4)
    eng = engine.CodecEngine()
    [b] = batching.plan_batches(entries)
    cb, t32 = eng.compress_shapebatch(b, 0.99)
    masked = cb.data.copy()
    for i in range(4):
        want = oracle.haar_forward_oracle(entries[i][1])
        np.testing.assert_array_equal(cb.item_view(i).reshape(-1), want)
        v = masked[i]
        v[np.abs(v) <= t32[i]] = 0.0
    out = eng.decompress_shapebatch(
        batching.ShapeBatch(cb.shape, masked, cb.items, cb.n_valid))
    for i in range(4):
        want = oracle.haar_inverse_oracle(masked[i].reshape(-1), *dims)
        np.testing.assert_array_equal(out.item_view(i), want)


def test_pack_capped_for_small_buckets():
    """Small buckets pad only to the mesh quantum, and a bucket larger
    than the batch byte cap splits into quantum-multiple batches."""
    items = [(batching.WorkItem(0, 0, 0, i), np.zeros((8, 4, 2), np.float32))
             for i in range(2)]
    [b] = batching.plan_batches(items)
    assert b.data.shape[0] == 2
    [b4] = batching.plan_batches(items, pad_multiple=4)
    assert b4.data.shape[0] == 4 and b4.n_valid == 2
    big = [(batching.WorkItem(0, 0, 0, i), np.zeros((8, 8, 8), np.float32))
           for i in range(10)]
    parts = batching.plan_batches(big, pad_multiple=4,
                                  max_batch_bytes=4 * 8 ** 3 * 4)
    assert [p.data.shape[0] for p in parts] == [4, 4, 4]
    assert [p.n_valid for p in parts] == [4, 4, 2]
    assert batching.dense_batch_nbytes(10, (8, 8, 8), 4) == 12 * 8 ** 3 * 4
