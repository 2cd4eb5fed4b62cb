"""Multi-device tests on the virtual 8-way CPU mesh (SURVEY.md §6: the
reference offers no distributed precedent; this is a new design obligation)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wavelet_tpu.core import haar, threshold
from wavelet_tpu.runtime import batching, distributed, engine, mesh as mesh_lib


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return mesh_lib.data_mesh(devs[:8])


def test_sharded_parity_step_matches_single_device(mesh8):
    rng = np.random.default_rng(0)
    batch = rng.standard_normal((16, 8, 8, 8)).astype(np.float32)
    step = distributed.make_parity_compress_step(mesh8)
    flat_s, max_s = step(mesh_lib.shard_batch(batch, mesh8))
    flat_1 = np.asarray(haar.forward_flat(jnp.asarray(batch)))
    np.testing.assert_array_equal(np.asarray(flat_s), flat_1)
    np.testing.assert_array_equal(
        np.asarray(max_s),
        np.asarray(threshold.signed_absmax(jnp.asarray(flat_1), axis=-1)))


def test_global_threshold_collective_matches_unsharded(mesh8):
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((8, 4, 4, 4)).astype(np.float32)
    gstep = distributed.make_global_compress_step(mesh8, 0.1)
    masked, thr, kept = gstep(mesh_lib.shard_batch(batch, mesh8))
    # unsharded oracle: same histogram quantile over the whole batch
    flat = haar.forward_flat(jnp.asarray(batch))
    thr1 = threshold.global_histogram_threshold(flat, 0.1)
    assert float(thr) == pytest.approx(float(thr1), rel=1e-6)
    # kept comes back as two 16-bit limb sums (int32 psum of raw counts
    # would wrap past 2^31 global kept on large meshes)
    frac = distributed.kept_count(kept) / batch.size
    assert 0.05 < frac < 0.2


def test_train_step_runs_and_reduces(mesh8):
    rng = np.random.default_rng(2)
    batch = rng.standard_normal((16, 4, 4, 8)).astype(np.float32)
    step = distributed.make_train_step(mesh8, keep_fraction=0.25)
    recon, thr, rmse = step(mesh_lib.shard_batch(batch, mesh8))
    assert recon.shape == batch.shape
    assert np.isfinite(float(rmse)) and float(rmse) > 0


def test_engine_with_mesh_matches_engine_without(mesh8):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((16, 8, 8, 8)).astype(np.float32)
    e1 = engine.CodecEngine(mesh=None)
    e8 = engine.CodecEngine(mesh=mesh8)
    f1, m1 = e1.compress_batch(data, 0.999)
    f8, m8 = e8.compress_batch(data, 0.999)
    np.testing.assert_array_equal(f1, f8)
    np.testing.assert_array_equal(m1, m8)
    d1 = e1.decompress_batch(f1 * m1, (8, 8, 8))
    d8 = e8.decompress_batch(f8 * m8, (8, 8, 8))
    np.testing.assert_array_equal(d1, d8)


def test_batch_padding_for_mesh(mesh8):
    """Ragged counts pad up to the mesh size; padded rows are inert."""
    items = [(batching.WorkItem(0, 0, 0, i),
              np.full((4, 4, 4), i + 1, np.float32)) for i in range(3)]
    batches = batching.plan_batches(items, pad_multiple=8)
    assert len(batches) == 1
    b = batches[0]
    assert b.data.shape[0] == 8 and b.n_valid == 3
    assert np.all(b.data[3:] == 0)
    eng = engine.CodecEngine(mesh=mesh8)
    flat, mask = eng.compress_batch(b.data, 0.999)
    # padded rows: all-zero coeffs, max=0, thresh=0 -> nothing kept
    assert not mask[3:].any()


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ge.dryrun_multichip(8)


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    flat, maxv = jax.jit(fn)(*args)
    assert flat.shape == (8, 16 * 32 * 64)
    assert maxv.shape == (8,)


def test_sharded_giant_box_forward_matches_single_device(mesh8):
    """One large box sharded over 8 devices: the ppermute boundary exchange
    must reproduce the single-device transform bitwise."""
    from wavelet_tpu.runtime import distributed

    rng = np.random.default_rng(7)
    box = (rng.standard_normal((32, 8, 16)) * 10).astype(np.float32)
    fwd = distributed.make_sharded_box_forward(mesh8)
    got = np.asarray(fwd(mesh_lib.shard_batch(box, mesh8)))
    want = np.asarray(haar.haar3d_forward(jnp.asarray(box)))
    np.testing.assert_array_equal(got, want)


def test_sharded_giant_box_roundtrip(mesh8):
    from wavelet_tpu.runtime import distributed

    rng = np.random.default_rng(8)
    box = (rng.standard_normal((16, 4, 8)) * 5).astype(np.float32)
    fwd = distributed.make_sharded_box_forward(mesh8)
    bwd = distributed.make_sharded_box_inverse(mesh8)
    coeffs = fwd(mesh_lib.shard_batch(box, mesh8))
    back = np.asarray(bwd(coeffs))
    # single-device inverse for comparison (bitwise)
    want = np.asarray(haar.haar3d_inverse(haar.haar3d_forward(jnp.asarray(box))))
    np.testing.assert_array_equal(back, want)


def test_sharded_giant_box_interleaved_multiscale(mesh8):
    """The interleaved-layout giant-box path: multi-scale pyramid over a
    sharded box with ZERO collectives (pairs at every scale are shard-local
    in the in-place layout).  Logical-order recovery via the same
    interleave_coords_multi map the host packer uses must match the jnp
    pyramid bitwise, and the inverse must round-trip bitwise."""
    from wavelet_tpu.core import interleave
    from wavelet_tpu.runtime import distributed

    rng = np.random.default_rng(9)
    box = (rng.standard_normal((32, 8, 16)) * 3).astype(np.float32)
    for scales in (1, 2):
        fwd = distributed.make_sharded_box_forward_interleaved(mesh8, scales)
        bwd = distributed.make_sharded_box_inverse_interleaved(mesh8, scales)
        coeffs = fwd(mesh_lib.shard_batch(box, mesh8))
        got = np.asarray(coeffs)
        PX, PY, PZ = interleave.interleave_coords_multi(box.shape, scales)
        want = np.asarray(haar.haar3d_forward_multi(jnp.asarray(box), scales))
        np.testing.assert_array_equal(got[PX, PY, PZ], want)
        back = np.asarray(bwd(coeffs))
        want_rt = np.asarray(haar.haar3d_inverse_multi(jnp.asarray(want),
                                                       scales))
        np.testing.assert_array_equal(back, want_rt)


def test_mesh_sharded_pallas_kernels_match_single_device(mesh8):
    """Batches sharded over the mesh (XLA partitions the jnp transforms)
    give results bitwise equal to the single-device engine, for one- and
    two-scale pyramids."""
    rng = np.random.default_rng(12)
    data = rng.standard_normal((16, 8, 8, 8)).astype(np.float32)
    for scales in (1, 2):
        e1 = engine.CodecEngine(mesh=None, scales=scales)
        e8 = engine.CodecEngine(mesh=mesh8, scales=scales)
        items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
                 for b in range(16)]
        batches1 = batching.plan_batches(
            [(it, data[i]) for i, it in enumerate(items)])
        batches8 = batching.plan_batches(
            [(it, data[i]) for i, it in enumerate(items)], pad_multiple=8)
        (c1, t1), (c8, t8) = (e1.compress_shapebatch(batches1[0], 0.999),
                              e8.compress_shapebatch(batches8[0], 0.999))
        for i in range(16):
            np.testing.assert_array_equal(c1.item_view(i), c8.item_view(i))
        np.testing.assert_array_equal(t1[:16], t8[:16])
        d1 = e1.decompress_shapebatch(c1)
        d8 = e8.decompress_shapebatch(c8)
        for i in range(16):
            np.testing.assert_array_equal(d1.item_view(i), d8.item_view(i))
