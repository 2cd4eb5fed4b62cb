"""Start-up and process model: compile-cache location, one card per
process, the backend log line, and the engine's device path."""

import logging

import jax
import numpy as np
import pytest

from wavelet_tpu.runtime import debug, engine, mesh as mesh_lib


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    debug.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == debug.DEFAULT_CACHE_DIR
    assert debug.DEFAULT_CACHE_DIR.endswith(".jax_cache")


def test_cache_dir_env_is_left_to_jax(monkeypatch, restore_cache_dir,
                                      tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    debug.enable_compilation_cache()
    # nothing in code overrides the directory the environment chose
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


@pytest.mark.parametrize("cards,nproc,pid,want", [
    (4, 4, 2, [2]),       # one host, one process per card
    (4, 8, 5, [1]),       # second host: local rank, not the global id
    (1, 2, 1, [0]),       # one card per host, one process per host
    (8, 16, 11, [3]),     # second of two 8-card hosts
    (0, 2, 1, None),      # no cards on the host: JAX decides
])
def test_init_distributed_opens_one_card_per_process(monkeypatch, cards,
                                                     nproc, pid, want):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(mesh_lib, "local_card_count", lambda: cards)
    mesh_lib.init_distributed("localhost:1234", nproc, pid)
    assert calls == [{"coordinator_address": "localhost:1234",
                      "num_processes": nproc, "process_id": pid,
                      "local_device_ids": want}]
    with pytest.raises(ValueError, match="coordinator"):
        mesh_lib.init_distributed(None, nproc, pid)


@pytest.mark.parametrize("visible,want", [("0,1,2,3", 4), ("2,3", 2),
                                          ("", 0)])
def test_local_card_count_follows_visible_devices(monkeypatch, visible,
                                                  want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert mesh_lib.local_card_count() == want


def test_cli_logs_backend(tmp_path, caplog):
    from wavelet_tpu import cli

    with caplog.at_level(logging.INFO, logger="wavelet_tpu"):
        cli.main([f"compresseddir={tmp_path}/", f"out={tmp_path}/o/", "-d"])
    dev = jax.devices()[0]
    assert any(f"JAX backend: {dev.platform}" in r.message
               and dev.device_kind in r.message for r in caplog.records)


@pytest.mark.parametrize("dims", [(8, 8, 16), (7, 8, 8)])
def test_engine_takes_the_jnp_path(monkeypatch, dims):
    """Every shape goes through the jitted jnp step and its per-axis
    forward passes (no platform switch, no kernel table)."""
    from wavelet_tpu.core import haar
    from wavelet_tpu.runtime import batching

    seen = {"passes": 0}
    orig = haar._fwd_last

    def spy(x):
        seen["passes"] += 1
        return orig(x)

    monkeypatch.setattr(haar, "_fwd_last", spy)
    step = jax.jit(engine._compress_step.__wrapped__)
    monkeypatch.setattr(engine, "_compress_step", step)
    rng = np.random.default_rng(0)
    entries = [(batching.WorkItem(0, 0, 0, i),
                rng.standard_normal(dims).astype(np.float32))
               for i in range(2)]
    [b] = batching.plan_batches(entries)
    eng = engine.CodecEngine()
    assert eng.coeff_layout(dims) == "halves"
    cb, _t32 = eng.compress_shapebatch(b, 0.99)
    assert cb.layout == "halves"
    assert seen["passes"] == 3                 # Z, Y, X, traced once
    assert not hasattr(eng, "use_pallas") and not hasattr(eng, "layout")
