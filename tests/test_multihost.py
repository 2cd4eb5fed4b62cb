"""Real multi-process execution (VERDICT round-1 item 3): two
``jax.distributed.initialize`` CPU processes running the CLI with
``coordinator=/processid=/processes=`` keys, byte-compared against a
single-process run.

This turns the multi-host machinery — ``process_local_slice`` work
sharding, the two-limb cross-process histogram all-reduce (global mode, over Gloo),
and concurrent last-writer-wins sidecar writes — from structure into
tested behavior.  The reference has no distributed runtime at all
(SURVEY.md §2); this capability is mandated by BASELINE.json configs 4-5.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from wavelet_tpu.io import plotfile as pf

PY = sys.executable


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_data(tmp_path, n_times=2):
    rng = np.random.default_rng(11)
    data_dir = tmp_path / "data"
    for t in range(n_times):
        boxes = []
        for b in range(3):
            base = np.fromfunction(
                lambda i, j, k: np.sin(0.2 * (i + b)) + 0.1 * j - 0.05 * k,
                (8, 8, 8)).astype(np.float32)
            noisy = (base + 0.02 * rng.standard_normal(base.shape)
                     ).astype(np.float32)
            boxes.append(np.stack([base, noisy]))
        pf.write_plotfile(str(data_dir / f"plt{20 + t:05d}"),
                          [boxes], [[(0, 0, 0), (8, 0, 0), (16, 0, 0)]],
                          [[(8, 8, 8)] * 3],
                          ["a", "b"], 1.0 + t, [0., 0., 0.], [1., 1., 1.],
                          (2, 2, 2), (24, 8, 8), [20 + t])
    return str(data_dir)


def _cli_args(data_dir, comp_dir, extra=()):
    return [PY, "-m", "wavelet_tpu.cli", f"datadir={data_dir}",
            "minfile=plt00020", "maxfile=plt00021", "minlevel=0",
            "maxlevel=0", "components=a b", "keep=0.999",
            f"compresseddir={comp_dir}", "-c", *extra]


def _run_two_processes(data_dir, comp_dir, extra=()):
    port = _free_port()
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               WAVELET_TPU_NATIVE=os.environ.get("WAVELET_TPU_NATIVE", "1"))
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            _cli_args(data_dir, comp_dir,
                      extra=(f"coordinator=localhost:{port}",
                             "processes=2", f"processid={pid}", *extra)),
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    from tests.conftest import drain_procs

    outs = drain_procs(procs, timeout=240)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-3000:]}"
    return outs


def _dir_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("extra", [
    (),                                                   # box (parity) mode
    ("thresholdmode=global", "keepfraction=0.05"),        # cross-process all-reduce
], ids=["box_mode", "global_mode"])
def test_two_process_archive_matches_single_process(tmp_path, extra):
    data_dir = _write_data(tmp_path)
    single_dir = str(tmp_path / "single") + os.sep
    multi_dir = str(tmp_path / "multi") + os.sep

    # single-process oracle (in-process CLI would fight the test session's
    # jax config; a subprocess keeps both runs identical in environment)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(_cli_args(data_dir, single_dir), env=env,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))),
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-3000:]
    if extra:
        r = subprocess.run(_cli_args(data_dir, single_dir, extra), env=env,
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           timeout=240)
        assert r.returncode == 0, r.stdout.decode(errors="replace")[-3000:]

    _run_two_processes(data_dir, multi_dir, extra)

    a, b = _dir_bytes(single_dir), _dir_bytes(multi_dir)
    assert set(a) == set(b), (
        f"file sets differ: only-single={set(a)-set(b)}, "
        f"only-multi={set(b)-set(a)}")
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"bytes differ for {diff}"


def test_two_process_bundle_archive(tmp_path):
    """archive=bundle across 2 processes: each process writes its own
    bundle files (names carry the process index, so the split of one
    timestep's items across processes composes without contention), the
    member set and every member's bytes match a single-process bundle run,
    and decompression regenerates identical plotfiles."""
    import filecmp

    from wavelet_tpu.io import bundle

    data_dir = _write_data(tmp_path)
    single_dir = str(tmp_path / "single") + os.sep
    multi_dir = str(tmp_path / "multi") + os.sep
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(_cli_args(data_dir, single_dir,
                                 extra=("archive=bundle",)),
                       env=env, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-3000:]
    _run_two_processes(data_dir, multi_dir, extra=("archive=bundle",))

    bs_single = bundle.BundleSet(single_dir)
    bs_multi = bundle.BundleSet(multi_dir)
    assert set(bs_single.keys()) == set(bs_multi.keys())
    for key in bs_single.keys():
        assert bs_single.blob(*key) == bs_multi.blob(*key), key
    # both process ids actually wrote bundles (the work really was split)
    names = bundle.list_bundles(multi_dir)
    assert any("-p0" in n for n in names) and any("-p1" in n for n in names)

    out_s = str(tmp_path / "out_s") + os.sep
    out_m = str(tmp_path / "out_m") + os.sep
    for comp, out in ((single_dir, out_s), (multi_dir, out_m)):
        rr = subprocess.run(
            [PY, "-m", "wavelet_tpu.cli", f"compresseddir={comp}",
             f"out={out}", "-d"], env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, timeout=240)
        assert rr.returncode == 0, rr.stdout.decode(errors="replace")[-2000:]
    for root, _d, names in os.walk(out_s):
        rel = os.path.relpath(root, out_s)
        for n in names:
            assert filecmp.cmp(os.path.join(root, n),
                               os.path.join(out_m, rel, n),
                               shallow=False), f"{rel}/{n} differs"


def test_two_process_giant_boxes_shard_locally(tmp_path):
    """Multi-host giant boxes: each process shards its own giant items
    over its LOCAL devices (engine._giant_mesh — zero cross-process
    collectives), and the archive is byte-identical to a single-process
    run of the same data through the plain path."""
    rng = np.random.default_rng(31)
    data_dir = tmp_path / "data"
    boxes = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
             for _ in range(2)]
    pf.write_plotfile(str(data_dir / "plt00030"), [boxes],
                      [[(0, 0, 0), (16, 0, 0)]], [[(16, 8, 8)] * 2],
                      ["a"], 1.0, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (32, 8, 8), [30])
    args_base = [f"datadir={data_dir}", "minfile=plt00030",
                 "maxfile=plt00030", "minlevel=0", "maxlevel=0",
                 "components=a", "keep=0.999", "giantbox=2048"]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    single_dir = str(tmp_path / "single") + os.sep
    env1 = dict(os.environ, JAX_PLATFORMS="cpu")
    env1.pop("XLA_FLAGS", None)
    r = subprocess.run([PY, "-m", "wavelet_tpu.cli", *args_base,
                        f"compresseddir={single_dir}", "-c"],
                       env=env1, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    multi_dir = str(tmp_path / "multi") + os.sep
    port = _free_port()
    # 2 processes x 2 local virtual devices each: the 16-row X axis must
    # divide by local_mesh.size * 2 = 4 for the giant gate to admit it
    env2 = dict(env1, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [PY, "-m", "wavelet_tpu.cli", *args_base,
         f"compresseddir={multi_dir}", f"coordinator=localhost:{port}",
         "processes=2", f"processid={pid}", "-c"],
        env=env2, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    from tests.conftest import drain_procs

    outs = drain_procs(procs, timeout=240)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2500:]

    a, b = _dir_bytes(single_dir), _dir_bytes(multi_dir)
    assert set(a) == set(b)
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"bytes differ for {diff}"

    # the giant path REALLY ran in both processes (not a vacuous pass
    # through the plain path): the engine logs it
    for out in outs:
        assert "Giant box path" in out, out[-2500:]
    # while the single-process oracle (no mesh) took the plain path
    from wavelet_tpu.runtime import engine as eng_mod

    e = eng_mod.CodecEngine(giant_box_bytes=2048)
    assert not e.giant_ok((16, 8, 8))


def test_process_local_slice_partitions_completely():
    """Slices over all process ids must tile [0, n) exactly (no item done
    twice, none dropped) for any n and process count."""
    from wavelet_tpu.runtime import mesh as mesh_lib

    for n in (0, 1, 7, 24, 100):
        for p in (1, 2, 3, 8):
            per = -(-n // p) if n else 0
            covered = []
            for i in range(p):
                lo = i * per
                hi = min(n, (i + 1) * per)
                covered.extend(range(lo, max(lo, hi)))
            assert covered == list(range(n))


def test_two_process_partial_retrieval(tmp_path):
    """Partial retrieval under multi-process decompress: the process
    slice applies to the SELECTED timesteps; the union equals a
    single-process selection run."""
    import filecmp

    data_dir = _write_data(tmp_path, n_times=3)
    comp_dir = str(tmp_path / "comp") + os.sep
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [PY, "-m", "wavelet_tpu.cli", f"datadir={data_dir}",
         "minfile=plt00020", "maxfile=plt00022", "minlevel=0",
         "maxlevel=0", "components=a b", "keep=0.999",
         f"compresseddir={comp_dir}", "-c"],
        env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    sel = ["minfile=plt00021", "maxfile=plt00022", "components=a"]
    single = str(tmp_path / "single") + os.sep
    rr = subprocess.run(
        [PY, "-m", "wavelet_tpu.cli", f"compresseddir={comp_dir}",
         f"out={single}", *sel, "-d"],
        env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=240)
    assert rr.returncode == 0, rr.stdout.decode(errors="replace")[-2000:]

    multi = str(tmp_path / "multi") + os.sep
    port = _free_port()
    procs = [subprocess.Popen(
        [PY, "-m", "wavelet_tpu.cli", f"compresseddir={comp_dir}",
         f"out={multi}", *sel, f"coordinator=localhost:{port}",
         "processes=2", f"processid={pid}", "-d"],
        env=env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    from tests.conftest import drain_procs

    for p, out in zip(procs, drain_procs(procs, timeout=240)):
        assert p.returncode == 0, out[-2000:]

    assert sorted(os.listdir(multi)) == ["plt00021", "plt00022"]
    for name in ("plt00021", "plt00022"):
        for root, _d, names in os.walk(os.path.join(single, name)):
            rel = os.path.relpath(root, single)
            for n in names:
                assert filecmp.cmp(os.path.join(root, n),
                                   os.path.join(multi, rel, n),
                                   shallow=False), f"{rel}/{n} differs"


def test_two_process_decompress_matches_single(tmp_path):
    """Multi-process decompress: each process regenerates its timestep
    slice; the union of outputs is byte-identical to a single-process
    run."""
    import filecmp

    data_dir = _write_data(tmp_path, n_times=3)
    comp_dir = str(tmp_path / "comp") + os.sep
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [PY, "-m", "wavelet_tpu.cli", f"datadir={data_dir}",
            "minfile=plt00020", "maxfile=plt00022", "minlevel=0",
            "maxlevel=0", "components=a b", "keep=0.999",
            f"compresseddir={comp_dir}", "-c"]
    r = subprocess.run(args, env=env, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    def decompress(out_dir, extra=()):
        base = [PY, "-m", "wavelet_tpu.cli", f"compresseddir={comp_dir}",
                f"out={out_dir}", "-d"]
        if extra:
            port = _free_port()
            procs = [subprocess.Popen(
                base + [f"coordinator=localhost:{port}", "processes=2",
                        f"processid={pid}"],
                env=env, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT) for pid in range(2)]
            from tests.conftest import drain_procs

            for p, out in zip(procs, drain_procs(procs, timeout=240)):
                assert p.returncode == 0, out[-2000:]
        else:
            rr = subprocess.run(base, env=env, cwd=cwd,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, timeout=240)
            assert rr.returncode == 0

    single = str(tmp_path / "single") + os.sep
    multi = str(tmp_path / "multi") + os.sep
    decompress(single)
    decompress(multi, extra=True)
    for t in range(3):
        name = f"plt{20 + t:05d}"
        assert os.path.isdir(os.path.join(multi, name)), f"{name} missing"
        for root, _d, names in os.walk(os.path.join(single, name)):
            rel = os.path.relpath(root, single)
            for n in names:
                a = os.path.join(root, n)
                b = os.path.join(multi, rel, n)
                assert filecmp.cmp(a, b, shallow=False), f"{rel}/{n} differs"


def test_two_process_crosshost_giant_boxes(tmp_path):
    """giantmesh=global (round-4 verdict stretch item 8): giant boxes
    shard over the GLOBAL 2-process x 2-device mesh — every process
    participates in each giant box's collective transform, only the item
    owner writes the payload — and the archive, a resumed re-run, and
    the 2-process global-mesh decompress are all byte-identical to
    single-process runs of the same data."""
    import filecmp

    rng = np.random.default_rng(47)
    data_dir = tmp_path / "data"
    for t in (40, 41):
        # one giant box (16,8,8: X divides the 4-device mesh x 2 scales)
        # + one normal box per timestep: mixed ownership inside batches
        boxes = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
                 rng.standard_normal((1, 4, 4, 2)).astype(np.float32)]
        pf.write_plotfile(str(data_dir / f"plt000{t}"), [boxes],
                          [[(0, 0, 0), (16, 0, 0)]],
                          [[(16, 8, 8), (4, 4, 2)]],
                          ["a"], 0.5 * t, [0., 0., 0.], [1., 1., 1.],
                          (2, 2, 2), (32, 8, 8), [t])
    args_base = [f"datadir={data_dir}", "minfile=plt00040",
                 "maxfile=plt00041", "minlevel=0", "maxlevel=0",
                 "components=a", "keep=0.999", "giantbox=2048"]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env1 = dict(os.environ, JAX_PLATFORMS="cpu")
    env1.pop("XLA_FLAGS", None)

    single_dir = str(tmp_path / "single") + os.sep
    r = subprocess.run([PY, "-m", "wavelet_tpu.cli", *args_base,
                        f"compresseddir={single_dir}", "-c"],
                       env=env1, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    from tests.conftest import drain_procs

    env2 = dict(env1, XLA_FLAGS="--xla_force_host_platform_device_count=2")

    def run_two(extra, mode):
        port = _free_port()
        procs = [subprocess.Popen(
            [PY, "-m", "wavelet_tpu.cli", *args_base, *extra,
             "giantmesh=global", f"coordinator=localhost:{port}",
             "processes=2", f"processid={pid}", mode],
            env=env2, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for pid in range(2)]
        outs = drain_procs(procs, timeout=240)
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-2500:]
        return outs

    multi_dir = str(tmp_path / "multi") + os.sep
    outs = run_two([f"compresseddir={multi_dir}"], "-c")
    # the global giant mesh really engaged on both processes
    for out in outs:
        assert "giantmesh=global" in out, out[-2500:]
        assert "Giant box path" in out, out[-2500:]

    a, b = _dir_bytes(single_dir), _dir_bytes(multi_dir)
    assert set(a) == set(b)
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"bytes differ for {diff}"

    # resume: collective giant items are recomputed (identical bytes),
    # owned normal items skipped; archive unchanged
    run_two([f"compresseddir={multi_dir}", "resume=1"], "-c")
    b2 = _dir_bytes(multi_dir)
    assert b2 == a

    # decompress through the global giant mesh: every process decodes
    # collectively, only the slice owner writes its timesteps
    out_s = str(tmp_path / "out_s") + os.sep
    rr = subprocess.run(
        [PY, "-m", "wavelet_tpu.cli", f"compresseddir={single_dir}",
         f"out={out_s}", "-d"], env=env1, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, timeout=240)
    assert rr.returncode == 0
    out_m = str(tmp_path / "out_m") + os.sep
    run_two([f"compresseddir={multi_dir}", f"out={out_m}"], "-d")
    assert sorted(os.listdir(out_m)) == ["plt00040", "plt00041"]
    for root, _d, names in os.walk(out_s):
        rel = os.path.relpath(root, out_s)
        for n in names:
            assert filecmp.cmp(os.path.join(root, n),
                               os.path.join(out_m, rel, n),
                               shallow=False), f"{rel}/{n} differs"


def test_two_process_crosshost_global_threshold(tmp_path):
    """thresholdmode=global x giantmesh=global x 2 processes — the one
    combination the round-5 review found untested, and where two launch-
    divergence bugs lived: (a) the giant histogram reduction is a
    collective every process must launch (ownership gates only the
    COUNT), and (b) the globalcache admission must be computed from the
    deterministic global timestep size, not per-process batch bytes, or
    one process skips a gather its peer launches.  Runs with a budget
    that caches timestep 0 but not timestep 1, so both the cached and
    re-read pass-2 branches execute collectives; archive bytes must
    match a single-process run."""
    rng = np.random.default_rng(53)
    data_dir = tmp_path / "data"
    for t in (60, 61):
        boxes = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
                 rng.standard_normal((1, 4, 4, 2)).astype(np.float32)]
        pf.write_plotfile(str(data_dir / f"plt000{t}"), [boxes],
                          [[(0, 0, 0), (16, 0, 0)]],
                          [[(16, 8, 8), (4, 4, 2)]],
                          ["a"], 0.5 * t, [0., 0., 0.], [1., 1., 1.],
                          (2, 2, 2), (32, 8, 8), [t])
    # per-timestep global bytes = (16*8*8 + 4*4*2) * 4 = 4224: a 5000-byte
    # budget caches t0 and leaves t1 to the pass-2 re-read path
    args_base = [f"datadir={data_dir}", "minfile=plt00060",
                 "maxfile=plt00061", "minlevel=0", "maxlevel=0",
                 "components=a", "keep=0.999", "giantbox=2048",
                 "thresholdmode=global", "keepfraction=0.05",
                 "globalcache=5000"]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env1 = dict(os.environ, JAX_PLATFORMS="cpu")
    env1.pop("XLA_FLAGS", None)

    single_dir = str(tmp_path / "single") + os.sep
    r = subprocess.run([PY, "-m", "wavelet_tpu.cli", *args_base,
                        f"compresseddir={single_dir}", "-c"],
                       env=env1, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    from tests.conftest import drain_procs

    env2 = dict(env1, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    port = _free_port()
    multi_dir = str(tmp_path / "multi") + os.sep
    procs = [subprocess.Popen(
        [PY, "-m", "wavelet_tpu.cli", *args_base,
         f"compresseddir={multi_dir}", "giantmesh=global",
         f"coordinator=localhost:{port}", "processes=2",
         f"processid={pid}", "-c"],
        env=env2, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    outs = drain_procs(procs, timeout=240)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2500:]
    for out in outs:
        assert "Giant box path (global threshold)" in out, out[-2500:]
        # both cache branches ran: exactly one of two timesteps retained
        assert "retained 1/2" in out, out[-2500:]

    a, b = _dir_bytes(single_dir), _dir_bytes(multi_dir)
    assert set(a) == set(b), (
        f"only-single={set(a)-set(b)}, only-multi={set(b)-set(a)}")
    diff = [k for k in a if a[k] != b[k]]
    assert not diff, f"bytes differ for {diff}"


def test_crosshost_decompress_more_processes_than_timesteps(tmp_path):
    """giantmesh=global decompress with 2 processes and ONE timestep: the
    non-owner process decodes the timestep collectively (skipping it
    would deadlock the giant inverse), writes nothing, and still exits
    cleanly — the round-5 review's zero-owner case.  Output must be
    byte-identical to a single-process run and written exactly once."""
    import filecmp

    rng = np.random.default_rng(71)
    data_dir = tmp_path / "data"
    boxes = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
             rng.standard_normal((1, 4, 4, 2)).astype(np.float32)]
    pf.write_plotfile(str(data_dir / "plt00080"), [boxes],
                      [[(0, 0, 0), (16, 0, 0)]],
                      [[(16, 8, 8), (4, 4, 2)]],
                      ["a"], 0.5, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (32, 8, 8), [80])
    args_base = [f"datadir={data_dir}", "minfile=plt00080",
                 "maxfile=plt00080", "minlevel=0", "maxlevel=0",
                 "components=a", "keep=0.999", "giantbox=2048"]
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env1 = dict(os.environ, JAX_PLATFORMS="cpu")
    env1.pop("XLA_FLAGS", None)

    comp_dir = str(tmp_path / "comp") + os.sep
    r = subprocess.run([PY, "-m", "wavelet_tpu.cli", *args_base,
                        f"compresseddir={comp_dir}", "-c"],
                       env=env1, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]
    out_s = str(tmp_path / "out_s") + os.sep
    r = subprocess.run([PY, "-m", "wavelet_tpu.cli",
                        f"compresseddir={comp_dir}", f"out={out_s}", "-d"],
                       env=env1, cwd=cwd, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, timeout=240)
    assert r.returncode == 0, r.stdout.decode(errors="replace")[-2000:]

    from tests.conftest import drain_procs

    env2 = dict(env1, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    port = _free_port()
    out_m = str(tmp_path / "out_m") + os.sep
    procs = [subprocess.Popen(
        [PY, "-m", "wavelet_tpu.cli", f"compresseddir={comp_dir}",
         f"out={out_m}", "giantmesh=global",
         f"coordinator=localhost:{port}", "processes=2",
         f"processid={pid}", "-d"],
        env=env2, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    outs = drain_procs(procs, timeout=240)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2500:]
    # exactly one plotfile directory came out (no double write)
    assert sorted(os.listdir(out_m)) == ["plt00080"]
    for root, _d, names in os.walk(out_s):
        rel = os.path.relpath(root, out_s)
        for n in names:
            assert filecmp.cmp(os.path.join(root, n),
                               os.path.join(out_m, rel, n),
                               shallow=False), f"{rel}/{n} differs"
