"""Cross-host giant boxes (VERDICT r3 stretch item 7): ONE box sharded
over a 2-process x 2-local-device GLOBAL mesh — larger than either
process's devices could hold alone — forward+inverse through the
zero-collective interleaved transform, gathered back, bitwise
equal to a single-process round trip of the same box.
"""

import os
import socket
import subprocess
import sys

PY = sys.executable

_CHILD = r'''
import os, sys
sys.path.insert(0, os.getcwd())      # repo root (cwd set by the launcher)
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); port = sys.argv[2]
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
assert jax.device_count() == 4 and len(jax.local_devices()) == 2

from wavelet_tpu.runtime import distributed, mesh as mesh_lib
from wavelet_tpu.core import interleave

mesh = mesh_lib.data_mesh(jax.devices())     # GLOBAL 4-device mesh
scales = 2
X = 32                                       # 8 rows/device, q=4 | 8
rng = np.random.default_rng(5)               # same box on both processes
box = rng.standard_normal((X, 8, 16)).astype(np.float32)
slab = box[pid * (X // 2):(pid + 1) * (X // 2)]

ga = distributed.giant_from_process_slabs(mesh, slab, box.shape)
fwd = distributed.make_sharded_box_forward_interleaved(mesh, scales)
inv = distributed.make_sharded_box_inverse_interleaved(mesh, scales)
coeffs = fwd(ga)
back = inv(coeffs)

coeffs_np = distributed.gather_giant(coeffs)
back_np = distributed.gather_giant(back)

# single-device reference of the SAME full box
ref_c = np.asarray(interleave.forward_block(
    jax.numpy.asarray(box), scales))
ref_b = np.asarray(interleave.inverse_block(
    jax.numpy.asarray(ref_c), scales))
np.testing.assert_array_equal(coeffs_np.view(np.int32),
                              ref_c.view(np.int32))
np.testing.assert_array_equal(back_np.view(np.int32),
                              ref_b.view(np.int32))
print(f"proc {pid} CROSSHOST-GIANT-OK")
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_crosshost_giant_box_bitwise(tmp_path):
    from tests.conftest import drain_procs

    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    port = str(_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [PY, str(child), str(pid), port], env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    # real deadline with child cleanup (a stuck coordinator must FAIL the
    # test, not hang the suite — pytest-timeout is not installed here)
    outs = drain_procs(procs, timeout=220)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} CROSSHOST-GIANT-OK" in out
