"""Quality parity at scale.

Records RMSE / adjusted loss / size%% for keep in {0.99, 0.999, 0.9999}
(box mode) and keepfraction in {0.05, 0.02, 0.005} (global mode) on a
>=1 GiB synthetic smooth+shock AMR dataset, CPU-evaluated, plus a
CPU-vs-GPU bitwise comparison of every reported metric on a 32-box
subset.  Each measurement runs in its own child process, one after the
other; the parent never imports JAX, so at most one process holds the
GPU.

Estimator semantics anchor: modes.cpp:209-328 (estimate mode: mean RMSE
over boxes, adjusted loss vs the value range, compressed-size %%).

Usage:
  bench_quality.py            orchestrates everything, writes
                              bench_results/quality_at_scale.json
  bench_quality.py --child cpu|gpu NBOXES OUTJSON    (internal)
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DIM = 64
SEED = 800
KEEPS = [0.99, 0.999, 0.9999]
FRACS = [0.05, 0.02, 0.005]


def synth_dataset(root: str, n_boxes: int):
    """One-timestep, one-level plotfile of n_boxes 64^3 smooth+shock boxes
    (deterministic: the CPU and GPU children must see identical bytes)."""
    from wavelet_tpu.io import plotfile as pf

    rng = np.random.default_rng(SEED)
    xs = np.linspace(0, 1, DIM, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    boxes, locs, dims = [], [], []
    side = int(np.ceil(n_boxes ** (1 / 3)))
    for b in range(n_boxes):
        cx, cy = rng.random(2)
        smooth = (np.sin(5 * (X - cx)) * np.cos(4 * (Y - cy))
                  + 2.0 * Z + 3.0)
        shock = np.tanh(80 * (X + 0.6 * Y - 1.1 * cx)) * (1 + rng.random())
        boxes.append([(smooth + shock).astype(np.float32)])
        i, j, k = b % side, (b // side) % side, b // (side * side)
        locs.append((i * DIM, j * DIM, k * DIM))
        dims.append((DIM, DIM, DIM))
    d = os.path.join(root, "plt00800")
    pf.write_plotfile(d, [[np.asarray(bx) for bx in boxes]], [locs],
                      [dims], ["f"], 0.8, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (side * DIM, side * DIM, side * DIM),
                      [800], precision="f32")
    return root


def run_sweeps(data_dir: str):
    from wavelet_tpu.pipeline import common, estimate

    base = dict(data_dir=data_dir, min_time="plt00800",
                max_time="plt00800", min_level=0, max_level=0,
                components=["f"], fast_estimate=True)
    box = estimate.estimate_run(common.Config(keep_sweep=KEEPS, **base))
    glob = estimate.estimate_run(common.Config(
        threshold_mode="global", keep_fraction_sweep=FRACS, **base))
    return {"box_keep_sweep": box, "global_keepfraction_sweep": glob}


def child(platform: str, n_boxes: int, out_json: str) -> None:
    import jax

    if jax.devices()[0].platform != platform:
        raise SystemExit(f"child wants {platform}, JAX found "
                         f"{jax.devices()[0].platform}")
    from wavelet_tpu.runtime import debug

    debug.enable_compilation_cache()
    with tempfile.TemporaryDirectory() as d:
        synth_dataset(d, n_boxes)
        t0 = time.perf_counter()
        res = run_sweeps(d)
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        res["platform"] = platform
        res["n_boxes"] = n_boxes
        res["dataset_bytes"] = n_boxes * DIM ** 3 * 4
    with open(out_json, "w") as f:
        json.dump(res, f, indent=1, default=float)


def _spawn(platform, n_boxes, out_json):
    env = dict(os.environ)
    if platform == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                    platform, str(n_boxes), out_json],
                   check=True, env=env, cwd=REPO)
    with open(out_json) as f:
        return json.load(f)


def strip_walls(d):
    if isinstance(d, dict):
        return {k: strip_walls(v) for k, v in sorted(d.items())
                if k not in ("wall_s", "platform")}
    return d


def main():
    os.makedirs("bench_results", exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        big = _spawn("cpu", 1024, os.path.join(td, "big.json"))     # 1 GiB
        sub_cpu = _spawn("cpu", 32, os.path.join(td, "sc.json"))
        sub_gpu = _spawn("gpu", 32, os.path.join(td, "sg.json"))
    agree = strip_walls(sub_cpu) == strip_walls(sub_gpu)
    out = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "at_scale_cpu_1GiB": big,
        "subset_bitwise_cpu_vs_gpu": {
            "n_boxes": 32,
            "all_metrics_identical": agree,
            "cpu": sub_cpu, "gpu": sub_gpu,
        },
    }
    with open("bench_results/quality_at_scale.json", "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({"at_scale_wall_s": big.get("wall_s"),
                      "subset_bitwise_identical": agree}))
    if not agree:
        return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit(main())
