"""The thesis' real-sensor experiments on the port: the counterparts of
experiments/run_experiments.py::chap3_k6real and ::chap4_k9.

Both read the real-pixel TUM-format sequence assets/tum_real (24 frames of
160 x 120, with the analytic camera trajectory true_x.npy) through
convert_tum -> FAST / LATCH / RANSAC -> Simulation(kinect_source=...), and
return the same dict as the JAX function, plus each run's device-to-host
reads a frame (`host_reads_per_frame`) and its wall seconds (`seconds`, the
run alone: no conversion, no reference map).

    python -m monorfs_tpu_torch.experiments_kinect k6real [--out DIR] [--device cpu]
    python -m monorfs_tpu_torch.experiments_kinect k9 [--particles 2000] [--dtype float32]
        [--algs phd,odometry,isam2]

k6real: `-a isam2` in float64 (ATE of the x track against true_x) and
`-a phd -y` mapping. k9: scripted odometry (the analytic step plus seeded
drift, run_experiments.py:535-543), the k9 configuration (:545-558), `phd`,
`odometry` and `isam2`, with OSPA (c = 0.3) against the reference map: the
measurements back-projected at the true poses, merged at 5 cm (:560-588)."""

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from .config import Config
from .frontend.dataset import RGBDDataset, convert_tum
from .frontend.kinect import KinectSource
from .io import World
from .metrics.errors import ospa
from .models import get as get_model
from .models.kinect_model import Params as KinectParams
from .sim.simulation import Simulation, torch_dtype

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "assets" / "tum_real"
SEED = 0  # run_experiments.py's default seed
H, W, FOCAL = 120, 160, 200.0


def camera():
    """The fixture's camera (run_experiments.py:436-440)."""
    return KinectParams(focal=FOCAL, film_left=-W / 2, film_top=-H / 2, film_width=W, film_height=H,
                        range_min=0.1, range_max=5.0, res_x=W, res_y=H, border=1)


def sequence(out, frames):
    """(npz path, true_x [frames], world) of the converted fixture."""
    out.mkdir(parents=True, exist_ok=True)
    npz = str(out / "tum_real.npz")
    convert_tum(str(FIXTURE), npz, max_frames=frames)
    true_x = np.load(FIXTURE / "true_x.npy")[:frames]
    world = World(pose=np.array([0, 0, 0, 1, 0, 0, 0.0]), landmarks=np.zeros((0, 3)),
                  measurer_params=np.asarray(camera().to_linear()))
    return npz, true_x, world


def source(npz, device):
    return KinectSource(RGBDDataset(npz), camera=camera(), delta=1, max_keypoints=128, threshold=40.0,
                        device=device)


def k6real(out, device="cuda", dtype=torch.float64, frames=24):
    """chap3-k6real: isam2 and phd mapping over the real-pixel sequence."""
    out = pathlib.Path(out) / "chap3-k6real"
    npz, true_x, world = sequence(out, frames)
    dtype = torch_dtype(dtype)
    stats = {}
    for alg in ("isam2", "phd"):
        src = source(npz, device)
        cfg = Config()
        cfg.motion_covariance = np.diag([10.0, 10, 10, 0.1, 0.1, 0.1])
        sim = Simulation(cfg, world, [], algorithm=alg, particles=1, onlymapping=(alg == "phd"),
                         kinect_source=src, dtype=dtype, device=device)
        t0 = time.perf_counter()
        sim.run()
        seconds = time.perf_counter() - t0
        sim.save(str(out / f"{alg}.zip"))
        if alg == "isam2":
            traj = sim.isam2.trajectory
            est_x = traj[1:, 0] - traj[1, 0]
            want = true_x - true_x[0]
            n = min(len(est_x), len(want))
            err = np.abs(est_x[:n] - want[:n])
            stats[alg] = {
                "frames": int(n),
                "travel_m": float(want[n - 1]),
                "ate_loc_rmse": float(np.sqrt(np.mean(err ** 2))),
                "final_err_m": float(err[n - 1]),
                "landmarks": int(sim.isam2.lm_mask_np.sum()),
            }
        else:
            counts = [len(m) for _, m in sim.way_measurements]
            stats[alg] = {
                "frames": len(counts),
                "mean_measurements": sum(counts) / max(len(counts), 1),
                "frames_with_measurements": sum(1 for c in counts if c > 0),
                "map_components": len(sim.way_maps[-1][1]),
            }
        stats[alg].update(host_reads_per_frame=src.reads / len(sim.frames), seconds=seconds)
    return stats


def k9_commands(true_x):
    """The scripted odometry: the analytic step of each frame plus seeded
    drift (run_experiments.py:535-543)."""
    rng0 = np.random.default_rng(100 + SEED)
    dx = np.diff(true_x, prepend=true_x[0])
    return [np.array([d, 0, 0, 0, 0, 0.0])
            + rng0.normal(0, 1, 6) * np.array([2e-3, 2e-3, 2e-3, 1e-4, 1e-4, 1e-4]) for d in dx]


def k9_cfg():
    """Motion noise sized to the scripted drift (run_experiments.py:545-558)."""
    cfg = Config()
    cfg.motion_covariance = np.diag([0.01, 0.01, 0.01, 1e-3, 1e-3, 1e-3])
    cfg.measurement_covariance = np.diag([2.0, 2.0, 1e-3])
    cfg.navigator_clutter_density = 4e-7
    return cfg


def reference_map(npz, true_x, frames, device):
    """The measurements back-projected at the true poses, merged at 5 cm
    (run_experiments.py:560-588)."""
    prm = get_model("PRM3D")
    prm = prm.with_params(dataclasses.replace(
        prm.params, focal=FOCAL, film_left=-W / 2, film_top=-H / 2, film_width=float(W),
        film_height=float(H), range_min=0.1, range_max=5.0))
    src = source(npz, device)
    pts = []
    for i in range(frames):
        zs, _ = src.measure(i)
        if len(zs) == 0:
            continue
        pose = torch.tensor([[true_x[i], 0, 0, 1, 0, 0, 0.0]], dtype=torch.float64)
        pts.append(prm.to_map(prm.params, pose, torch.as_tensor(zs[:, :3])).numpy())
    pts = np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))
    refmap = []
    for pt in pts:
        if not any(np.linalg.norm(pt - q) < 0.05 for q in refmap):
            refmap.append(pt)
    return np.asarray(refmap)


def k9(out, particles=50, dtype=torch.float64, algs=("phd", "odometry", "isam2"), device="cuda",
       frames=24, tag="chap4-k9"):
    """chap4-k9: phd vs odometry vs isam2 on the real-pixel sequence with
    scripted odometry; ATE against the analytic trajectory, OSPA (c = 0.3)
    against the reference map."""
    out = pathlib.Path(out) / tag
    npz, true_x, world = sequence(out, frames)
    dtype = torch_dtype(dtype)
    commands = k9_commands(true_x)
    refmap = reference_map(npz, true_x, frames, device)
    stats = {"reference_map_landmarks": int(len(refmap))}
    for alg in algs:
        src = source(npz, device)
        sim = Simulation(k9_cfg(), world, commands, algorithm=alg, kinect_source=src, dtype=dtype,
                         device=device, **({"particles": particles} if alg == "phd" else {}))
        t0 = time.perf_counter()
        sim.run()
        seconds = time.perf_counter() - t0
        sim.save(str(out / f"{alg}.zip"))
        traj = np.array([v for _, v in sim.estimate_history()[-1][1]])
        est_x = traj[: len(true_x), 0] - traj[0, 0]
        want = true_x - true_x[0]
        n = min(len(est_x), len(want))
        err = np.abs(est_x[:n] - want[:n])
        row = {"frames": int(n), "ate_loc_rmse": float(np.sqrt(np.mean(err ** 2))),
               "final_err_m": float(err[n - 1])}
        mm = sim.way_maps[-1][1] if sim.way_maps else []
        est_lm = np.asarray([m for _, m, _ in mm]) if mm else np.zeros((0,))
        if est_lm.size and len(refmap):
            row["ospa_vs_refmap"] = float(ospa(est_lm, refmap, c=0.3)[0])
            row["landmarks"] = int(len(est_lm))
        row.update(host_reads_per_frame=src.reads / len(sim.frames), seconds=seconds)
        stats[alg] = row
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-kinect-experiments")
    ap.add_argument("experiment", choices=["k6real", "k9"])
    ap.add_argument("--out", type=pathlib.Path, default=pathlib.Path("experiments-kinect-out"))
    ap.add_argument("--particles", type=int, default=50)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--algs", default="phd,odometry,isam2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.experiment == "k6real":
        stats = k6real(args.out, args.device, np.dtype(args.dtype))
    else:
        stats = k9(args.out, args.particles, np.dtype(args.dtype), tuple(args.algs.split(",")), args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
