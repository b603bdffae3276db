"""Graph-SLAM benchmark of the port on one GPU: frames per second of the
graph backend on the 3D pixel-range world (the torch twin of the
repository's bench_isam2.py).

    python -m monorfs_tpu_torch.bench_isam2 [--frames N] [--device cpu]
        the host-interactive navigator (Mahalanobis association + bucketed
        warm-started Gauss-Newton, float64) through Simulation -a isam2
    python -m monorfs_tpu_torch.bench_isam2 --scan
        the known-label scan runner (slam/isam2_scan.py), float32
    python -m monorfs_tpu_torch.bench_isam2 --scan-da [--variant default|noisy|...]
        the Mahalanobis-DA scan runner (slam/isam2_scan_da.py), float32,
        with experiments/configs/chap4-<variant>.cfg

Prints one JSON line {"metric", "value", "unit", "vs_baseline"}
(vs_baseline against the 30 frames/s real-time rate) and, on stderr, a
detail line with ATE, the final landmark count, OSPA, host reads per frame
and the card's name and power limit."""

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .io import World, parse_commands
from .metrics.errors import ate_location, ospa, rmse
from .sim.simulation import Simulation, model_for_config
from .slam import graph
from .slam.isam2_scan import build_isam2_scan_runner, scan_draws
from .slam.isam2_scan_da import build_mahalanobis_scan

ROOT = pathlib.Path(__file__).resolve().parent.parent


def card(device):
    """The card's name and power limit as nvidia-smi gives them (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def world_and_commands(frames, dtype, device):
    """The 3D asset world and `frames` commands of mov3d.in (repeated when
    more are asked for) as a [frames, 6] tensor."""
    world = World.from_file(ROOT / "assets" / "sim3d.world")
    cmds = np.stack([c[:6] for c in parse_commands((ROOT / "assets" / "mov3d.in").read_text())])
    cmds = np.tile(cmds, (math.ceil(frames / len(cmds)), 1))[:frames]
    return world, torch.as_tensor(cmds, dtype=dtype, device=device)


def _ate(true_poses, est_poses):
    diff = (true_poses[:, :3] - est_poses[:, :3]).double()
    return float(torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1))))


def run_scan(frames=300, device="cuda", seed=0):
    """--scan: the known-label graph backend, float32, one loop on the
    device (reference known-DA config chap4/known.cfg, isam2.cpp:199-246)."""
    dev = resolve_device(device)
    cfg = Config()
    world, cmds = world_and_commands(frames, torch.float32, dev)
    runner, carry, model = build_isam2_scan_runner(
        cfg, world, frames=frames, gn_iters=1, dtype=torch.float32, device=dev
    )
    draws = scan_draws(model, cfg, world, frames, seed=seed, device=dev)
    graph.counts["cholesky"] = 0
    _sync(dev)
    t0 = time.perf_counter()
    out, (tp, ep) = runner(carry, cmds, draws)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return {
        "mode": "scan", "frames": frames, "elapsed_s": elapsed, "fps": frames / elapsed,
        "ate_rmse_loc": _ate(tp, ep), "final_landmarks": int(out.gstate.lm_mask.sum()),
        "true_landmarks": len(world.landmarks), "dtype": "float32", "gn_iters_per_frame": 1,
        # the Cholesky's status, once per Gauss-Newton iteration
        "host_reads_per_frame": graph.counts["cholesky"] / frames, "device": str(dev), "card": card(dev),
    }


def run_scan_da(frames=300, variant="default", device="cuda", seed=0):
    """--scan-da: the Mahalanobis-DA graph backend, float32: gated
    J Sigma J^T + R log-profit matrix, epsilon-scaled auction assignment,
    candidate lifecycle, warm-started GN, amortized marginals (the
    reference's default chap4 configuration, ISAM2Navigator.cs:256-441 +
    isam2.cpp:199-312)."""
    dev = resolve_device(device)
    cfg = Config.from_file(ROOT / "experiments" / "configs" / f"chap4-{variant}.cfg")
    world, cmds = world_and_commands(frames, torch.float32, dev)
    # size the static clutter slots to the config's Poisson cap
    # (floor(10 * lambda); build_mahalanobis_scan raises otherwise)
    model = model_for_config(cfg, world)
    lam = float(cfg.clutter_density) * float(model.volume(model.params))
    max_clutter = max(8, int(math.floor(10 * lam)) + 1)
    runner, carry, model = build_mahalanobis_scan(
        cfg, world, frames=frames, dtype=torch.float32, max_clutter=max_clutter, device=dev
    )
    draws = scan_draws(model, cfg, world, frames, seed=seed, max_clutter=max_clutter, device=dev)
    stats = {"iterations": [], "reads": 0}
    graph.counts["cholesky"] = 0
    _sync(dev)
    t0 = time.perf_counter()
    out, (tp, ep, nlm) = runner(carry, cmds, draws, stats=stats)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    lms = out.gstate.landmarks[out.gstate.lm_mask].cpu().numpy()
    iters = np.asarray(stats["iterations"]).reshape(frames, -1)
    return {
        "mode": "scan-da", "variant": variant, "frames": frames, "elapsed_s": elapsed,
        "fps": frames / elapsed, "ate_rmse_loc": _ate(tp, ep),
        "final_landmarks": int(out.gstate.lm_mask.sum()), "true_landmarks": len(world.landmarks),
        "final_ospa": float(ospa(lms, np.asarray(world.landmarks), c=1.0)[0]),
        "auction_iterations_per_phase": iters.mean(axis=0).tolist(),
        "auction_iterations_max": iters.max(axis=0).tolist(),
        # the auction's flags, the promotion count and each Cholesky's status
        "host_reads_per_frame": (stats["reads"] + graph.counts["cholesky"]) / frames,
        "cholesky_per_frame": graph.counts["cholesky"] / frames,
        "dtype": "float32", "gn_iters_per_frame": 1, "device": str(dev), "card": card(dev),
    }


def run_navigator(frames=200, device="cuda", seed=0, warmup=10):
    """The host-interactive navigator: per-frame association on the device,
    Hungarian on the host, bucketed warm-started Gauss-Newton, float64."""
    dev = resolve_device(device)
    cfg = Config()  # PRM3D defaults
    world = World.from_file(ROOT / "assets" / "sim3d.world")
    commands = parse_commands((ROOT / "assets" / "mov3d.in").read_text())[:frames]
    sim = Simulation(cfg, world, commands, algorithm="isam2", particles=1, dtype=np.float64,
                     seed=seed, device=dev)
    for cmd in commands[:warmup]:
        sim.step(cmd)
    nav = sim.isam2
    reads0, uploads0 = nav.reads, nav.uploads
    graph.counts["cholesky"] = 0
    _sync(dev)
    t0 = time.perf_counter()
    for cmd in commands[warmup:]:
        sim.step(cmd)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    timed = len(commands) - warmup
    est = [(t, f["poses"][f["best"]]) for t, f in zip([w[0] for w in sim.waypoints], sim.frames)]
    lms, _ = nav.map_estimate
    return {
        "mode": "navigator", "frames": len(commands), "elapsed_s": elapsed, "fps": timed / elapsed,
        "ate_rmse_loc": float(rmse(ate_location(est, sim.waypoints))),
        "final_landmarks": len(lms), "true_landmarks": len(world.landmarks),
        "final_ospa": float(ospa(lms, np.asarray(world.landmarks), c=1.0)[0]),
        # the navigator's reads back and each Cholesky's status
        "host_reads_per_frame": (nav.reads - reads0 + graph.counts["cholesky"]) / timed,
        "cholesky_per_frame": graph.counts["cholesky"] / timed,
        "host_uploads_per_frame": (nav.uploads - uploads0) / timed,
        "dtype": "float64", "device": str(dev), "card": card(dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-bench-isam2", description=__doc__)
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--scan-da", action="store_true")
    ap.add_argument("--variant", default="default")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    graph.assert_full_precision()
    if args.scan_da:
        result = run_scan_da(args.frames or 300, args.variant, args.device, args.seed)
        what = f"(scan on the device, Mahalanobis DA, {args.variant})"
    elif args.scan:
        result = run_scan(args.frames or 300, args.device, args.seed)
        what = "(scan on the device, known DA)"
    else:
        result = run_navigator(args.frames or 200, args.device, args.seed)
        what = "(host-interactive navigator)"
    print(json.dumps({
        "metric": f"frames/sec isam2-equivalent 3D sim {what}",
        "value": result["fps"],
        "unit": "frames/s",
        "vs_baseline": result["fps"] / 30.0,
    }))
    print(json.dumps({"detail": result}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
