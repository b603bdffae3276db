"""Particle-count scaling benchmark of the port on one GPU (the counterpart
of the repository's bench_scaling.py).

    python -m monorfs_tpu_torch.bench_scaling [--large] [--particles 200,1000] [--frames 50]
        [--device cpu]

Runs the bench runner (bench_core.run_benchmark: the second of two identical
runs, outputs fetched inside the timed region) at 200, 1000, 5000 and 10000
particles (--large adds 20000 and 50000), 50 frames of the 3D asset world in
float32 at the bench PHDConfig with merge_rounds=4 (both hand-written
kernels on every frame), and prints one JSON line per count: frames/s,
particle updates/s, ATE, the peak device memory (torch.cuda.
max_memory_allocated over the count's runs; null on the CPU) and the
device. The default device is cuda; without a GPU it raises unless given
--device cpu."""

import argparse
import json

import torch

from . import resolve_device
from .bench import ROOT
from .bench_core import run_benchmark
from .slam.phd import PHDConfig

COUNTS = (200, 1000, 5000, 10000)
LARGE = (20000, 50000)


def scaling_config(particles):
    """bench_scaling.py:31-41 of the repository."""
    return PHDConfig(
        num_particles=particles,
        max_components=128,
        max_measurements=48,
        gate_top=8,
        estimate_cap=48,
        beam_width=32,
        beam_meas_cap=24,
        beam_candidates=6,
        merge_rounds=4,
    )


def run(particles, frames=50, device="cuda"):
    """One count's row."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    r = run_benchmark(ROOT / "assets" / "sim3d.world", ROOT / "assets" / "mov3d.in", particles=particles,
                      frames=frames, dtype=torch.float32, phd_cfg=scaling_config(particles), device=dev)
    return {
        "particles": particles,
        "frames": r["frames"],
        "fps": r["fps"],
        "particle_updates_per_s": r["fps"] * particles,
        "ate_rmse_loc": r["ate_rmse_loc"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "device": r["device"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-bench-scaling")
    ap.add_argument("--large", action="store_true", help="add 20000 and 50000 particles")
    ap.add_argument("--particles", default=None, help="comma list replacing the default counts")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    counts = [int(x) for x in args.particles.split(",")] if args.particles else list(COUNTS)
    if args.large:
        counts += list(LARGE)
    rows = []
    for p in counts:
        rows.append(run(p, args.frames, dev))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
