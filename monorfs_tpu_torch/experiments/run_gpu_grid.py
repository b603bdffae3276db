"""Reference-scale experiment grid through the port's float32 hot path on
one GPU (the counterpart of experiments/run_tpu_grid.py).

The thesis grid (run_experiments.py) runs at reduced particle counts; this
grid runs the reference's actual operating points -- 800 particles for
chap3/chap4 and the 20/100/800/2000 particle sweep (reference:
mono-rfs/plots/scripts/chap3/S1-phd-odometry.sh:13,
chap3/S4-particles.sh:14, chap4/S1-baseline.sh:13) -- in float32 on the
card, so every PHD leg runs both hand-written kernels (the graph legs run in
float64 on the card, as -a isam2 always does).

Two kinds of numbers, measured separately on purpose:
  * accuracy artifacts (recording zips + postanalysis .data files) come
    from the Simulation loop (cli.main, the same code path as the thesis
    grid, so the rows are directly comparable);
  * throughput comes from the bench runner (bench_core.run_benchmark) at
    the sweep's shapes: the second of two identical 300-frame runs, without
    the Simulation's per-frame history.

Usage:
  python -m monorfs_tpu_torch.experiments.run_gpu_grid chap3-s1 [--outdir experiments/out-h100]
  python -m monorfs_tpu_torch.experiments.run_gpu_grid chap3-s4     # 20/100/800/2000 sweep
  python -m monorfs_tpu_torch.experiments.run_gpu_grid chap4-default
  python -m monorfs_tpu_torch.experiments.run_gpu_grid throughput   # bench-runner fps sweep
  python -m monorfs_tpu_torch.experiments.run_gpu_grid all [--device cpu]

The device (cuda by default; without a GPU the run raises unless given
--device cpu) is recorded in every stats file as `_device`: the card's name
and power limit as nvidia-smi gives them, and the torch and CUDA versions."""

import pathlib

import torch

from . import run_experiments as G

HERE = G.HERE
ROOT = G.ROOT
SWEEP = (20, 100, 200, 800, 2000)  # throughput's particle counts
FRAMES = 300  # throughput's frames per run


def chap3_s1_gpu(outdir):
    return G.chap3_s1(outdir, particles=800)


def chap3_s4_gpu(outdir):
    return G.chap3_s4(outdir, sweep=(20, 100, 800, 2000))


def chap4_default_gpu(outdir, variant="default"):
    return G.chap4_s1(outdir, variant=variant, particles=800)


def chap4_noisy_gpu(outdir):
    return G.chap4_s1(outdir, variant="noisy", particles=800)


def chap4_cluttery_gpu(outdir):
    return G.chap4_s1(outdir, variant="cluttery", particles=800)


def sweep_config(particles):
    """The throughput sweep's PHDConfig (run_tpu_grid.py:97-110)."""
    from ..slam.phd import PHDConfig

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
        meas_compact=40,  # live-first compaction at the world's visibility
        # bound (40 landmarks)
    )


def throughput(outdir, counts=SWEEP):
    """Bench-runner frames/s at the sweep particle counts (the wall-clock
    column for the accuracy rows above), with particle updates per second
    and the peak device memory of the run."""
    from ..bench_core import run_benchmark
    from ..config import Config

    cfg = Config.from_file(HERE / "configs" / "chap3-default.cfg")
    dev = torch.device(G.DEVICE)
    stats = {}
    for p in counts:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        r = run_benchmark(
            ROOT / "assets" / "sim3d.world",
            ROOT / "assets" / "mov3d.in",
            particles=p,
            frames=FRAMES,
            dtype=torch.float32,
            cfg=cfg,
            phd_cfg=sweep_config(p),
            device=dev,
        )
        stats[p] = {
            "fps": r["fps"],
            "step_ms": 1e3 / r["fps"],
            "particle_updates_per_s": r["fps"] * p,
            "ate_rmse_loc": r["ate_rmse_loc"],
            "warmup_s": r["warmup_s"],
            "frames": r["frames"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            "device": r["device"],
        }
        print(f"  {p} particles: {stats[p]}", flush=True)
    return stats


EXPERIMENTS = {
    "chap3-s1": chap3_s1_gpu,
    "chap3-s4": chap3_s4_gpu,
    "chap4-default": chap4_default_gpu,
    "chap4-noisy": chap4_noisy_gpu,
    "chap4-cluttery": chap4_cluttery_gpu,
    "chap5-s1": G.chap5_s1,
    "chap5-s2": G.chap5_s2,
    "chap5-k3": G.chap5_k3,
    "chap5-k4": G.chap5_k4,
    "throughput": throughput,
}


def main(argv=None):
    args = G.build_parser(EXPERIMENTS, HERE / "out-h100").parse_args(argv)
    device = G.set_device(args.device)
    pathlib.Path(args.outdir).mkdir(parents=True, exist_ok=True)
    G.run_grid(args, EXPERIMENTS, post=lambda stats: stats.update(_device=device))


if __name__ == "__main__":
    main()
