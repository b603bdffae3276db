"""Headline benchmark of the port on one GPU: RB-PHD SLAM on the 3D
pixel-range world, 200 particles, the PHDConfig of the repository's bench.py.

    python -m monorfs_tpu_torch.bench

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} (vs_baseline
against the 30 frames/s real-time rate) and the result dict on stderr."""

import json
import pathlib
import sys

from .bench_core import run_benchmark
from .slam.phd import PHDConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent

# bench.py:39-51 of the repository
BENCH_CONFIG = PHDConfig(
    num_particles=200,
    max_components=128,
    max_measurements=48,
    gate_top=8,
    estimate_cap=48,
    beam_width=32,
    beam_meas_cap=24,
    beam_candidates=6,
    merge_rounds=4,
    meas_compact=24,
)


def run(frames=300, device="cuda"):
    return run_benchmark(
        ROOT / "assets" / "sim3d.world",
        ROOT / "assets" / "mov3d.in",
        particles=BENCH_CONFIG.num_particles,
        frames=frames,
        phd_cfg=BENCH_CONFIG,
        device=device,
    )


def main():
    result = run()
    print(json.dumps({
        "metric": "frames/sec/gpu PHD-SLAM 3D sim 200 particles",
        "value": result["fps"],
        "unit": "frames/s",
        "vs_baseline": result["fps"] / 30.0,
    }))
    print(json.dumps({"detail": result}), file=sys.stderr)


if __name__ == "__main__":
    main()
