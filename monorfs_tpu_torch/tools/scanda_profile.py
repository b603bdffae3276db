"""Ablate the Mahalanobis-DA scan runner's costs (the counterpart of
tools/scanda_profile.py): is the auction assignment or the marginal refresh
the gap to the known-label scan?

    python -m monorfs_tpu_torch.tools.scanda_profile [--frames 300] [--variant default] [--device cpu]

Sweeps marginals_every (4 = the default amortization, 10^9 = new-landmark
frames only) and the auction epsilon (bid increment; rounds scale ~1/eps),
timing the whole run each way: a first run, then the best of two more, the
outputs fetched inside the timed region. Prints one JSON line per
configuration: frames/s, ATE, OSPA, the final landmark count and the first
run's seconds."""

import argparse
import json
import math
import pathlib
import time

import numpy as np
import torch

from .. import resolve_device
from ..bench_isam2 import card, world_and_commands
from ..config import Config
from ..metrics.errors import ospa
from ..sim.simulation import model_for_config
from ..slam.isam2_scan import scan_draws
from ..slam.isam2_scan_da import build_mahalanobis_scan

ROOT = pathlib.Path(__file__).resolve().parents[2]
VARIANTS = [
    ("baseline (marg=4, builder-default eps)", {}),
    ("marg=never", {"marginals_every": 10**9}),
    ("marg=16", {"marginals_every": 16}),
    ("eps=.05", {"eps": 0.05}),
    ("eps=.2", {"eps": 0.2}),
    ("marg=16+eps=.05", {"marginals_every": 16, "eps": 0.05}),
]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-scanda-profile")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--variant", default="default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = Config.from_file(ROOT / "experiments" / "configs" / f"chap4-{args.variant}.cfg")
    world, cmds = world_and_commands(args.frames, torch.float32, dev)
    model_pre = model_for_config(cfg, world)
    lam = float(cfg.clutter_density) * float(model_pre.volume(model_pre.params))
    max_clutter = max(8, int(math.floor(10 * lam)) + 1)

    rows = []
    for tag, kw in VARIANTS:
        runner, carry, model = build_mahalanobis_scan(
            cfg, world, frames=args.frames, dtype=torch.float32, max_clutter=max_clutter, device=dev, **kw,
        )
        draws = scan_draws(model, cfg, world, args.frames, seed=args.seed, max_clutter=max_clutter,
                           device=dev)
        t0 = time.perf_counter()
        out_carry, (tp, ep, nlm) = runner(carry, cmds, draws)
        ep.cpu()
        first_s = time.perf_counter() - t0
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            out_carry, (tp, ep, nlm) = runner(carry, cmds, draws)
            tp_h, ep_h = tp.cpu().numpy(), ep.cpu().numpy()
            best = min(best, time.perf_counter() - t0)
        ate = float(np.sqrt(np.mean(np.sum((tp_h[:, :3] - ep_h[:, :3]) ** 2, -1))))
        lm_mask = out_carry.gstate.lm_mask.cpu().numpy()
        lms = out_carry.gstate.landmarks.cpu().numpy()[lm_mask]
        row = {
            "config": tag, "fps": args.frames / best, "ate": ate,
            "ospa": float(ospa(lms, np.asarray(world.landmarks), c=1.0)[0]),
            "landmarks": int(lm_mask.sum()), "first_run_s": first_s, "frames": args.frames,
            "device": str(dev), "card": card(dev),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
