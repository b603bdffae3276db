"""Diagnose smoother divergence on a recorded chap5 run: per-sweep ATE and
trajectory objective against the record's groundtruth (the counterpart of
tools/debug_loopy.py).

    python -m monorfs_tpu_torch.tools.debug_loopy REC [SWEEPS] [--anchor S] [--no-gauge]
        [--config CFG] [--dtype float64] [--device cpu]

Prints the JAX tool's lines, then one JSON object with every number at full
precision."""

import argparse
import json

import numpy as np
import torch

from .. import models, resolve_device
from ..config import Config
from ..io.recording import Recording
from ..slam import loopy
from ..slam.loopynav import LoopyPHDNavigator


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-debug-loopy")
    ap.add_argument("recfile")
    ap.add_argument("sweeps", type=int, nargs="?", default=12)
    ap.add_argument("--anchor", type=float, default=None)
    ap.add_argument("--no-gauge", action="store_true")
    ap.add_argument("--config", default=None,
                    help="cfg file overriding the recorded config")
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = Recording.load(args.recfile)
    cfg = Config()
    cfg_text = rec.config_text
    if args.config:
        cfg_text = open(args.config).read()
    if cfg_text:
        cfg.apply_descriptor(cfg_text.splitlines())
        cfg.set_model_defaults(cfg.model)
        cfg.apply_descriptor(cfg_text.splitlines())
    model = models.get(cfg.model)

    truth = np.array([p for _, p in rec.trajectory])
    # final estimate trajectory = last history snapshot
    est = np.array([v for _, v in rec.estimate[-1][1]])
    odometry = [o for _, o in rec.odometry]
    meas = [zs for _, zs in rec.measurements]
    t = len(truth)
    print(f"frames={t} meas/frame={np.mean([len(m) for m in meas]):.1f}")

    def ate(traj):
        d = traj[: len(truth), : truth.shape[1]] - truth[: len(traj)]
        return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))

    result = {"tool": "debug_loopy", "device": str(dev), "frames": t, "init_ate": ate(est), "sweeps": []}
    print(f"init (record estimate) ATE: {result['init_ate']:.4f}")
    lcfg = None
    if args.anchor is not None or args.no_gauge:
        kw = {}
        if args.anchor is not None:
            kw["anchor_sigma"] = args.anchor
        if args.no_gauge:
            kw["gauge_fix"] = False
        lcfg = loopy.LoopyConfig(max_nodes=t, max_meas=16, **kw)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    nav = LoopyPHDNavigator(model, cfg, est, odometry, meas, max_meas=16, dtype=dtype, loopy_cfg=lcfg,
                            device=dev)
    result["init_objective"] = float(nav.objective())
    print(f"objective(init): {result['init_objective']:.2f}")
    for s in range(args.sweeps):
        nav.sweep()
        cur = loopy.fused_trajectory(nav.model, nav.state).detach().cpu().numpy()
        best = nav.trajectory
        row = {"sweep": s + 1, "ate_cur": ate(cur), "ate_best": ate(best), "objective": float(nav.objective()),
               "best_objective": float(nav.best_objective)}
        result["sweeps"].append(row)
        print(f"sweep {s+1}: ATE(cur)={row['ate_cur']:.4f} "
              f"ATE(best)={row['ate_best']:.4f} obj={row['objective']:.2f} "
              f"bestobj={row['best_objective']:.2f}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
