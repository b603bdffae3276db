"""Iteration harness for the chap5 smoother experiments (the counterpart of
tools/smoother_lab.py).

Loads an odometry recording (the reference's Loopy-PHD input,
chap5/S2-standard.sh:26-40), builds the LoopyPHDNavigator exactly like
Simulation._run_loopy does, and reports per-sweep ATE vs the record's
groundtruth plus the final map OSPA -- so smoother changes can be evaluated
in seconds instead of re-running the whole experiment grid.

Usage:
  python -m monorfs_tpu_torch.tools.smoother_lab experiments/out-h100/chap5-s1/odometry.zip \\
      [--sweeps 12] [--gauge-fix/--no-gauge-fix] [--anchor-sigma 0.5] [--frames N] [--device cpu]

Prints the JAX tool's lines, then one JSON object with every number at full
precision: the initial ATE, each sweep's ATE of the best and the current
state, its objective (and OSPAs with --ospa-each), the final ATE and OSPA."""

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device


def build_parser():
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-smoother-lab")
    ap.add_argument("record")
    ap.add_argument("--sweeps", type=int, default=12)
    ap.add_argument("--gauge-fix", action="store_true", default=None)
    ap.add_argument("--no-gauge-fix", dest="gauge_fix", action="store_false")
    ap.add_argument("--anchor-sigma", type=float, default=None)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--mix-cap", type=int, default=None)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--t0", type=float, default=None,
                    help="annealing start temperature (default: 0 with "
                    "refit, 5 without -- see loopynav)")
    ap.add_argument("--ga-iters", type=int, default=None)
    ap.add_argument("--ga-steps", type=int, default=None)
    ap.add_argument("--refit-seeds", type=int, default=None)
    ap.add_argument("--refit-gate", type=float, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--ospa-each", action="store_true",
                    help="also filter + report the map OSPA after every "
                    "sweep (which sweep's state maps best?)")
    ap.add_argument("-g", "--config", default=None,
                    help="solver cfg (overrides the record's embedded cfg, "
                    "like the grid's -g flag)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from ..config import Config
    from ..io.recording import Recording
    from ..metrics import rmse
    from ..metrics.errors import ate_location, ospa
    from ..sim.simulation import model_for_config
    from ..slam import loopy
    from ..slam.loopynav import LoopyPHDNavigator

    rec = Recording.load(args.record)
    if args.config:
        cfg = Config.from_file(args.config)
    else:
        cfg = Config()
        cfg.apply_descriptor(rec.config_text.splitlines())
    model = model_for_config(cfg, rec.world)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32

    est_traj = np.array([v for _, v in rec.estimate[-1][1]])
    odometry = [o for _, o in rec.odometry]
    meas = [zs for _, zs in rec.measurements]
    times = [t for t, _ in rec.trajectory]
    if args.frames:
        est_traj = est_traj[: args.frames]
        odometry = odometry[: args.frames]
        meas = meas[: args.frames]
        times = times[: args.frames]

    t = len(est_traj)
    max_meas = max(max((len(z) for z in meas), default=1), 1)
    lkw = {}
    if args.gauge_fix is not None:
        lkw["gauge_fix"] = args.gauge_fix
    if args.anchor_sigma is not None:
        lkw["anchor_sigma"] = args.anchor_sigma
    if args.blocks is not None:
        lkw["blocks"] = args.blocks
    if args.mix_cap is not None:
        lkw["mix_cap"] = args.mix_cap
    for k in ("ga_iters", "ga_steps", "refit_seeds", "refit_gate"):
        v = getattr(args, k)
        if v is not None:
            lkw[k] = v
    lcfg = loopy.LoopyConfig(max_nodes=t, max_meas=max_meas, **lkw)

    nav = LoopyPHDNavigator(
        model, cfg, est_traj, odometry, meas, max_meas=max_meas, dtype=dtype,
        loopy_cfg=lcfg, anneal_t0=args.t0, device=dev,
    )

    truth = [(ti, s) for ti, s in rec.trajectory[:t]]
    world_lm = np.asarray(rec.world.landmarks)

    def ate_of(traj):
        series = [(times[i], traj[i]) for i in range(len(traj))]
        return float(rmse(ate_location(series, truth)))

    def ospa_of(state=None):
        if state is None:
            mm = nav.map_model()
        else:
            gm = loopy.final_map(model, nav.lcfg, nav.params, state, nav.z, nav.z_mask)
            mm = nav._gm_components(gm)
        est = np.array([m for _, m, _ in mm]) if mm else np.zeros((0, 3))
        d = world_lm.shape[1] if world_lm.size else 3
        return float(ospa(est[:, :d] if est.size else est, world_lm, c=1.0)[0])

    ate0 = ate_of(est_traj)
    print(f"init ATE {ate0:.4f}  ({t} frames, {max_meas} max meas)")
    result = {"tool": "smoother_lab", "device": str(dev), "frames": t, "max_meas": max_meas,
              "init_ate": ate0, "sweeps": []}
    t0 = time.time()
    for s in range(args.sweeps):
        nav.sweep()
        ate = ate_of(nav.trajectory)
        ate_cur = ate_of(loopy.fused_trajectory(model, nav.state).cpu().numpy()[:t])
        row = {"sweep": s + 1, "ate_best": ate, "ate_cur": ate_cur, "objective": float(nav.best_objective)}
        extra = ""
        if args.ospa_each:
            row.update(ospa_cur=ospa_of(nav.state), ospa_best=ospa_of(nav.best_state))
            extra = f"  OSPA(cur) {row['ospa_cur']:.4f}  OSPA(best) {row['ospa_best']:.4f}"
        print(
            f"sweep {s + 1:2d}: ATE(best) {ate:.4f}  ATE(cur) {ate_cur:.4f}"
            f"  obj {nav.best_objective:.1f}{extra}  [{time.time() - t0:.1f}s]",
            flush=True,
        )
        result["sweeps"].append(row)
    final_ospa = ospa_of()
    result.update(final_ate=ate_of(nav.trajectory), final_ospa=final_ospa)
    print(f"final: ATE {result['final_ate']:.4f} vs init {ate0:.4f}  OSPA {final_ospa:.4f}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
