"""Diagnostic replay of the isam2 navigator on a recorded dataset (the
counterpart of tools/isam2_lab.py).

Logs candidate promotion events (position, distance to nearest existing
graph landmark) to find where duplicate landmarks come from, and reports
final map size / OSPA / ATE.

Usage:
  python -m monorfs_tpu_torch.tools.isam2_lab experiments/out-h100/chap4-default/phd.zip \\
      -g experiments/configs/chap4-default.cfg [--frames 120] [--device cpu]

Prints the JAX tool's lines, then one JSON object: the promotions (frame,
label, distance to the nearest other landmark), the final landmark count,
ATE and OSPA at full precision."""

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-isam2-lab")
    ap.add_argument("record")
    ap.add_argument("-g", "--config", required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--da", default=None)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--marginals-every", type=int, default=None)
    ap.add_argument("--full-solve-every", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dtype = np.float64 if args.dtype == "float64" else np.float32

    from ..config import Config
    from ..io.recording import Recording
    from ..metrics import rmse
    from ..metrics.errors import ate_location, ospa
    from ..sim.simulation import model_for_config
    from ..slam.isam2nav import ISAM2Navigator

    rec = Recording.load(args.record)
    cfg = Config.from_file(args.config)
    model = model_for_config(cfg, rec.world)

    odometry = [o for _, o in rec.odometry]
    meas = [zs for _, zs in rec.measurements]
    truth = rec.trajectory
    n = args.frames or len(odometry)

    nav = ISAM2Navigator(
        model, cfg, np.asarray(rec.world.pose, dtype),
        max_poses=n + 2,
        max_landmarks=max(4 * len(rec.world.landmarks), 64),
        meas_per_frame=max(max((len(z) for z in meas), default=1), 1),
        dtype=dtype, solve_dtype=torch.float64 if args.dtype == "float64" else torch.float32,
        da_algorithm=args.da, device=dev,
        **{k: v for k, v in (
            ("marginals_every", args.marginals_every),
            ("full_solve_every", args.full_solve_every),
        ) if v is not None},
    )

    promos = []
    nav.debug_promotions = []
    t0 = time.time()
    for i in range(n):
        nav.predict(np.asarray(odometry[i], dtype))
        before = nav.next_label
        n_dbg = len(nav.debug_promotions)
        nav.slam_update(list(meas[i]))
        for ev in nav.debug_promotions[n_dbg:]:
            ev["frame"] = i
        if nav.next_label > before:
            for lab in range(before, nav.next_label):
                if lab >= nav.max_landmarks or not nav.lm_mask_np[lab]:
                    continue
                pos = nav.landmarks_np[lab]
                others = nav.landmarks_np[nav.lm_mask_np]
                d = np.linalg.norm(others - pos, axis=1)
                d = d[d > 1e-12]
                promos.append((i, lab, float(d.min()) if len(d) else np.inf))
        if (i + 1) % 50 == 0:
            print(f"frame {i + 1}/{n}  landmarks {int(nav.lm_mask_np.sum())}"
                  f"  [{time.time() - t0:.0f}s]", flush=True)

    est, _ = nav.map_estimate
    lm_true = np.asarray(rec.world.landmarks)
    # poses_np[0] is the initial pose; frame i lands in poses_np[i + 1]
    series = [
        (truth[i][0], nav.poses_np[i + 1])
        for i in range(min(nav.n_poses - 1, len(truth)))
    ]
    ate = float(rmse(ate_location(series, truth)))
    map_ospa = float(ospa(est, lm_true, c=1.0)[0])
    print(f"\nfinal: {len(est)} landmarks vs {len(lm_true)} true")
    print(f"ATE RMSE {ate:.4f}")
    print(f"OSPA {map_ospa:.4f}")
    dup = [(f, lab, round(d, 3)) for f, lab, d in promos if d < 0.5]
    print(f"promotions: {len(promos)}, of which near-duplicates (<0.5): "
          f"{len(dup)}")
    for f, lab, d in dup[:40]:
        print(f"  frame {f}: label {lab} at {d} from nearest existing")
    print("\npromotion-time diagnostics (at decision time):")
    for ev in nav.debug_promotions:
        if "dist" not in ev:
            print(f"  frame {ev.get('frame')}: label {ev['label']} "
                  f"(first landmark)")
            continue
        print(f"  frame {ev.get('frame')}: label {ev['label']} z {ev['z']} "
              f"dist {ev['dist']:.3f} nearest {ev['nearest']} "
              f"vis={ev['nearest_visible']} matched={ev['nearest_matched']} "
              f"d2={ev['nearest_d2']:.2f}")
    result = {"tool": "isam2_lab", "device": str(dev), "frames": n, "landmarks": int(len(est)),
              "true_landmarks": int(len(lm_true)), "ate": ate, "ospa": map_ospa,
              "promotions": [[f, lab, d] for f, lab, d in promos],
              "promotion_events": [[ev.get("frame"), int(ev["label"])] for ev in nav.debug_promotions]}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
