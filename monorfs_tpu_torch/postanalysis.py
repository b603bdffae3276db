"""Post-analysis: error metrics from a recording zip (the port's twin of
monorfs_tpu.postanalysis; reference: postanalysis/Program.cs:42-145 +
Plot.cs:56-670).

    python -m monorfs_tpu_torch.postanalysis -f run.zip [--device cpu]

Reads a recording and computes ATE location / rotation, odometry drift, the
OSPA map error (with its spatial / cardinality split), map sizes and path
length, writing reference-style `<rec>.<metric>.data` files (time and value
per line). The trajectory metrics are NumPy on the host; the estimate-to-
landmark distance tables of the OSPA series are computed on `device` (cuda
by default; without a GPU the run raises unless given --device cpu).
"""

import argparse
import sys

import numpy as np
import torch

from . import resolve_device
from .io.recording import Recording
from .metrics.errors import (
    _interp_state,
    ate_location,
    ate_rotation,
    ospa,
    path_length,
    rmse,
)


def visited_landmarks(rec):
    """Groundtruth landmarks seen (detected at least once) up to each time
    (Plot.cs:216-271 'correct count' semantics)."""
    seen = []
    out = []
    for t, comps in rec.vismaps:
        for w, mean, _ in comps:
            if w > 0 and not any(np.allclose(mean, s) for s in seen):
                seen.append(np.asarray(mean))
        out.append((t, np.array(seen).reshape(-1, len(comps[0][1]) if comps else 3)))
    return out


def best_map_points(ws, means):
    """The reference's BestMapEstimate (Map.cs:119-142): pick
    floor(sum w) components greedily by weight, re-inserting each pick
    with weight - 1 -- so a weight-2 component (two merged landmarks)
    appears twice in the estimate."""
    ws = list(np.asarray(ws, float))
    means = list(means)
    n = int(np.floor(sum(ws)))
    out = []
    for _ in range(max(n, 0)):
        i = int(np.argmax(ws))
        out.append(means[i])
        ws.append(ws[i] - 1.0)
        means.append(means[i])
        ws[i] = -np.inf
    return np.array(out).reshape(-1, 3) if out else np.zeros((0, 3))


def map_estimates(rec):
    """MAP (best) map estimate per frame (BestMapEstimate semantics)."""
    out = []
    for t, comps in rec.maps:
        if not comps:
            out.append((t, np.zeros((0, 3))))
            continue
        ws = [w for w, _, _ in comps]
        means = [m for _, m, _ in comps]
        out.append((t, best_map_points(ws, means)))
    return out


def estimate_series(rec, mode="filter"):
    """Pose-estimate series per history mode (Plot.cs:325-340).

    filter: the ONLINE estimate — frame i's trajectory evaluated at index i
    (what the filter believed about 'now' at time i).
    smooth: the FINAL frame's full trajectory (the retrospective estimate of
    every past pose — this is where clone-on-resample genealogy and the
    loopy smoother show up).
    """
    if mode == "smooth":
        if not rec.estimate:
            return []
        return list(rec.estimate[-1][1])
    out = []
    for i, (t, traj) in enumerate(rec.estimate):
        if traj:
            out.append((t, traj[min(i, len(traj) - 1)][1]))
    return out


def best_trajectory(rec):
    """Backwards-compatible alias: the filter-mode series."""
    return estimate_series(rec, "filter")


def timed_series(rec, internal):
    """Timed history mode (Plot.cs:340-364): for every frame i, evaluate the
    full error series of frame i's trajectory estimate and report its mean
    from `startindex` on; startindex advances while the frame predates the
    'SLAM mode on' tag (pre-SLAM mapping frames are pinned to groundtruth
    and would dilute the mean)."""
    slamtime = next(
        (t for t, msg in rec.tags if "SLAM" in msg and "on" in msg), 0.0
    )
    out = []
    startindex = 0
    for t, traj in rec.estimate:
        series = internal(traj)
        vals = [v for _, v in series[startindex:]]
        out.append((t, float(np.mean(vals)) if vals else 0.0))
        if t < slamtime:
            startindex += 1
    return out


def odometry_drift(rec, window=10, mode="filter"):
    """Pose-delta error over `window`-frame windows (Plot.cs:407-442):
    dead-reckoned displacement (and, for 7-state poses, delta-rotation
    angle) vs groundtruth. Returns (loc series, rot series)."""
    from .metrics.errors import _quat_angle

    est = estimate_series(rec, "filter" if mode == "timed" else mode)
    loc, rot = [], []
    for i in range(window, len(est)):
        t0, s0 = est[i - window]
        t1, s1 = est[i]
        g0 = _interp_state(rec.trajectory, t0)
        g1 = _interp_state(rec.trajectory, t1)
        d = min(len(s0), len(g0), 3)
        drift = np.linalg.norm((s1[:d] - s0[:d]) - (g1[:d] - g0[:d]))
        loc.append((t1, float(drift)))
        if len(s0) == 7 and len(g0) == 7:
            # delta rotation mismatch: angle(est_delta vs true_delta)
            de = _quat_mul(_quat_conj(s0[3:7]), s1[3:7])
            dg = _quat_mul(_quat_conj(g0[3:7]), g1[3:7])
            rot.append((t1, float(_quat_angle(de, dg))))
        else:
            rot.append((t1, 0.0))
    return loc, rot


def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
        ]
    )


def pairwise_distances(estimates, truths, device):
    """Euclidean distance table [n_i, m_i] of each frame's map estimate
    against its visited landmarks, float64 on `device`, back as numpy (None
    where either side is empty)."""
    out = []
    for est, tru in zip(estimates, truths):
        if not len(est) or not len(tru):
            out.append(None)
            continue
        e = torch.as_tensor(np.asarray(est, np.float64), device=device)
        t = torch.as_tensor(np.asarray(tru, np.float64), device=device)
        out.append(torch.linalg.norm(e[:, None, :] - t[None, :, :], dim=-1))
    return [None if d is None else d.cpu().numpy() for d in out]


def analyze(rec: Recording, c: float = 1.0, p: float = 1.0,
            mode: str = "timed", reftime: float = None, device="cuda"):
    """Metrics suite; `mode` selects the trajectory history semantics
    (filter / smooth / timed, Plot.cs:325-369 — timed is the reference
    default, Program.cs:68). `reftime` aligns every trajectory estimate to
    groundtruth at that time before the ATE series (the -t flag,
    Program.cs:67 + Plot.cs:371-404; every reference script passes
    -t 0.0333)."""
    device = resolve_device(device)
    visited = visited_landmarks(rec)
    estimates = map_estimates(rec)

    if mode == "timed":
        loc = timed_series(
            rec, lambda traj: ate_location(traj, rec.trajectory, reftime)
        )
        rot = timed_series(
            rec, lambda traj: ate_rotation(traj, rec.trajectory, reftime)
        )
    else:
        est_traj = estimate_series(rec, mode)
        loc = ate_location(est_traj, rec.trajectory, reftime)
        rot = ate_rotation(est_traj, rec.trajectory, reftime)
    drift_loc, drift_rot = odometry_drift(rec, mode=mode)

    map_err, map_spatial, map_card, sizes, realsizes = [], [], [], [], []
    dists = pairwise_distances([e for _, e in estimates], [v for _, v in visited], device)
    for (t, est), (_, truth), dist in zip(estimates, visited, dists):
        total, spatial, card = ospa(est, truth, c=c, p=p, dist=dist)
        map_err.append((t, total))
        map_spatial.append((t, spatial))
        map_card.append((t, card))
        sizes.append((t, float(len(est))))
        realsizes.append((t, float(len(truth))))

    return {
        "loc": loc,
        "rot": rot,
        "odoloc": drift_loc,
        "odorot": drift_rot,
        "map": map_err,
        "mapspatial": map_spatial,
        "mapcard": map_card,
        "size": sizes,
        "realsize": realsizes,
        "pathlen": [(rec.trajectory[-1][0], path_length(rec.trajectory))]
        if rec.trajectory
        else [],
    }


def write_data_files(results, prefix):
    for name, series in results.items():
        with open(f"{prefix}.{name}.data", "w") as f:
            for t, v in series:
                f.write(f"{t:.6g} {v:.6g}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-postanalysis")
    ap.add_argument("-f", "--file", required=True, help="recording zip")
    ap.add_argument("-c", "--ospa-c", type=float, default=1.0)
    ap.add_argument("-p", "--ospa-p", type=float, default=1.0)
    ap.add_argument(
        "-H", "--history", default="timed", choices=["timed", "filter", "smooth"]
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    rec = Recording.load(args.file)
    results = analyze(rec, c=args.ospa_c, p=args.ospa_p, mode=args.history, device=args.device)
    write_data_files(results, args.file)
    print(f"ATE loc RMSE: {rmse(results['loc']):.6g}")
    print(f"ATE rot RMSE: {rmse(results['rot']):.6g}")
    if results["map"]:
        print(f"final OSPA({args.ospa_c},{args.ospa_p}): {results['map'][-1][1]:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
