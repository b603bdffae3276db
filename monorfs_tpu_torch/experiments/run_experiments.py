"""Experiment harness of the port: the thesis' chap3 / chap4 / chap5 grids
(the counterpart of experiments/run_experiments.py, function for function
and with the same command lines).

Mirrors mono-rfs/plots/scripts/** (e.g. chap3/S1-phd-odometry.sh:13-33,
chap4/S1-baseline.sh, chap5/S2-standard.sh): each experiment solves a world
with one or more algorithms through monorfs_tpu_torch.cli (re-solving the
identical recorded data where the reference does), runs postanalysis, and
renders its plots with the port's own rasterizer (no matplotlib).

Usage:
  python -m monorfs_tpu_torch.experiments.run_experiments chap3-s1 [--outdir experiments/out-h100-grid]
  python -m monorfs_tpu_torch.experiments.run_experiments chap3-s4   # particle sweep
  python -m monorfs_tpu_torch.experiments.run_experiments chap4-s1 [--variant noisy|cluttery|missed]
  python -m monorfs_tpu_torch.experiments.run_experiments all [--seeds 0,1,2] [--device cpu]

Every solve runs on --device (cuda by default; without a GPU the run
raises unless given --device cpu). The default output directory is
experiments/out-h100-grid, so the JAX package's experiments/out stays as
it is."""

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from .. import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "experiments"  # the cfg files and the default output directories

SEED = 0  # set by the --seeds loop; run_cli forwards it to every solve
DEVICE = "cuda"  # set by --device; run_cli and analyze forward it


def run_cli(args):
    from ..cli import main

    if SEED and "--seed" not in args:
        args = list(args) + ["--seed", str(SEED)]
    if DEVICE and "--device" not in args:
        args = list(args) + ["--device", str(DEVICE)]
    t0 = time.time()
    main(args)
    return time.time() - t0


def analyze(recfile, outdir, mode="timed"):
    from ..io.recording import Recording
    from ..metrics import rmse
    from ..postanalysis import analyze as _analyze, write_data_files

    rec = Recording.load(recfile)
    results = _analyze(rec, mode=mode, device=DEVICE)
    prefix = str(recfile) if mode == "timed" else f"{recfile}.{mode}"
    write_data_files(results, prefix)
    return {
        "ate_loc_rmse": rmse(results["loc"]),
        "ate_rot_rmse": rmse(results["rot"]),
        "final_ospa": results["map"][-1][1] if results["map"] else None,
    }


PLOT_SIZE, PLOT_DPI = (840, 480), 120.0  # the JAX plot: figsize (7, 4) at dpi 120


def plot_series(recfiles, labels, metric, output, title):
    """topdf.py equivalent: render .data series to png
    (reference: plots/scripts/topdf.py:30-301), drawn on DEVICE by the
    port's rasterizer: one line a recording, axes, legend and title."""
    from ..render import axes
    from ..render.png import write_png

    calls = []
    for rec, label in zip(recfiles, labels):
        try:
            series = np.loadtxt(f"{rec}.{metric}.data", ndmin=2)
        except FileNotFoundError:
            continue
        calls.append(axes.Call("plot", (series[:, 0], series[:, 1]), "", dict(label=label, lw=1.0)))
    fig = axes.Figure(calls, title=title, size=PLOT_SIZE, dpi=PLOT_DPI, equal=False, xlabel="time [s]",
                      ylabel=metric, legend="best")
    write_png(output, axes.render([fig], DEVICE)[0])


def chap3_s1(outdir, particles=100):
    """PHD vs odometry on the 3D sim world (chap3/S1-phd-odometry.sh)."""
    out = outdir / "chap3-s1"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap3-default.cfg")
    phd = str(out / "phd.zip")
    odo = str(out / "odometry.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", phd])
    run_cli(["-f", phd, "-i", "record", "-a", "odometry", "-g", cfg,
             "-r", odo])
    stats = {"phd": analyze(phd, out), "odometry": analyze(odo, out)}
    plot_series([phd, odo], ["phd", "odometry"], "loc",
                str(out / "loc.png"), "ATE location")
    plot_series([phd, odo], ["phd", "odometry"], "map",
                str(out / "ospa.png"), "OSPA map error")
    return stats


def chap3_s2(outdir):
    """Mapping-only study (chap3/S2-mapping.sh): 1 particle, poses pinned
    to groundtruth (-y), so the map error isolates the PHD update from
    localization error."""
    out = outdir / "chap3-s2"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap3-default.cfg")
    rec = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", "1", "-y", "-g", cfg, "-r", rec])
    return {"phd-mapping": analyze(rec, out)}


def chap3_s3(outdir, particles=100):
    """History plot modes (chap3/S3-plotmodes.sh): one PHD solve analyzed
    under the filter / smooth / timed history semantics (Plot.cs:325-369),
    .data files suffixed per mode like the reference's mv chain."""
    out = outdir / "chap3-s3"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap3-default.cfg")
    rec = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", rec])
    stats = {}
    for mode in ("filter", "smooth", "timed"):
        stats[mode] = analyze(rec, out, mode=mode)
    plot_series(
        [rec if m == "timed" else f"{rec}.{m}" for m in
         ("filter", "smooth", "timed")],
        ["filter", "smooth", "timed"], "loc", str(out / "loc.png"),
        "ATE by history mode",
    )
    return stats


def chap3_s5(outdir, particles=100):
    """Imprecise statistics (chap3/S5-imprecisestatistics.sh): the
    navigator's model deliberately mismatches the truth via the covariance
    multipliers (stat2 believes noise 1.2x, stat3 0.8x; Config.cs:88-91,
    applied PHDNavigator.cs:257-259). All solves replay stat1's record."""
    out = outdir / "chap3-s5"
    out.mkdir(parents=True, exist_ok=True)
    base = str(out / "stat1.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles),
             "-g", str(HERE / "configs" / "chap3-stat1.cfg"), "-r", base])
    stats = {"stat1": analyze(base, out)}
    for name in ("stat2", "stat3"):
        rec = str(out / f"{name}.zip")
        run_cli(["-f", base, "-i", "record", "-a", "phd",
                 "-p", str(particles),
                 "-g", str(HERE / "configs" / f"chap3-{name}.cfg"),
                 "-r", rec])
        stats[name] = analyze(rec, out)
    odo = str(out / "odometry.zip")
    run_cli(["-f", base, "-i", "record", "-a", "odometry",
             "-g", str(HERE / "configs" / "chap3-stat1.cfg"), "-r", odo])
    stats["odometry"] = analyze(odo, out)
    plot_series([base, str(out / "stat2.zip"), str(out / "stat3.zip"), odo],
                ["stat1 (exact)", "stat2 (1.2x)", "stat3 (0.8x)",
                 "odometry"], "map", str(out / "ospa.png"),
                "OSPA under model mismatch")
    return stats


def chap4_s7(outdir, particles=100):
    """Preprocessing ablation (chap4/S7-preprocessing.sh): iSAM2 with the
    default candidate discipline (NewLandmarkThreshold 3) vs none
    (nopreprocessing.cfg: threshold 1 -- every unmatched measurement
    births a landmark immediately), on one shared PHD record."""
    out = outdir / "chap4-s7"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap4-default.cfg")
    cfg_no = str(HERE / "configs" / "chap4-nopre.cfg")
    base = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", base])
    stats = {"phd": analyze(base, out)}
    legs = [("odometry", "odometry", cfg), ("isam2", "isam2", cfg),
            ("isam2-nopre", "isam2", cfg_no)]
    for name, alg, legcfg in legs:
        rec = str(out / f"{name}.zip")
        run_cli(["-f", base, "-i", "record", "-a", alg, "-g", legcfg,
                 "-r", rec])
        stats[name] = analyze(rec, out)
    return stats


def chap3_s4(outdir, sweep=(20, 100, 400)):
    """Particle count sweep (chap3/S4-particles.sh)."""
    out = outdir / "chap3-s4"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap3-default.cfg")
    stats = {}
    recs, labels = [], []
    for p in sweep:
        rec = str(out / f"phd{p}.zip")
        elapsed = run_cli(
            ["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(p), "-g", cfg, "-r", rec])
        stats[p] = analyze(rec, out)
        stats[p]["elapsed_s"] = elapsed
        recs.append(rec)
        labels.append(f"{p} particles")
    plot_series(recs, labels, "loc", str(out / "loc.png"),
                "ATE by particle count")
    return stats


def chap4_s1(outdir, variant="default", particles=100):
    """iSAM2 vs PHD vs odometry on identical data (chap4/S1-baseline.sh +
    the noisy/cluttery/missed variants)."""
    out = outdir / f"chap4-{variant}"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / f"chap4-{variant}.cfg")
    phd = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", phd])
    stats = {"phd": analyze(phd, out)}
    for alg in ("isam2", "odometry"):
        rec = str(out / f"{alg}.zip")
        run_cli(["-f", phd, "-i", "record", "-a", alg, "-g", cfg, "-r", rec])
        stats[alg] = analyze(rec, out)
    recs = [phd, str(out / "isam2.zip"), str(out / "odometry.zip")]
    plot_series(recs, ["phd", "isam2", "odometry"], "loc",
                str(out / "loc.png"), f"ATE location ({variant})")
    plot_series(recs, ["phd", "isam2", "odometry"], "map",
                str(out / "ospa.png"), f"OSPA ({variant})")
    return stats


def chap5_s2(outdir, particles=50):
    """Loopy PHD vs PHD vs odometry, Linear2D (chap5/S2-standard.sh)."""
    out = outdir / "chap5-s2"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap5-default2d.cfg")
    phd = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/linear2d.world"),
             "-c", str(ROOT / "assets/mov2d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", phd])
    stats = {"phd": analyze(phd, out)}
    odo = str(out / "odometry.zip")
    run_cli(["-f", phd, "-i", "record", "-a", "odometry", "-g", cfg,
             "-r", odo])
    stats["odometry"] = analyze(odo, out)
    # the smoother replays the odometry record: its initial estimate is the
    # dead-reckoned trajectory, exactly the reference's S2 workflow
    # (chap5/S2-standard.sh solves loopy on the odometry-generated record)
    rec = str(out / "loopy.zip")
    run_cli(["-f", odo, "-i", "record", "-a", "loopy", "-g", cfg, "-r", rec])
    stats["loopy"] = analyze(rec, out)
    recs = [phd, str(out / "loopy.zip"), odo]
    plot_series(recs, ["phd", "loopy", "odometry"], "loc",
                str(out / "loc.png"), "ATE location (2D)")
    return stats


def chap5_s1(outdir, particles=20):
    """Trivial smoother sanity grid (chap5/S1-trivial.sh): the DATA are
    generated under trivial.cfg (zero measurement noise, PD=1, no clutter)
    by an odometry leg, but the PHD/Loopy SOLVERS run with
    trivialestimate.cfg (nonzero noise model) -- exactly the reference's
    two-config workflow (S1-trivial.sh:21-38). Solving with the zero-noise
    config itself would make every measurement likelihood singular."""
    out = outdir / "chap5-s1"
    out.mkdir(parents=True, exist_ok=True)
    gencfg = str(HERE / "configs" / "chap5-trivial.cfg")
    cfg = str(HERE / "configs" / "chap5-trivialestimate.cfg")
    odo = str(out / "odometry.zip")
    run_cli(["-f", str(ROOT / "assets/linear2d.world"),
             "-c", str(ROOT / "assets/mov2d.in"), "-a", "odometry",
             "-g", gencfg, "-r", odo, "--frames", "160"])
    stats = {"odometry": analyze(odo, out)}
    phd = str(out / "phd.zip")
    run_cli(["-f", odo, "-i", "record", "-a", "phd", "-p", str(particles),
             "-g", cfg, "-r", phd])
    stats["phd"] = analyze(phd, out)
    rec = str(out / "loopy.zip")
    run_cli(["-f", odo, "-i", "record", "-a", "loopy", "-g", cfg, "-r", rec])
    stats["loopy"] = analyze(rec, out)
    return stats


def _chap5_loop(outdir, name, cfgname, particles):
    """Loop-closure circuit: PHD filter vs Loopy smoother vs odometry
    (chap5/K3-loop.sh / K4-hard.sh)."""
    out = outdir / name
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / cfgname)
    phd = str(out / "phd.zip")
    run_cli(["-f", str(ROOT / "assets/linear2dloop.world"),
             "-c", str(ROOT / "assets/mov2dloop.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", phd])
    stats = {"phd": analyze(phd, out)}
    odo = str(out / "odometry.zip")
    run_cli(["-f", phd, "-i", "record", "-a", "odometry", "-g", cfg,
             "-r", odo])
    stats["odometry"] = analyze(odo, out)
    rec = str(out / "loopy.zip")
    run_cli(["-f", odo, "-i", "record", "-a", "loopy", "-g", cfg, "-r", rec])
    stats["loopy"] = analyze(rec, out)
    recs = [phd, str(out / "loopy.zip"), odo]
    plot_series(recs, ["phd", "loopy", "odometry"], "loc",
                str(out / "loc.png"), f"ATE location ({name})")
    return stats


def chap5_k3(outdir, particles=50):
    return _chap5_loop(outdir, "chap5-k3", "chap5-default2d.cfg", particles)


def chap5_k4(outdir, particles=50):
    return _chap5_loop(outdir, "chap5-k4", "chap5-hard.cfg", particles)


def chap3_k6(outdir, frames=60):
    """Real-sensor-pipeline run (chap3/K6-realsensor.sh equivalent): a
    synthetic RGB-D stream (stand-in for room.oni -- no sensor hardware or
    oni assets here) through the full frontend (FAST + binary descriptors +
    temporal RANSAC filter) into PHD mapping."""
    out = outdir / "chap3-k6"
    out.mkdir(parents=True, exist_ok=True)
    from ..frontend.dataset import synthesize_rgbd

    npz = str(out / "synth_rgbd.npz")
    synthesize_rgbd(npz, frames=frames)
    cfg = str(HERE / "configs" / "chap3-kinect.cfg")
    rec = str(out / "kinect.zip")
    run_cli(["-f", npz, "-i", "kinect", "-a", "phd", "-p", "1", "-y",
             "-g", cfg, "-r", rec])
    from ..io.recording import Recording

    r = Recording.load(rec)
    counts = [len(m) for _, m in r.measurements]
    stats = {
        "kinect": {
            "frames": len(r.measurements),
            "mean_measurements": sum(counts) / max(len(counts), 1),
            "frames_with_measurements": sum(1 for c in counts if c > 0),
        }
    }

    # parallax phase: a true-3D perspective render (patches at varied
    # depths, analytic camera trajectory) through kinect -> isam2, with an
    # accuracy number -- the non-flat-wall evidence the textured pan above
    # cannot provide (its depth structure is a texture scroll, not geometry)
    from ..config import Config
    from ..frontend.dataset import RGBDDataset, synthesize_rgbd_parallax
    from ..frontend.kinect import KinectSource
    from ..io import World
    from ..models.kinect_model import Params as KinectParams
    from ..sim import Simulation

    h, w, focal = 120, 160, 200.0
    pnpz = str(out / "parallax_rgbd.npz")
    _, true_x = synthesize_rgbd_parallax(
        pnpz, frames=24, h=h, w=w, focal=focal, seed=5, travel=0.2
    )
    cam = KinectParams(
        focal=focal, film_left=-w / 2, film_top=-h / 2, film_width=w,
        film_height=h, range_min=0.1, range_max=5.0, res_x=w, res_y=h,
        border=1,
    )
    src = KinectSource(RGBDDataset(pnpz), camera=cam, delta=1,
                       max_keypoints=128, threshold=40.0, device=DEVICE)
    pworld = World(
        pose=np.array([0, 0, 0, 1, 0, 0, 0.0]),
        landmarks=np.zeros((0, 3)),
        measurer_params=np.asarray(cam.to_linear()),
    )
    pcfg = Config()
    pcfg.motion_covariance = np.diag([10.0, 10, 10, 0.1, 0.1, 0.1])
    sim = Simulation(pcfg, pworld, [], algorithm="isam2", particles=1,
                     kinect_source=src, dtype=np.float64, device=DEVICE)
    sim.run()
    sim.save(str(out / "parallax_isam2.zip"))
    traj = sim.isam2.trajectory
    est_x = traj[1:, 0] - traj[1, 0]
    want = true_x - true_x[0]
    err = np.abs(est_x - want)
    stats["parallax-isam2"] = {
        "frames": int(len(want)),
        "travel_m": float(want[-1]),
        "ate_loc_rmse": float(np.sqrt(np.mean(err ** 2))),
        "final_err_m": float(err[-1]),
    }
    return stats


# what experiments_kinect adds to the JAX functions' rows
_KINECT_EXTRA = ("host_reads_per_frame", "seconds")


def _jax_rows(stats):
    return {k: ({f: v for f, v in row.items() if f not in _KINECT_EXTRA} if isinstance(row, dict) else row)
            for k, row in stats.items()}


def chap3_k6real(outdir, frames=24):
    """Real-pixel TUM-format sequence through the full frontend
    (chap3/K6-realsensor.sh equivalent): REAL photographs on an analytic
    two-plane scene (assets/tum_real) -> convert_tum -> FAST/LATCH/RANSAC
    -> isam2 and phd-mapping, with ATE against the analytic camera
    trajectory (experiments_kinect.k6real)."""
    from .. import experiments_kinect

    return _jax_rows(experiments_kinect.k6real(outdir, DEVICE, np.float64, frames))


def chap4_k9(outdir, particles=50, frames=24, dtype=None,
             algs=("phd", "odometry", "isam2"), tag="chap4-k9"):
    """Real-sensor comparison (chap4/K9-realsensor.sh): PHD full SLAM vs
    odometry vs iSAM2 on one real-pixel RGB-D sequence (assets/tum_real),
    ATE against the analytic trajectory and OSPA against the true-pose
    reference map (experiments_kinect.k9, with this grid's seed)."""
    from .. import experiments_kinect

    experiments_kinect.SEED = SEED
    try:
        return _jax_rows(experiments_kinect.k9(outdir, particles, dtype or np.float64, tuple(algs),
                                               DEVICE, frames, tag))
    finally:
        experiments_kinect.SEED = 0


def chap4_s8(outdir, particles=100):
    """'Sandwich': solve the same recorded data with a chain of algorithms
    (chap4/S8-sandwich.sh:10-48: known-DA iSAM2 -> odometry -> PHD ->
    Mahalanobis iSAM2 over one shared record). Known-DA replays use the
    true association labels persisted in sightings.out."""
    out = outdir / "chap4-s8"
    out.mkdir(parents=True, exist_ok=True)
    cfg = str(HERE / "configs" / "chap4-default.cfg")
    cfg_known = str(HERE / "configs" / "chap4-known.cfg")
    base = str(out / "record.zip")
    run_cli(["-f", str(ROOT / "assets/sim3d.world"),
             "-c", str(ROOT / "assets/mov3d.in"), "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", base])
    stats = {"phd": analyze(base, out)}
    legs = [
        ("isam2-known", "isam2", cfg_known),
        ("odometry", "odometry", cfg),
        ("isam2-mahalanobis", "isam2", cfg),
    ]
    for name, alg, legcfg in legs:
        rec = str(out / f"{name}.zip")
        run_cli(["-f", base, "-i", "record", "-a", alg, "-g", legcfg,
                 "-r", rec])
        stats[name] = analyze(rec, out)
    # re-solve the odometry-solved record with phd again (the sandwich turn)
    rec2 = str(out / "phd-resolve.zip")
    run_cli(["-f", str(out / "odometry.zip"), "-i", "record", "-a", "phd",
             "-p", str(particles), "-g", cfg, "-r", rec2])
    stats["phd-resolve"] = analyze(rec2, out)
    return stats


EXPERIMENTS = {
    "chap3-s1": chap3_s1,
    "chap3-s2": chap3_s2,
    "chap3-s3": chap3_s3,
    "chap3-s4": chap3_s4,
    "chap3-s5": chap3_s5,
    "chap3-k6": chap3_k6,
    "chap3-k6real": chap3_k6real,
    "chap4-s1": chap4_s1,
    "chap4-s7": chap4_s7,
    "chap4-s8": chap4_s8,
    "chap4-k9": chap4_k9,
    "chap5-s1": chap5_s1,
    "chap5-s2": chap5_s2,
    "chap5-k3": chap5_k3,
    "chap5-k4": chap5_k4,
}


def build_parser(experiments, outdir):
    ap = argparse.ArgumentParser()
    ap.add_argument("experiment", choices=list(experiments) + ["all"])
    ap.add_argument("--outdir", default=str(outdir))
    ap.add_argument("--variant", default="default")
    ap.add_argument("--seeds", default="0",
                    help="comma list of RNG seeds; seed 0 writes the "
                         "canonical outputs, others land in seed<N>/ "
                         "subdirs and aggregate into <tag>.seeds.json "
                         "(the reference drives repeated runs with "
                         "runmultiple.sh)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap


def set_device(device):
    """Point every solve and analysis at `device` and return its label (the
    card's name and power limit, and the torch and CUDA versions); a CUDA
    device without a GPU raises here, before anything runs."""
    global DEVICE
    dev = resolve_device(device)
    DEVICE = str(device)
    if dev.type != "cuda":
        return f"{dev.type} (torch {torch.__version__})"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return (f"{torch.cuda.get_device_name(dev)} ({smi.strip().splitlines()[dev.index or 0]}); "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def main(argv=None):
    args = build_parser(EXPERIMENTS, HERE / "out-h100-grid").parse_args(argv)
    device = set_device(args.device)
    run_grid(args, EXPERIMENTS, post=lambda stats: stats.update(_device=device))


def run_grid(args, experiments, post=None):
    global SEED
    outdir = pathlib.Path(args.outdir)
    seeds = [int(x) for x in str(args.seeds).split(",") if x != ""]
    todo = list(experiments) if args.experiment == "all" else [args.experiment]
    for name in todo:
        fn = experiments[name]
        kwargs = (
            {"variant": args.variant}
            if "variant" in fn.__code__.co_varnames
            and getattr(args, "variant", None) is not None
            else {}
        )
        tag = name if name != "chap4-s1" else f"chap4-{args.variant}"
        per_seed = {}
        for seed in seeds:
            SEED = seed
            sdir = outdir if seed == 0 else outdir / f"seed{seed}"
            sdir.mkdir(parents=True, exist_ok=True)
            print(f"=== {name} (seed {seed}) ===", flush=True)
            t0 = time.time()
            stats = fn(sdir, **kwargs)
            if post:
                post(stats)
            stats["_wall_s"] = round(time.time() - t0, 1)
            per_seed[seed] = stats
            for k, v in stats.items():
                print(f"  {k}: {v}", flush=True)
            if seed == 0:
                with open(outdir / f"{tag}.stats.json", "w") as f:
                    json.dump(stats, f, indent=1, default=str)
        SEED = 0
        if len(seeds) > 1:
            with open(outdir / f"{tag}.seeds.json", "w") as f:
                json.dump({str(k): v for k, v in per_seed.items()}, f,
                          indent=1, default=str)


if __name__ == "__main__":
    main()
