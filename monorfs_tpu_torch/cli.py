"""Command-line interface of the port (the torch twin of monorfs_tpu.cli).

    python -m monorfs_tpu_torch.cli -f assets/sim3d.world -c assets/mov3d.in \
        -a phd -p 200 -r run.zip [--device cpu]

The flags of the reference CLI (mono-rfs/Program.cs:114-131):
  -f/--file scene or recording input, -c/--command command file,
  -r/--record output recording, -a/--algorithm phd|odometry|isam2|loopy,
  -p/--particles N, -y/--onlymapping, -g/--config cfg file,
  -i/--input simulation|record|kinect, -x/--headless (always true here),
plus --seed, --dtype, --progress, --checkpoint, --frames and --device (cuda
by default; without a GPU the run raises unless given --device cpu).

`-i kinect` reads an RGB-D sequence converted to .npz (frontend/dataset.py::
convert_tum) through the keypoint frontend, with the default camera
subsampled by the configuration's KinectDelta:

    python -m monorfs_tpu_torch.cli -f seq.npz -i kinect -a isam2 --dtype float64 -r kinect.zip"""

import argparse
import signal
import sys
import time

import numpy as np

from .config import Config
from .frontend.dataset import RGBDDataset
from .frontend.kinect import KinectSource
from .io import Recording, World, parse_commands
from .models.kinect_model import Params as KinectParams
from .sim.simulation import Simulation


def build_parser():
    ap = argparse.ArgumentParser(
        prog="monorfs-tpu-torch", description="RFS-SLAM runner (PyTorch/CUDA port)"
    )
    ap.add_argument("-f", "--file", required=True, help="scene world file or recording zip")
    ap.add_argument("-c", "--command", default=None, help="command (.in) file")
    ap.add_argument("-r", "--record", default=None, help="output recording zip")
    ap.add_argument("-a", "--algorithm", default="phd",
                    choices=["phd", "odometry", "isam2", "loopy"])
    ap.add_argument("-p", "--particles", type=int, default=1)
    ap.add_argument("-y", "--onlymapping", action="store_true")
    ap.add_argument("-g", "--config", default=None, help="cfg file")
    ap.add_argument("-i", "--input", default="simulation",
                    choices=["simulation", "record", "kinect"])
    ap.add_argument("-x", "--headless", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--checkpoint", default=None, help="periodic checkpoint recording file")
    ap.add_argument("--frames", type=int, default=None, help="cap the number of frames to run")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap


def kinect_camera(delta):
    """The default Kinect camera's intrinsics and sensor geometry in the
    frame of an image subsampled by `delta`."""
    cam = KinectParams()
    return KinectParams(
        focal=cam.focal / delta, film_left=cam.film_left / delta, film_top=cam.film_top / delta,
        film_width=cam.film_width / delta, film_height=cam.film_height / delta,
        range_min=cam.range_min, range_max=cam.range_max, res_x=cam.res_x / delta,
        res_y=cam.res_y / delta, border=max(1, cam.border // delta),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = Config()
    rec = None
    # config precedence (Program.cs:158-177): explicit -g > recording-embedded
    # > defaults, resolved before any consumer is constructed, so a -g
    # KinectDelta / KeypointFilter reaches the Kinect source
    if args.input == "record":
        rec = Recording.load(args.file)
        cfg.apply_descriptor(rec.config_text.splitlines())
    if args.config:
        cfg = Config.from_file(args.config)

    kinect_source = None
    if args.input == "kinect":
        kinect_source = KinectSource(RGBDDataset(args.file), delta=cfg.kinect_delta, device=args.device)
        world = World(
            pose=np.array([0, 0, 0, 1, 0, 0, 0.0]),
            landmarks=np.zeros((0, 3)),
            measurer_params=np.array(kinect_camera(cfg.kinect_delta).to_linear()),
        )
        commands = parse_commands(open(args.command).read()) if args.command else []
    elif args.input == "record":
        world = rec.world
        commands = []
    else:
        world = World.from_file(args.file)
        commands = parse_commands(open(args.command).read()) if args.command else []

    if not args.config and args.input != "record":
        # no explicit config: infer the model family from the world's pose
        # dimension (the reference requires `Model:` in the cfg)
        inferred = {1: "Linear1D", 2: "Linear2D", 7: "PRM3D"}.get(len(world.pose))
        if inferred and inferred != cfg.model:
            cfg.set_model_defaults(inferred)

    if args.frames is not None:
        commands = commands[: args.frames]
        if rec is not None:
            rec.odometry = rec.odometry[: args.frames]
            rec.trajectory = rec.trajectory[: args.frames]
            rec.measurements = rec.measurements[: args.frames]
            rec.estimate = [(t, traj[: args.frames]) for t, traj in rec.estimate[: args.frames]]

    t0 = time.time()
    sim = Simulation(
        cfg,
        world,
        commands,
        algorithm=args.algorithm,
        particles=args.particles,
        onlymapping=args.onlymapping,
        seed=args.seed,
        dtype=np.dtype(args.dtype),
        replay=rec,
        kinect_source=kinect_source,
        device=args.device,
    )

    # SIGINT -> graceful abort + save (Program.cs:65-87)
    abort = [False]
    prev_handler = signal.getsignal(signal.SIGINT)

    def _on_sigint(signum, frame):
        abort[0] = True

    try:
        signal.signal(signal.SIGINT, _on_sigint)
    except ValueError:
        pass  # not the main thread
    try:
        sim.run(progress=args.progress, checkpoint_file=args.checkpoint, abort_flag=abort)
    finally:
        try:
            signal.signal(signal.SIGINT, prev_handler)
        except ValueError:
            pass
    elapsed = time.time() - t0
    print(f"finished running ({elapsed:.4f} s)")

    if args.record:
        sim.save(args.record)
        print(f"recording written to {args.record}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
