"""The BASELINE flagship configuration on the port (the counterpart of the
repository's bench_flagship.py): 100k particles and a 10k-landmark
distributed Schur BA, over every rank of a torch.distributed run.

    python -m monorfs_tpu_torch.bench_flagship [--particles 100000]
        [--landmarks 10240] [--poses 128] [--steps 20] [--scaling]
        [--world N --rank R --init tcp://HOST:PORT] [--device cpu]

Measures, one JSON line each (printed by rank 0):
  1. the particle-sharded PHD step (parallel.mesh.make_sharded_step) at
     --particles, PRM3D float32, PHDConfig K=128, M=48 compacted to the
     beam's 24, beam 32 x 6, 4 merge rounds: seconds a step, particle
     updates a second, peak device memory;
  2. the landmark-sharded Schur BA (parallel.dist_ba) over --landmarks
     (big_world: a 100 m cube in front of the cameras) x --poses, 64 exact
     factors a pose, float32:
     seconds a Gauss-Newton iteration, peak device memory;
  3. strong-scaling efficiency time(1 rank) / (N time(N ranks)), with
     --scaling and N > 1; with one rank the line reports the world of one
     and no ratio.
Every line carries the world size and the card's name and power limit as
nvidia-smi gives them. One process drives one card (NCCL takes no two
ranks on one GPU): start one process per card with --world / --rank /
--init; with no --world the run is a world of one on a free local port.
The default device is cuda; without a GPU it raises unless given
--device cpu (gloo, for a run at a small size).
"""

import argparse
import json
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from .bench_isam2 import card
from .config import Config
from .models import get as get_model
from .parallel import dist_ba, make_mesh, make_sharded_step, multihost
from .slam import phd

PARTICLES = 100_000  # the BASELINE flagship: 100k particles, a 10k-landmark BA
LANDMARKS = 10_240
# the flagship's filter budget, the one cfg that states it for this script and the command line
FLAGSHIP_CFG = pathlib.Path(__file__).resolve().parent.parent / "experiments" / "configs" / "flagship.cfg"


def big_world(n_landmarks, seed=0):
    """The synthetic landmark world: the JAX package's 100 m cube (the
    scene scale of BASELINE configs[4]), its depth folded in front of the
    cameras (z = |z| + 5). In the cube itself half the landmarks lie behind
    the cameras, and the reduced pose system of the BA is not positive
    definite, in float32 and float64 alike: the JAX package's solve returns
    NaN there (cho_factor does not raise), the port's Cholesky raises."""
    rng = np.random.default_rng(seed)
    lms = np.column_stack([
        rng.uniform(-50.0, 50.0, n_landmarks),
        rng.uniform(-50.0, 50.0, n_landmarks),
        rng.uniform(-50.0, 50.0, n_landmarks),
    ])
    lms[:, 2] = np.abs(lms[:, 2]) + 5.0
    return lms


def flagship_config(particles):
    """The filter budget of bench_flagship.py:62-72 of the repository, as
    FLAGSHIP_CFG states it (MaxQuantity and the PHD step's budget keys),
    with 48 measurement slots."""
    cfg = Config.from_file(FLAGSHIP_CFG)
    return phd.PHDConfig(num_particles=particles, max_components=cfg.max_quantity, max_measurements=48,
                         **cfg.phd_budget())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def bench_phd(particles, mesh, steps=20, warm=2):
    """The sharded SLAM step at scale: (seconds a step, peak device bytes).
    Every rank draws the same global normals from one seed and reads its
    rows."""
    dev = mesh.device
    model, pcfg = get_model("PRM3D"), flagship_config(particles)
    params = Config().phd_params(torch.float32, dev)
    whole = phd.init_state(model, pcfg, np.array([0, 0, 0, 1, 0, 0, 0.0]), torch.float32, dev)
    state = multihost.shard_state_global(whole, mesh)
    del whole
    step = make_sharded_step(model, pcfg, mesh)
    rng = np.random.default_rng(1)
    z = np.zeros((48, 3), np.float32)
    z[:12] = np.column_stack([rng.uniform(-200, 200, 12), rng.uniform(-150, 150, 12),
                              rng.uniform(0.3, 1.8, 12)])
    z = torch.tensor(z, device=dev)
    z_mask = torch.arange(48, device=dev) < 12
    odo = torch.zeros(6, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(state):
        normals = torch.randn((particles, 6), generator=gen, device=dev)
        u = torch.rand((), generator=gen, device=dev)
        return step(params, state, odo, z, z_mask, normals, u)

    _reset_peak(dev)
    for _ in range(warm):
        state = one(state)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = one(state)
    _sync(dev)
    seconds = (time.perf_counter() - t0) / steps
    if not torch.isfinite(state.logweight).all():
        raise RuntimeError("the sharded step produced non-finite log-weights")
    return seconds, _peak(dev)


def bench_ba(n_landmarks, mesh, n_poses=128, iters=3, factors_per_pose=64, reps=3):
    """The distributed Schur BA at scale: (seconds a Gauss-Newton
    iteration, peak device bytes)."""
    dev = mesh.device
    model = get_model("PRM3D")
    n = mesh.size
    lms = big_world(n_landmarks).astype(np.float32)
    rng = np.random.default_rng(2)
    n_factors = n_poses * factors_per_pose
    f_cap = ((n_factors * 2 + n - 1) // n) * n
    dcfg = dist_ba.DistBAConfig(max_poses=n_poses, max_landmarks=n_landmarks, max_factors=f_cap,
                                gn_iters=iters)
    poses = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32), (n_poses, 1))
    poses[:, 0] = np.linspace(0, 10, n_poses)
    f_pose = rng.integers(0, n_poses, n_factors).astype(np.int32)
    f_lm = rng.integers(0, n_landmarks, n_factors).astype(np.int32)
    # exact synthetic measurements at the true geometry
    f_z = model.measure(model.params, torch.tensor(poses)[f_pose], torch.tensor(lms)[f_lm]).numpy()
    fp, fl, fz, fm = dist_ba.partition_factors(dcfg, n, f_pose, f_lm, f_z, np.ones(n_factors, bool))
    slms, slmask, fp, fl, fz, fm = dist_ba.shard_ba_inputs(mesh, lms, np.ones(n_landmarks, bool),
                                                           fp, fl, fz, fm)
    solve = dist_ba.make_dist_gauss_newton(model, dcfg, mesh)
    between = np.zeros((n_poses, 6), np.float32)
    between[1:, 0] = 10.0 / (n_poses - 1)
    bmask = np.ones(n_poses, bool)
    bmask[0] = False
    t = lambda x: torch.as_tensor(x, device=dev)
    args = (t(poses), n_poses, t(np.arange(n_poses) == 0), t(between), t(bmask), slms, slmask,
            fp, fl, fz, fm, t(np.eye(6, dtype=np.float32) * 1e2),
            t(np.diag([1 / 3.0, 1 / 3.0, 1 / 2e-4]).astype(np.float32)))
    _reset_peak(dev)
    out = solve(*args)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solve(*args)
    _sync(dev)
    seconds = (time.perf_counter() - t0) / (reps * iters)
    if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
        raise RuntimeError("the distributed BA produced non-finite estimates")
    return seconds, _peak(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=PARTICLES)
    ap.add_argument("--landmarks", type=int, default=LANDMARKS)
    ap.add_argument("--poses", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scaling", action="store_true",
                    help="with N > 1 ranks, also time one rank alone for the efficiency")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init", default=None, help="tcp://host:port of rank 0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.world > 1 and args.init is None:
        ap.error("--world > 1 needs --init")
    dev = multihost.initialize(args.init or f"localhost:{multihost.free_port()}", args.world, args.rank,
                               device=args.device)
    try:
        mesh = make_mesh(device=dev)
        base = {"world": mesh.size, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "card": card(dev)}

        def emit(line):
            if mesh.rank == 0:
                print(json.dumps({**line, **base}), flush=True)

        t_phd, mem = bench_phd(args.particles, mesh, steps=args.steps)
        emit({"metric": "sharded PHD step", "particles": args.particles, "step_s": t_phd,
              "fps": 1.0 / t_phd, "particle_updates_per_s": args.particles / t_phd,
              "peak_memory_bytes": mem})
        t_ba, mem = bench_ba(args.landmarks, dist_ba.make_landmark_mesh(device=dev),
                             n_poses=args.poses)
        emit({"metric": "distributed Schur BA", "landmarks": args.landmarks, "poses": args.poses,
              "gn_iter_s": t_ba, "peak_memory_bytes": mem})
        line = {"metric": "strong-scaling efficiency", "phd_efficiency": None, "ba_efficiency": None}
        if args.scaling and mesh.size > 1:
            solo = dist.new_group([0])
            if mesh.rank == 0:
                one = make_mesh(device=dev, group=solo)
                t_phd1, _ = bench_phd(args.particles, one, steps=args.steps)
                t_ba1, _ = bench_ba(args.landmarks, dist_ba.make_landmark_mesh(device=dev, group=solo),
                                    n_poses=args.poses)
                line.update(phd_efficiency=t_phd1 / (mesh.size * t_phd),
                            ba_efficiency=t_ba1 / (mesh.size * t_ba))
            dist.barrier()
        emit(line)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
