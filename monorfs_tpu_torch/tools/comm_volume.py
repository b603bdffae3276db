"""The collectives of every sharded path, with their bytes (the counterpart
of the repository's tools/comm_volume.py).

    python -m monorfs_tpu_torch.tools.comm_volume [--ranks 8] [--device cuda|cpu]

Starts --ranks processes, NCCL ranks one a card with --device cuda (the
default; it raises without a GPU, and where --ranks exceeds the cards) or
gloo ranks on this host's CPU with --device cpu, and runs in each (a) one
particle-sharded PHD step at the bench shapes (PRM3D, 200 particles, K=128,
24 measurement slots, float32), (b) one chain-sharded smoother sweep (a
64-node Linear2D chain, one cavity block a rank, float32) and (c) one
Gauss-Newton iteration of the landmark-sharded Schur BA (10240 landmarks x
64 poses, 40960 factors, float32): the shapes the JAX tool compiles. It
reads the counter of parallel/collectives.py over each and prints, per
path, every op with its calls and the bytes of its results on rank 0, beside
the JAX tool's figures for the same shapes on an 8-device mesh (BENCH.md,
"Sharded-path communication volume", read off the optimised HLO). The
counts are of what the code issues, not a time: no device is involved.
"""

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from .. import resolve_device
from ..parallel import make_mesh, multihost

# BENCH.md's table of tools/comm_volume.py (8 devices)
JAX_FIGURES = {
    "phd": "21 all-gather + 5 all-reduce + 1 ppermute, 5.45 MiB",
    "chain": "11 ppermute + 8 all-gather, 11.8 KiB",
    "ba": "1 all-reduce, 577.5 KiB",
}


def _phd(mesh):
    dev = mesh.device
    from ..config import Config
    from ..models import get as get_model
    from ..parallel import make_sharded_step, shard_state
    from ..slam import phd

    model = get_model("PRM3D")
    pcfg = phd.PHDConfig(num_particles=200, max_components=128, max_measurements=24, gate_top=8,
                         estimate_cap=48, beam_width=32, beam_meas_cap=24, beam_candidates=6,
                         merge_rounds=4)
    params = Config().phd_params(torch.float32, dev)
    state = shard_state(phd.init_state(model, pcfg, np.array([0, 0, 0, 1, 0, 0, 0.0]),
                                       torch.float32, dev), mesh)
    z = torch.zeros((24, 3))
    z[:, 2] = 1.0
    step = make_sharded_step(model, pcfg, mesh)
    gen = torch.Generator().manual_seed(0)
    draws = torch.randn((200, 6), generator=gen), torch.rand((), generator=gen)
    step(params, state, torch.zeros(6, device=dev), z.to(dev), torch.arange(24, device=dev) < 12,
         *(d.to(dev) for d in draws))


def _chain(mesh):
    from ..config import Config
    from ..models import get as get_model
    from ..parallel import chain
    from ..slam import loopy

    dev = mesh.device
    cfg = Config()
    cfg.set_linear2d_defaults()
    model, t = get_model("Linear2D"), 64
    lcfg = loopy.LoopyConfig(max_nodes=t, max_meas=8, mix_cap=4, blocks=mesh.size, ga_iters=4,
                             ga_steps=2, jmap_cap=16, beam_width=16)
    traj = np.cumsum(np.full((t, 2), 0.1), axis=0)
    state = loopy.init_state(model, lcfg, traj, t, torch.float32, dev)
    z = torch.zeros((t, 8, 2))
    z[:, 0] = 0.5
    zm = torch.zeros((t, 8), dtype=torch.bool)
    zm[:, 0] = True
    state, odo, z, zm = chain.shard_loopy_inputs(mesh, state, torch.full((t, 2), 0.1), z, zm)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    chain.make_sharded_sweep(model, lcfg, mesh)(
        cfg.phd_params(torch.float32, dev), state, odo, z, zm, f32(5.0), f32(1.0), f32(0.1),
        torch.eye(2, device=dev) * 1e-3)


def _ba(mesh):
    from ..models import get as get_model
    from ..parallel import dist_ba

    n = mesh.size
    l_cap, p_cap, f_cap = 10240, 64, 40960
    dcfg = dist_ba.DistBAConfig(max_poses=p_cap, max_landmarks=l_cap, max_factors=f_cap, gn_iters=1)
    rng = np.random.default_rng(0)
    poses = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32), (p_cap, 1))
    lms = rng.uniform(-1, 1, (l_cap, 3)).astype(np.float32)
    lms[:, 2] = rng.uniform(0.5, 1.8, l_cap)
    fl = np.arange(f_cap, dtype=np.int32) % l_cap
    fp = (fl + (np.arange(f_cap, dtype=np.int32) // l_cap) * 17) % p_cap
    parts = dist_ba.partition_factors(dcfg, n, fp, fl, np.zeros((f_cap, 3), np.float32),
                                      np.ones(f_cap, bool))
    lms_l, lmask, fp, fl, fz, fm = dist_ba.shard_ba_inputs(mesh, lms, np.ones(l_cap, bool), *parts)
    dev = mesh.device
    between_mask = torch.ones(p_cap, dtype=torch.bool, device=dev)
    between_mask[0] = False
    dist_ba.make_dist_gauss_newton(get_model("PRM3D"), dcfg, mesh)(
        torch.tensor(poses, device=dev), p_cap - 1, torch.arange(p_cap, device=dev) == 0,
        torch.zeros((p_cap, 6), device=dev), between_mask, lms_l, lmask, fp, fl, fz, fm,
        torch.eye(6, device=dev) * 1e2, torch.diag(torch.tensor([0.5, 0.5, 1e3], device=dev)))


PATHS = {"phd": ("PHD step, 200 particles (bench shapes)", _phd),
         "chain": ("Loopy sweep, 64-node chain, one block a rank", _chain),
         "ba": ("Schur BA, 10240 landmarks x 64 poses (1 GN iteration)", _ba)}


def rank_main(world, rank, init, device):
    """One rank: every path once; rank 0 prints {path: {op: [calls, bytes]}}."""
    torch.set_num_threads(1)
    dev = multihost.initialize(init, world, rank, device=device)
    try:
        mesh = make_mesh(device=dev)
        counts = {}
        for name, (_, run) in PATHS.items():
            mesh.comm = {}
            run(mesh)
            counts[name] = mesh.comm
        if rank == 0:
            print(json.dumps(counts), flush=True)
    finally:
        multihost.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL ranks, one a card; cpu: gloo ranks on this host")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.ranks, args.rank, args.init, args.device)
        return 0
    if resolve_device(args.device).type == "cuda" and args.ranks > torch.cuda.device_count():
        raise ValueError(f"{args.ranks} NCCL ranks need as many cards; "
                         f"{torch.cuda.device_count()} are visible")
    init = f"tcp://localhost:{multihost.free_port()}"
    cmd = [sys.executable, "-m", "monorfs_tpu_torch.tools.comm_volume", "--ranks", str(args.ranks),
           "--device", args.device, "--init", init, "--rank"]
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(args.ranks)]
    try:
        outs = [p.communicate(timeout=1200) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"a rank failed:\n{err[-3000:]}")
    counts = json.loads(outs[0][0].strip().splitlines()[-1])
    where = "NCCL ranks, one a card" if args.device == "cuda" else "gloo ranks on the CPU"
    print(f"{args.ranks} {where} (rank 0's results)")
    for name, (title, _) in PATHS.items():
        total = sum(b for _, b in counts[name].values())
        print(f"\n== {title} ==")
        for op, (calls, nbytes) in sorted(counts[name].items()):
            print(f"  {op:12s} x{calls:3d}  {nbytes / 1024:10.1f} KiB")
        print(f"  {'TOTAL':12s}       {total / 1024:10.1f} KiB   (JAX, 8 devices: {JAX_FIGURES[name]})")
    print(json.dumps({"ranks": args.ranks, "device": args.device, "counts": counts}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
