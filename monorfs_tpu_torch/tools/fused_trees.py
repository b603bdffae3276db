"""The fused kernel of several checkouts of the port, timed in turns on one card.

    python -m monorfs_tpu_torch.tools.fused_trees DIR [DIR ...] [--shape cli3d] [--rounds 3] [--reps 50]
        [--phases]

Each DIR is the root of a checkout (a `git archive` of a commit, say); its
monorfs_tpu_torch is imported as its own package and builds its kernels
into its own tree. Every tree's fused_stage runs on the same warm state
(kernel_cases.fused_state) at one of SHAPES, as chip_smoke.py builds it:
cli3d is the command line's 3D shape (PRM3D, 200 particles, K0 = 600, 48
measurement slots, the default PHDConfig, seed 23, 40 landmarks: the
prm3d-K600-M48 case), grid800 chap3-default.cfg's capacity at 800
particles, bench the bench config, scaling bench_scaling's at 10,000
particles, smoother2d / smoother3d a smoother node's 8 passes with one mask
each, smoother2d-p1 / smoother3d-p1 its single pass. Each round times every
tree, then every tree again in reverse order (A B, B A), each the mean
device time of the kernel's launches (torch.profiler's CUDA kernel events,
as chip_smoke.py reads them) over --reps back-to-back calls after a
warm-up. Prints the card's `nvidia-smi` name and power limit, then one JSON
line a round and one with each tree's mean, whether the trees' outputs are
equal bit for bit and, with --phases, each tree's phase split (median and
largest cycles a block of one launch with the phase clock)."""

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernel_cases import fused_state

# name -> (model, P, K0, M, seed, landmarks, PHDConfig fields beyond P and
# K0, masks: one per particle as the smoother's passes take them)
SHAPES = {
    "cli3d": ("PRM3D", 200, 600, 48, 23, 40, {}, False),
    "grid800": ("PRM3D", 800, 500, 48, 49, 40, dict(max_measurements=48), False),
    "bench": ("PRM3D", 200, 128, 24, 0, 40, "bench", False),
    "scaling": ("PRM3D", 10000, 128, 48, 51, 40, "scaling", False),
    "smoother2d": ("Linear2D", 8, 128, 33, 27, 25, dict(max_measurements=33, gate_top=8), True),
    "smoother3d": ("PRM3D", 8, 128, 48, 29, 40, dict(max_measurements=48, gate_top=8), True),
    "smoother2d-p1": ("Linear2D", 1, 128, 33, 27, 25, dict(max_measurements=33, gate_top=8), False),
    "smoother3d-p1": ("PRM3D", 1, 128, 48, 29, 40, dict(max_measurements=48, gate_top=8), False),
}
KERNEL = "fused_stage_kernel"  # substring of the kernel's name in every tree


def pass_masks(z_mask, passes):
    """chip_smoke.py's masks of a smoother node's passes."""
    iota = torch.arange(z_mask.shape[0], device=z_mask.device)
    rows = z_mask[None, :] & (iota[None, :] % passes != torch.arange(passes, device=z_mask.device)[:, None])
    rows[0] = False
    return rows


def load_tree(root, name):
    """The port of the checkout at `root`, imported as package `name`."""
    pkg = pathlib.Path(root).resolve() / "monorfs_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, reps):
    """Mean device milliseconds of the fused kernel's launches over reps
    calls of fn (the wrapper's host work and other kernels left out)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and KERNEL in e.name]
    if not 1 <= len(events) <= reps:
        raise RuntimeError(f"{len(events)} {KERNEL} kernel events for {reps} calls")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(events)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="cli3d")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_trees: a GPU is required")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    mname, p, k0, m, seed, n_lm, fields, per_pass = SHAPES[args.shape]
    runs, splits = [], {}
    for i, root in enumerate(args.trees):
        name = f"fused_tree{i}"
        load_tree(root, name)
        importlib.import_module(f"{name}._build").build_library()
        fk = importlib.import_module(f"{name}.slam.fused_kernel")
        phd = importlib.import_module(f"{name}.slam.phd")
        mixture = importlib.import_module(f"{name}.gm.mixture")
        models = importlib.import_module(f"{name}.models")
        config = importlib.import_module(f"{name}.config")
        c = config.Config()
        c.set_model_defaults(mname)
        params = c.phd_params(torch.float32, dev)
        if fields == "bench":
            pcfg = importlib.import_module(f"{name}.bench").BENCH_CONFIG
        elif fields == "scaling":
            pcfg = importlib.import_module(f"{name}.bench_scaling").scaling_config(p)
        else:
            pcfg = phd.PHDConfig(num_particles=p, max_components=k0, **fields)
        pose, leaves, z, z_mask = fused_state(seed, p, k0, m, n_lm, model=mname)
        t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        pose, z_mask = t(pose), torch.tensor(z_mask, device=dev)
        if per_pass:  # every pass at one pose, as the smoother snaps them
            pose, z_mask = pose[:1].expand(p, -1).contiguous(), pass_masks(z_mask, p)
        fargs = (models.get(mname), pcfg, params, pose, mixture.SGM(*[t(x) for x in leaves]), t(z), z_mask)
        runs.append((str(root), lambda fk=fk, fargs=fargs: fk.fused_stage(*fargs)))
        if args.phases:
            names = fk.PHASES
            clk = torch.zeros((p, len(names) + 1), dtype=torch.int64, device=dev)
            fk.fused_stage(*fargs, phase_clock=clk)
            d = torch.diff(clk, dim=1).cpu().numpy()
            splits[str(root)] = {nm: [float(np.median(d[:, j])), int(d[:, j].max())]
                                 for j, nm in enumerate(names)}
            splits[str(root)]["total"] = [float(np.median(d.sum(1))), int(d.sum(1).max())]
    outs = [torch.cat([torch.stack(list(s)).flatten() for s in fn()]) for _, fn in runs]
    torch.cuda.synchronize()
    times = {root: [] for root, _ in runs}
    for r in range(args.rounds):
        order = runs if r % 2 == 0 else runs[::-1]
        for root, fn in order + order[::-1]:
            times[root].append(device_ms(fn, args.reps))
        print(json.dumps({"round": r, "ms": {k: v[-2:] for k, v in times.items()}}), flush=True)
    print(json.dumps({"shape": dict(name=args.shape, model=mname, P=p, K0=k0, M=m, seed=seed, landmarks=n_lm),
                      "device": torch.cuda.get_device_name(0), "reps": args.reps,
                      "mean_ms": {k: sum(v) / len(v) for k, v in times.items()},
                      "runs_ms": times,
                      "outputs_equal": all(torch.equal(outs[0], o) for o in outs[1:]),
                      "cycles_median_max": splits or None}), flush=True)


if __name__ == "__main__":
    main()
