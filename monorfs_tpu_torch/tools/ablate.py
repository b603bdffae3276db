"""In-situ ablation of the SoA PHD step (the counterpart of tools/ablate.py):
take stages out of make_slam_step and time the real step on a warm state.

    python -m monorfs_tpu_torch.tools.ablate [--particles 200] [--reps 50] [--device cpu]
    python -m monorfs_tpu_torch.tools.ablate --round4     # the resample-cadence ablation

The JAX tool patches the phd module's stage functions; here the step is
built with the replacement stages passed in (make_slam_step(stages=...)).
Variants: the full step; no weight stage (a constant increment); no
correct (births only, the predicted map cut to K); births only; the full
step with merge_rounds=0; a 32 x 12 beam. --round4 times the bench
PHDConfig with the ESS resampling never and always firing (its linear-space
weight evaluation variant patches a mixture function the port does not
expose, and is not ported). Prints one JSON line per variant: milliseconds
a step by CUDA events (the host clock on the CPU) and frames/s."""

import argparse
import dataclasses
import json

import torch

from .. import resolve_device
from ..bench_isam2 import card
from ..gm import mixture
from ..slam import phd
from .profile_phd import call_ms, profile_config, step_inputs, warm_state
from .roofline_phd import roofline_config


def no_weight(pose, predicted, corrected, z, z_mask):
    """A constant log-weight increment that still reads the corrected map
    (tools/ablate.py:69-72)."""
    return corrected.logw.sum(-1) * 0.0 + pose[:, 0] * 1e-12


def births_only(model, params, k):
    """Births and the predicted map cut to k components: no correction,
    prune or merge (tools/ablate.py:76-77)."""

    def correct(pose, maps, z, z_mask):
        zl = [z[:, i] for i in range(model.meas_dim)]
        predicted = mixture.concat_soa(maps, phd._births_soa(model, params, pose, maps, zl, z_mask))
        return predicted, mixture.map_soa(lambda a: a[..., :k], predicted)

    return correct


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-ablate")
    ap.add_argument("--particles", type=int, default=200)
    ap.add_argument("--warm", type=int, default=100, help="frames run before the step is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--round4", action="store_true", help="the resample-cadence ablation")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pcfg = (roofline_config if args.round4 else profile_config)(args.particles)
    runner, carry = warm_state(pcfg, args.warm, dev)
    model, params, state = runner.model, runner.nparams, carry.nstate
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    m = pcfg.max_measurements
    z = torch.rand((m, 3), generator=gen, device=dev)
    z_mask = torch.arange(m, device=dev) < 40
    odo, normals, u = step_inputs(runner, torch.float32)
    rows = []

    def run(label, cfg=pcfg, params_=params, **kw):
        step = phd.make_slam_step(model, cfg, slam=True, **kw)
        ms, timer = call_ms(lambda: step(params_, state, odo, z, z_mask, normals, u), args.reps, dev)
        row = {"variant": label, "ms": ms, "fps": 1e3 / ms, "timer": timer, "particles": args.particles,
               "device": str(dev), "card": card(dev)}
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.round4:
        dt = params.min_effective_particle.dtype
        run("full (current)")
        run("resample never (ESS thr 0)",
            params_=params._replace(min_effective_particle=torch.tensor(0.0, dtype=dt, device=dev)))
        run("resample always (ESS thr 1)",
            params_=params._replace(min_effective_particle=torch.tensor(1.0, dtype=dt, device=dev)))
        run("full (repeat)")
        return rows

    correct = births_only(model, params, pcfg.max_components)
    run("full")
    run("no weight", stages={"weight": no_weight})
    run("no correct (weight+births)", stages={"correct": correct})
    run("births only", stages={"correct": correct, "weight": no_weight})
    run("no weight (again)", stages={"weight": no_weight})
    run("merge_rounds=0", cfg=dataclasses.replace(pcfg, merge_rounds=0))
    run("beam 32x12", cfg=dataclasses.replace(pcfg, beam_width=32, beam_meas_cap=12))
    return rows


if __name__ == "__main__":
    main()
