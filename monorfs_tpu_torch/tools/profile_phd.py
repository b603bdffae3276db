"""Per-stage timing of the PHD SLAM step at the headline bench shapes (the
counterpart of tools/profile_phd.py).

    python -m monorfs_tpu_torch.tools.profile_phd [--particles 200] [--warm 100] [--reps 20]
        [--device cpu]

Times each SoA stage -- births, correct + prune (the XLA-semantics
functions), the fused kernel (births + correct + prune in one launch), the
weight stage (weight inputs, the beam kernel and the log-sum-exp) -- over a
state warmed by `--warm` frames of the 3D asset world, and the full step, by
CUDA events around `--reps` calls after one warm-up call (on the CPU, by the
host clock). Prints one JSON object: the card, the shape, the mean alive
components a particle and milliseconds a call per stage."""

import argparse
import json
import time

import torch

from .. import resolve_device
from ..bench import ROOT
from ..bench_core import CHUNK, draw_chunk, run_frames, setup
from ..bench_isam2 import card
from ..gm import mixture
from ..slam import association, beam_kernel, fused_kernel, phd


def profile_config(particles):
    """tools/profile_phd.py:47-50 and tools/ablate.py:37-40."""
    return phd.PHDConfig(
        num_particles=particles, max_components=128, max_measurements=48, gate_top=8,
        estimate_cap=64, beam_width=64, beam_meas_cap=24, merge_rounds=4,
    )


def warm_state(pcfg, frames, device):
    """(runner, carry) after `frames` frames of the 3D asset world at pcfg."""
    runner, carry, cmds = setup(ROOT / "assets" / "sim3d.world", ROOT / "assets" / "mov3d.in",
                                pcfg.num_particles, frames, phd_cfg=pcfg, device=device)
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(0)
    n_lm = carry.vstate.landmarks.shape[0]
    for i in range(0, frames, CHUNK):
        c = cmds[i : i + CHUNK]
        carry, _ = run_frames(runner, carry, c, draw_chunk(runner, gen, c.shape[0], n_lm, torch.float32))
    return runner, carry


def random_measurements(m, live, dtype, device, seed=7):
    """z [m, 3] uniform over the world's box and the first `live` slots live."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z = torch.rand((m, 3), generator=gen, dtype=dtype, device=device)
    z = z * torch.tensor([100.0, 100.0, 1.5], dtype=dtype, device=device) - torch.tensor(
        [50.0, 50.0, -0.2], dtype=dtype, device=device)
    return z, torch.arange(m, device=device) < live


def step_inputs(runner, dtype, seed=11):
    """(odometry, motion normals [P, T], resample u) for a full step."""
    dev = runner.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p, t = runner.cfg.num_particles, runner.model.pose.odo_dim
    return (torch.zeros((t,), dtype=dtype, device=dev),
            torch.randn((p, t), generator=gen, dtype=dtype, device=dev),
            torch.rand((), generator=gen, dtype=dtype, device=dev))


def call_ms(fn, reps, device):
    """Milliseconds a call of fn over reps calls after a warm-up call: CUDA
    events on a GPU, the host clock on the CPU; returns (ms, timer)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps, "host clock (cpu)"
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps, "cuda events"


def stages(runner, carry, z, z_mask):
    """{name: () -> output} of the step's stages on a warm state, and the
    full step."""
    model, pcfg, params = runner.model, runner.cfg, runner.nparams
    state = carry.nstate
    pose, maps = state.pose, state.maps
    zl = [z[:, i] for i in range(model.meas_dim)]
    predicted = mixture.concat_soa(maps, phd._births_soa(model, params, pose, maps, zl, z_mask))
    corrected = phd._correct_prune_soa(model, pcfg, params, pose, predicted, zl, z_mask)
    n_words = (pcfg.estimate_cap + 31) // 32

    def weight():
        rest, base, od, wk, bk = phd.weight_inputs(model, pcfg, params, pose, predicted, corrected, z, z_mask)
        scores = beam_kernel.beam_scan_batch(base, od, wk, bk, pcfg.beam_width, n_words)
        return association.logsumexp_scores(scores) + rest

    step = phd.make_slam_step(model, pcfg, slam=True)
    odo, normals, u = step_inputs(runner, z.dtype)
    return {
        "births": lambda: phd._births_soa(model, params, pose, maps, zl, z_mask),
        "correct+prune": lambda: phd._correct_prune_soa(model, pcfg, params, pose, predicted, zl, z_mask),
        "fused kernel": lambda: fused_kernel.fused_stage(model, pcfg, params, pose, maps, z, z_mask),
        "weight": weight,
        "full": lambda: step(params, state, odo, z, z_mask, normals, u),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-profile-phd")
    ap.add_argument("--particles", type=int, default=200)
    ap.add_argument("--warm", type=int, default=100, help="frames run before the stages are timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pcfg = profile_config(args.particles)
    runner, carry = warm_state(pcfg, args.warm, dev)
    z, z_mask = random_measurements(pcfg.max_measurements, 40, torch.float32, dev)
    ms, timer = {}, None
    for name, fn in stages(runner, carry, z, z_mask).items():
        ms[name], timer = call_ms(fn, args.reps, dev)
    out = {
        "tool": "profile_phd", "device": str(dev), "card": card(dev), "timer": timer,
        "shape": dict(P=pcfg.num_particles, K=pcfg.max_components, M=pcfg.max_measurements,
                      B=pcfg.beam_width, C=pcfg.beam_candidates, beam_steps=pcfg.beam_meas_cap),
        "alive_components": float(mixture.count(carry.nstate.maps).float().mean()),
        "stages_ms": ms,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
