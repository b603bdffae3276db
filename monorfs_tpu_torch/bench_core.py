"""Benchmark core: the vehicle-plus-navigator frame loop on the device (the
torch twin of monorfs_tpu.bench_core, reference: mono-rfs/Program.cs:286-294,
Simulation.cs:706-723).

Frames run in chunks of 50 as in the JAX package; each chunk's random draws
are made in bulk on the device from one torch.Generator seeded with `seed`,
and nothing is fetched to the host until the run ends."""

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from . import resolve_device
from .config import Config
from .io.world import World, parse_commands
from .sim import vehicle as vehicle_mod
from .sim.simulation import draw_frames, model_for_config
from .slam import phd

CHUNK = 50


class Runner(NamedTuple):
    model: object
    cfg: phd.PHDConfig
    vparams: vehicle_mod.VehicleParams
    nparams: phd.PHDParams
    step: object
    max_clutter: int
    device: torch.device


class Carry(NamedTuple):
    vstate: vehicle_mod.VehicleState
    nstate: phd.PHDState


def build_runner(cfg: Config, world: World, particles: int, phd_cfg=None,
                 dtype=torch.float32, max_clutter=8, device="cuda"):
    """Return (runner, initial carry)."""
    dev = resolve_device(device)
    model = model_for_config(cfg, world)
    lmax = max(len(world.landmarks), 1)
    pcfg = phd_cfg or phd.PHDConfig(
        num_particles=particles,
        max_components=cfg.max_quantity,
        max_measurements=lmax + max_clutter,
    )
    lm = np.zeros((lmax, 3))
    lm[: len(world.landmarks)] = world.landmarks
    vstate = vehicle_mod.VehicleState(
        pose=torch.as_tensor(world.pose, dtype=dtype, device=dev),
        landmarks=torch.as_tensor(lm, dtype=dtype, device=dev),
        landmark_mask=torch.as_tensor(np.arange(lmax) < len(world.landmarks), device=dev),
    )
    runner = Runner(
        model=model,
        cfg=pcfg,
        vparams=vehicle_mod.make_params(model, cfg, dtype, dev),
        nparams=cfg.phd_params(dtype, dev),
        step=phd.make_slam_step(model, pcfg),
        max_clutter=max_clutter,
        device=dev,
    )
    nstate = phd.init_state(model, pcfg, world.pose, dtype, dev)
    return runner, Carry(vstate, nstate)


def draw_chunk(runner: Runner, gen, n, landmarks, dtype):
    """Every random draw of n frames, made in bulk on the device."""
    return draw_frames(
        gen, n, landmarks, runner.model.meas_dim, runner.model.pose.odo_dim,
        runner.cfg.num_particles, runner.max_clutter, runner.vparams.clutter_count,
        dtype, runner.device,
    )


def run_frames(runner: Runner, carry: Carry, commands, draws):
    """Run len(commands) frames; returns (carry, (true pose, best particle
    pose, best log-weight) stacked over frames, on the device)."""
    model = runner.model
    outs = []
    for f in range(commands.shape[0]):
        with record_function("vehicle"):
            vstate, noisy = vehicle_mod.update(
                model, runner.vparams, carry.vstate, commands[f], draws["odo_normals"][f]
            )
            z, mask, _, _, _ = vehicle_mod.measure(
                model, runner.vparams, vstate, draws["detect_u"][f], draws["meas_normals"][f],
                draws["clutter_draw"][f], draws["clutter_u"][f], runner.max_clutter,
            )
        nstate = runner.step(
            runner.nparams, carry.nstate, noisy, z, mask,
            draws["motion_normals"][f], draws["resample_u"][f],
        )
        best = nstate.best.reshape(1)
        outs.append((
            vstate.pose,
            torch.index_select(nstate.pose, 0, best)[0],
            torch.index_select(nstate.logweight, 0, best)[0],
        ))
        carry = Carry(vstate, nstate)
    return carry, tuple(torch.stack(o) for o in zip(*outs))


def setup(world_file, command_file, particles=200, frames=None, dtype=torch.float32,
          cfg=None, phd_cfg=None, device="cuda"):
    """(runner, initial carry, commands [F, T] on the device) of a run over
    world_file, the command file repeated or cut to `frames`."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = Config()  # PRM3D defaults
    world = World.from_file(world_file)
    with open(command_file) as f:
        commands = parse_commands(f.read())
    odo = 6 if len(world.pose) == 7 else len(world.pose)
    cmds = np.stack([c[:odo] for c in commands])
    if frames is not None:
        reps = int(np.ceil(frames / len(cmds)))
        cmds = np.tile(cmds, (reps, 1))[:frames]
    runner, carry0 = build_runner(cfg, world, particles, phd_cfg=phd_cfg, dtype=dtype, device=dev)
    return runner, carry0, torch.as_tensor(cmds, dtype=dtype, device=dev)


def run_benchmark(world_file, command_file, particles=200, frames=None,
                  dtype=torch.float32, cfg=None, phd_cfg=None, seed=0, device="cuda"):
    """Warm up with one full run, then time a second identical run (outputs
    fetched to the host inside the timed region); returns a dict of
    results."""
    runner, carry0, cmds = setup(world_file, command_file, particles, frames, dtype, cfg,
                                 phd_cfg, device)
    dev = runner.device
    chunk = min(CHUNK, cmds.shape[0])
    n_chunks = cmds.shape[0] // chunk
    cmds = cmds[: n_chunks * chunk]
    n_lm = carry0.vstate.landmarks.shape[0]

    def run_all():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        carry, outs = carry0, []
        for i in range(n_chunks):
            draws = draw_chunk(runner, gen, chunk, n_lm, dtype)
            carry, out = run_frames(runner, carry, cmds[i * chunk : (i + 1) * chunk], draws)
            outs.append(out)
        return [torch.cat([o[j] for o in outs]).cpu().numpy() for j in range(3)]

    t0 = time.perf_counter()
    run_all()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    true_pose, est_pose, _ = run_all()
    elapsed = time.perf_counter() - t0

    n = cmds.shape[0]
    d = min(3, true_pose.shape[1])
    ate = float(np.sqrt(np.mean(np.sum((true_pose[:, :d] - est_pose[:, :d]) ** 2, -1))))
    return {
        "frames": int(n),
        "particles": particles,
        "elapsed_s": elapsed,
        "fps": n / elapsed,
        "warmup_s": warmup_s,
        "ate_rmse_loc": ate,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
