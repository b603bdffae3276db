"""Where a frame's time goes on the GPU, at the bench configuration or on
the command-line path.

    python -m monorfs_tpu_torch.profile_step [--frames 50] [--trace PATH]
    python -m monorfs_tpu_torch.profile_step --sync-check [--frames 10]
    python -m monorfs_tpu_torch.profile_step --cli 3d|2d|2dloop|1d [--frames 50] [--particles 200]
        [--config experiments/configs/chap3-default.cfg]
    python -m monorfs_tpu_torch.profile_step --graph nav|scan|scan-da [--frames 20]
    python -m monorfs_tpu_torch.profile_step --loopy 2d|3d [--frames 40] [--sweeps 1]
    python -m monorfs_tpu_torch.profile_step --kinect [--frames 10]

Runs one warm-up chunk, then `--frames` frames under torch.profiler (CPU and
CUDA activity) and prints one JSON object: host wall time per frame, device
time per frame (kernels, copies and fills) and the device's idle share, the
stage ranges (spans.SPANS: vehicle, phd.* and the ranges nested in them) with
the host time spent in them and the device time of the work they launched,
per frame, the port's hand-written kernels' device time and launches per
frame, the device events with the most time, and device events per frame. --trace also writes a Chrome
trace.

--cli profiles the Simulation the command line builds for that asset world
(200 particles or --particles, float32, the default PHDConfig: K=600, beam
200 x 8, or the capacity of a --config cfg file) twice, with and without the
per-frame history (`_record`, which reads the best map and every pose to the
host), and prints both objects, each with the peak device memory of its
frames and its device-to-host reads a frame (Simulation.reads).

--graph profiles the graph backend on the 3D asset world: `nav` the
host-interactive navigator through Simulation -a isam2 (float64), frames
251 onward, where its buckets have reached their full size; `scan` and
`scan-da` the first frames of the scan runners at their 300-frame capacity
(float32), whose cost per frame does not depend on the frame. Stages:
graph.assoc (association; in scan-da it holds graph.auction), graph.hungarian,
graph.solve (Gauss-Newton), graph.marginals.

--loopy profiles the smoother at full width (the JAX LoopyConfig defaults,
float32) over the first `--frames` frames of a dead-reckoning run: the chap5
2D world (experiments/configs/chap5-default2d.cfg, linear2d.world, mov2d.in)
or the 3D asset world. It times `--sweeps` sweeps of LoopyPHDNavigator (the
first is the sequential refit; each is scored by the trajectory objective,
and the initial estimate too) and the map history, and prints per node:
stages loopy.refit.{seeds,grad,fan,map}, loopy.objective.{cavity,ll},
loopy.final_map and loopy.sweep.* (from the third sweep on), both kernels'
device time and launches, and the host synchronisations per node of a
refit over the first 10 nodes, with the lines that waited.

--kinect profiles the RGB-D input: the k9 run of experiments_kinect (the
real-pixel sequence assets/tum_real through FAST / LATCH / RANSAC, scripted
odometry, `-a phd` with 2000 particles in float32, the default PHDConfig:
the beam kernel on, the fused kernel off for the depth-occlusion model),
`--frames` frames after 4 warm-up frames, with the stages kinect.frontend
(extraction and the temporal filter on the device) and vehicle (the whole
source: subsampling, upload, the frontend, the one host read and the
measurement loop).

--sync-check instead runs the frames under
torch.cuda.set_sync_debug_mode("warn") and prints every call that made the
host wait for the device, with the file and line it came from; it exits
non-zero if one came from this package."""

import argparse
import collections
import json
import pathlib
import sys
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench import BENCH_CONFIG, ROOT
from .bench_core import CHUNK, draw_chunk, run_frames, setup
from .config import Config
from .io import World, parse_commands
from .sim.simulation import Simulation
from .spans import SPANS

CLI_WORLDS = {"3d": ("sim3d.world", "mov3d.in"), "2d": ("linear2d.world", "mov2d.in"),
              "2dloop": ("linear2dloop.world", "mov2dloop.in"), "1d": ("linear1d.world", "mov1d.in")}
GRAPH_WARM = 250  # navigator frames run before its profile starts
KERNELS = {"beam_scan": "beam_scan", "fused_stage": "fused_stage_kernel",
           "mixture_ll": "mixture_ll_kernel"}  # name: substring
PACKAGE = pathlib.Path(__file__).resolve().parent


def warm(frames, device="cuda"):
    """(runner, carry, commands, draws): the bench configuration after one
    warm-up chunk, with the next `frames` frames' commands and draws made."""
    runner, carry, cmds = setup(ROOT / "assets" / "sim3d.world", ROOT / "assets" / "mov3d.in",
                                BENCH_CONFIG.num_particles, CHUNK + frames,
                                phd_cfg=BENCH_CONFIG, device=device)
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(0)
    n_lm = carry.vstate.landmarks.shape[0]
    carry, _ = run_frames(runner, carry, cmds[:CHUNK],
                          draw_chunk(runner, gen, CHUNK, n_lm, torch.float32))
    draws = draw_chunk(runner, gen, frames, n_lm, torch.float32)
    torch.cuda.synchronize()
    return runner, carry, cmds[CHUNK:], draws


def host_syncs(frames=10, device="cuda"):
    """Every host synchronisation in `frames` frames of the main path after
    warm-up, as (file, line, message), in the order they happened."""
    runner, carry, cmds, draws = warm(frames, device)

    def syncs(seen):
        return [(w.filename, w.lineno, str(w.message).splitlines()[0]) for w in seen
                if "synchroniz" in str(w.message)]

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones((), device=runner.device).item()  # a known sync the check must see
            if not syncs(seen):
                raise RuntimeError("set_sync_debug_mode reported no synchronisation for .item()")
            seen.clear()
            run_frames(runner, carry, cmds, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return syncs(seen)


def in_package(filename):
    return pathlib.Path(filename).resolve().is_relative_to(PACKAGE)


def count_syncs(fn, frames):
    """How often a frame of fn() makes the host wait for the device, as
    torch.cuda.set_sync_debug_mode("warn") reports it: (per frame, the same
    by the file and line that waited, largest first)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = collections.Counter(f"{pathlib.Path(w.filename).name}:{w.lineno}"
                                for w in seen if "synchroniz" in str(w.message))
    return sum(where.values()) / frames, {k: n / frames for k, n in where.most_common(12)}


def summarise(prof, wall, n):
    """The profile of n frames that took `wall` seconds, as a dict."""
    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    stages = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            st = stages.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0})
            st["host_ms"] += e.cpu_time_total / 1e3 / n
            st["device_ms"] += e.device_time_total / 1e3 / n
    by_name = {}
    for e in on_device:
        key = e.name[:80]
        us, calls = by_name.get(key, (0.0, 0))
        by_name[key] = (us + e.time_range.elapsed_us(), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    kernels = {}
    for name, part in KERNELS.items():
        mine = [e for e in on_device if part in e.name]
        kernels[name] = {"device_ms_per_frame": sum(e.time_range.elapsed_us() for e in mine) / 1e3 / n,
                         "launches_per_frame": len(mine) / n}
    return {
        "device": torch.cuda.get_device_name(0),
        "frames": n,
        "wall_ms_per_frame": wall * 1e3 / n,
        "device_ms_per_frame": device_us / 1e3 / n,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "device_events_per_frame": len(on_device) / n,
        "stages": stages,
        "kernels": kernels,
        "top_kernels": [
            {"name": k, "device_ms_per_frame": us / 1e3 / n, "calls_per_frame": c / n}
            for k, (us, c) in top
        ],
    }


def profile_cli(which, n, collect_history, device="cuda", particles=200, config=None):
    """Profile n frames of the command line's Simulation on an asset world
    after CHUNK warm-up frames (`config`: a cfg file, as -g gives it)."""
    world_file, command_file = CLI_WORLDS[which]
    world = World.from_file(ROOT / "assets" / world_file)
    commands = parse_commands((ROOT / "assets" / command_file).read_text())
    commands = (commands * (1 + (CHUNK + n) // len(commands)))[: CHUNK + n]
    if config:
        cfg = Config.from_file(config)
    else:
        cfg = Config()
        cfg.set_model_defaults({1: "Linear1D", 2: "Linear2D", 7: "PRM3D"}[len(world.pose)])
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation(cfg, world, commands, particles=particles, dtype=np.float32,
                     collect_history=collect_history, device=device)
    for cmd in commands[:CHUNK]:
        sim.step(cmd)
    torch.cuda.synchronize()
    reads0 = sim.reads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cmd in commands[CHUNK:]:
            sim.step(cmd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarise(prof, wall, n)
    out.update(path="cli", world=world_file, collect_history=collect_history, config=config and str(config),
               reads_per_frame=(sim.reads - reads0) / n,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               shape=dict(P=particles, K0=sim.phd_cfg.max_components, M=sim.max_meas,
                          B=sim.phd_cfg.beam_width, C=sim.phd_cfg.beam_candidates))
    return out


def profile_graph(which, n, device="cuda"):
    """Profile n frames of the graph backend on the 3D asset world."""
    from . import bench_isam2
    from .slam.isam2_scan import build_isam2_scan_runner, scan_draws
    from .slam.isam2_scan_da import build_mahalanobis_scan

    world = World.from_file(ROOT / "assets" / "sim3d.world")
    if which == "nav":
        commands = parse_commands((ROOT / "assets" / "mov3d.in").read_text())
        sim = Simulation(Config(), world, commands, algorithm="isam2", particles=1,
                         dtype=np.float64, device=device)
        for cmd in commands[:GRAPH_WARM]:
            sim.step(cmd)
        todo = commands[GRAPH_WARM : GRAPH_WARM + n]
        n = len(todo)

        def run():
            for cmd in todo:
                sim.step(cmd)
    else:
        capacity = 300
        if which == "scan":
            cfg = Config()
            runner, carry, model = build_isam2_scan_runner(cfg, world, capacity, device=device)
        else:
            cfg = Config.from_file(ROOT / "experiments" / "configs" / "chap4-default.cfg")
            runner, carry, model = build_mahalanobis_scan(cfg, world, capacity, device=device)
        _, cmds = bench_isam2.world_and_commands(capacity, torch.float32, torch.device(device))
        draws = scan_draws(model, cfg, world, capacity, device=device)
        runner(carry, cmds[:2], draws)  # warm-up

        def run():
            runner(carry, cmds[:n], draws)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarise(prof, wall, n)
    out.update(path="graph", mode=which)
    return out


def loopy_navigator(which, n, device="cuda"):
    """The smoother's navigator at full width, float32, over the first n
    frames of a dead-reckoning run of the 2D chap5 or the 3D asset world
    (the chap5 grids smooth an odometry recording)."""
    from .slam.loopynav import LoopyPHDNavigator

    world_file, command_file = CLI_WORLDS[which]
    cfg = Config.from_file(ROOT / "experiments" / "configs" / "chap5-default2d.cfg") \
        if which == "2d" else Config()
    world = World.from_file(ROOT / "assets" / world_file)
    commands = parse_commands((ROOT / "assets" / command_file).read_text())[:n]
    sim = Simulation(cfg, world, commands, algorithm="odometry", dtype=np.float32, device=device).run()
    return LoopyPHDNavigator(
        sim.model, cfg, np.array([f["poses"][0] for f in sim.frames]),
        [o for _, o in sim.way_odometry], [zs for _, zs in sim.way_measurements],
        max_meas=sim.max_meas, dtype=torch.float32, device=device,
    )


def profile_loopy(which, n, sweeps, device="cuda"):
    """Profile `sweeps` sweeps and the map history of the smoother over n
    nodes; per-node figures."""
    from .slam import beam_kernel, fused_kernel

    nav = loopy_navigator(which, n, device)
    torch.cuda.synchronize()
    beam0, fused0 = beam_kernel.beam_scan_batch.launches, fused_kernel.fused_stage.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(sweeps):
            nav.sweep()
        nav.map_history()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarise(prof, wall, n)
    out.update(path="loopy", world=which, nodes=n, sweeps=sweeps, seconds=wall,
               shape=dict(K0=nav.lcfg.inner.max_components, M=nav.z.shape[1], J=nav.lcfg.jmap_cap,
                          B=nav.lcfg.beam_width, blocks=nav.lcfg.blocks, ga=[nav.lcfg.ga_iters,
                                                                             nav.lcfg.ga_steps]),
               counted_launches_per_node={
                   "beam_scan": (beam_kernel.beam_scan_batch.launches - beam0) / n,
                   "fused_stage": (fused_kernel.fused_stage.launches - fused0) / n})
    small = loopy_navigator(which, 10, device)
    out["syncs_per_node"], out["sync_sites_per_node"] = count_syncs(small.sweep, 10)
    return out


def profile_kinect(n=10, device="cuda"):
    """Profile n frames of the k9 `-a phd` run (2000 particles) after 4
    warm-up frames."""
    import tempfile

    from . import experiments_kinect as ek

    warmup = 4
    with tempfile.TemporaryDirectory() as tmp:
        npz, true_x, world = ek.sequence(pathlib.Path(tmp), warmup + n)
        src = ek.source(npz, device)
        commands = ek.k9_commands(true_x)
        sim = Simulation(ek.k9_cfg(), world, commands, algorithm="phd", particles=2000,
                         kinect_source=src, dtype=np.float32, device=device)
        for cmd in commands[:warmup]:
            sim.step(cmd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for cmd in commands[warmup:]:
                sim.step(cmd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    out = summarise(prof, wall, n)
    out.update(path="kinect", shape=dict(P=sim.particles, K0=sim.phd_cfg.max_components, M=sim.max_meas,
                                         B=sim.phd_cfg.beam_width, C=sim.phd_cfg.beam_candidates))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None, help="frames (nodes for --loopy; "
                    "default 40, else 50)")
    ap.add_argument("--trace", type=pathlib.Path, default=None)
    ap.add_argument("--sync-check", action="store_true")
    ap.add_argument("--cli", choices=sorted(CLI_WORLDS), default=None)
    ap.add_argument("--graph", choices=["nav", "scan", "scan-da"], default=None)
    ap.add_argument("--loopy", choices=["2d", "3d"], default=None)
    ap.add_argument("--sweeps", type=int, default=1, help="--loopy: smoother sweeps")
    ap.add_argument("--kinect", action="store_true")
    ap.add_argument("--particles", type=int, default=200, help="--cli: particles")
    ap.add_argument("--config", default=None, help="--cli: a cfg file, as -g gives it")
    args = ap.parse_args(argv)
    n = args.frames or 50

    if args.kinect:
        print(json.dumps(profile_kinect(args.frames or 10)), flush=True)
        return

    if args.loopy:
        print(json.dumps(profile_loopy(args.loopy, args.frames or 40, args.sweeps)), flush=True)
        return

    if args.graph:
        print(json.dumps(profile_graph(args.graph, n)), flush=True)
        return

    if args.cli:
        for collect_history in (True, False):
            print(json.dumps(profile_cli(args.cli, n, collect_history, particles=args.particles,
                                         config=args.config)), flush=True)
        return

    if args.sync_check:
        syncs = host_syncs(n)
        ours = [s for s in syncs if in_package(s[0])]
        print(json.dumps({"frames": n, "syncs": syncs, "from_package": len(ours)}))
        sys.exit(1 if ours else 0)

    runner, carry, cmds, draws = warm(n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames(runner, carry, cmds, draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(str(args.trace))

    print(json.dumps(summarise(prof, wall, n)))


if __name__ == "__main__":
    main()
