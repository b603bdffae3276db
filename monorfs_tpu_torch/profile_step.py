"""Where a frame's time goes on the GPU, at the bench configuration.

    python -m monorfs_tpu_torch.profile_step [--frames 50] [--trace PATH]
    python -m monorfs_tpu_torch.profile_step --sync-check [--frames 10]

Runs one warm-up chunk, then `--frames` frames under torch.profiler (CPU and
CUDA activity) and prints one JSON object: host wall time per frame, device
time per frame (kernels, copies and fills) and the device's idle share, the
stage ranges (vehicle, phd.*) with the host time spent in them and the
device time of the work they launched, per frame, the port's hand-written
kernels' device time and launches per frame, the device events with the
most time, and device events per frame. --trace also writes a Chrome
trace.

--sync-check instead runs the frames under
torch.cuda.set_sync_debug_mode("warn") and prints every call that made the
host wait for the device, with the file and line it came from; it exits
non-zero if one came from this package."""

import argparse
import json
import pathlib
import sys
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bench import BENCH_CONFIG, ROOT
from .bench_core import CHUNK, draw_chunk, run_frames, setup

STAGES = ("vehicle", "phd.predict", "phd.fused_stage", "phd.weight_inputs",
          "phd.beam_scan", "phd.normalise_resample")
KERNELS = {"beam_scan": "beam_scan", "fused_stage": "fused_stage_kernel"}  # name: substring
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--trace", type=pathlib.Path, default=None)
    ap.add_argument("--sync-check", action="store_true")
    args = ap.parse_args(argv)
    n = args.frames

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

    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    device_us = sum(e.time_range.elapsed_us() for e in on_device)
    stages = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in STAGES:
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
    print(json.dumps({
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
    }))


if __name__ == "__main__":
    main()
