#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (monorfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR] [--phases kernels,bench,sync,vehicle,cli,graph,loopy,kinect,grid,parallel,view]

Phases, one line each; any failure exits non-zero:
  1. device, `nvidia-smi` name and power limit, kernel build (nvcc, sm_90a);
     the Python copies of csrc/'s shape decisions (fused_kernel.layout_bytes
     and workspace_floats, beam_kernel.layout_bytes, mixture_kernel.layout_bytes,
     assoc_kernel.launch_shape) against the built C functions over a grid of
     shapes (`layout-check`);
  2. beam kernel vs its plain version, bit-identical: at the bench shape, on
     tie-heavy inputs, at B=64 C=8 n_words=3, at the default PHDConfig's
     B=200 C=8 n_words=4, tie-heavy at B=200 C=8 over 48 steps and at the
     smoother's B=32 C=8 with one word; then the `beam-block` line: at each
     shape the block design serves (BLOCK_SHAPES), the kernel's time, the
     parent's under --parent, the plain scan's CUDA-graph replay and the
     bound; then `beam-wide`: at B=1000 C=8 (past the 256-thread block's
     8,192 candidates: the 1024-thread block) the kernel bit-identical to
     the plain scan on random and tie-heavy options and timed, the wrapper
     raising at the first shapes no design takes, and 5 float32 SLAM steps
     at that width (8 particles) with both kernels once a frame;
  3. fused kernel vs its plain version on warm random states at the bench
     shape, a cap-binds state, a merge-ties state and a second shape:
     predicted rtol/atol 2e-5, corrected component sets to the tolerances
     of tests/test_fused_pallas.py; its per-phase clock split; then, to the
     same tolerances and each with its device time (in turns with the
     parent where the parent launches the shape), plain time, bound and
     phase split (the parent's too), Linear2D and Linear1D states at the
     bench shape and the command line's capacity (K0=600): PRM3D M=48 with
     the cap loose and binding, Linear2D M=33, Linear1D M=20; PRM3D at
     K0=600 M=180, K0=663 M=48 and K0=1000 M=64; and the flagship's shape
     (FLAGSHIP_FUSED: 100,000 particles, K0=128, M=48, the cap binding),
     held to the plain version a chunk of particles at a time and not
     timed in plain; then the mixture likelihood
     kernel (`mixture-check`, `mixture-shape`) against mixture_rest_plain
     to MIXTURE_RTOL of each particle's scale: on the edge cases of
     kernel_cases.MIXTURE_EDGES (no live slot, no valid row, singular
     covariances, K not a multiple of 32, more live components than a tile,
     E=1, garbage in dead slots), at chap3's shape with strided and
     contiguous MAP means (equal) and twice (equal), the wrapper
     raising on float64; then at MIXTURE_SHAPES (chap3 at 2000 and 800
     particles, the command line's K0=600, the bench's K0=128 at 200 and
     100,000 particles) with its device time, wall time, plain time and
     bound; then the association kernel (`assoc-check`, `assoc-shape`)
     against assoc_options_plain, opt_delta, word_k and bit_k bit for bit
     and base within E * 2^-23 of its size: on kernel_cases.ASSOC_CASES
     (the bench, chap3 and flagship shapes, Linear2D / Linear1D, ties, no
     gated pair, no valid MAP row, every slot dead, C past 8, E below C),
     with strided and contiguous MAP means and a caller's packed vector
     (equal), the wrapper raising on float64; then at ASSOC_SHAPES (chap3
     at 2000 and 800 particles, the flagship's 100,000, the bench, the
     command line's 3D, 2D and 1D) with its device time, wall time, plain
     time and bound;
  4. the bench path: run_benchmark at the bench.py config (200 particles,
     K=128, 48 -> 24 measurement slots, beam 32 x 6, 300 frames), with the
     four kernels launched once per frame and ATE below 0.03;
  5. no host synchronisation: 10 frames of the bench path after warm-up under
     torch.cuda.set_sync_debug_mode("warn"), none from the port's code;
  6. the command-line path at full width, through cli.main and then
     postanalysis.main on each recording: the 3D, 2D and 1D asset worlds with
     200 particles and the default PHDConfig (K=600, beam 200 x 8) over their
     whole command files, mapping-only on the 3D world, float64 on the 2D
     world (30 frames), a 3D world of 180 landmarks (sim3d.world's 40 and
     seeded ones in their bounding box, written to the temporary
     directory: 188 measurement slots, cut to CLI180_FRAMES frames, held to
     the 3D run's limits), and the 3D recording replayed through dead
     reckoning. The fused kernel must launch once per float32 frame, the
     beam kernel once per float32 SLAM frame (none in mapping-only, float64
     and odometry), every ATE / OSPA must be finite and under its limit, and
     the replayed trajectory must equal the recorded odometry integrated.
  7. `graph`: the graph backend at full width (3D asset world, 40
     landmarks, 300 frames: 302 poses, 160 landmark slots, 48 measurement
     slots, 14,496 factor slots in the host navigator). `cli.main -a isam2`
     then postanalysis, under its limits; `-i record -a isam2` over phase
     6's PHD recording (its own recording when phase 6 did not run); the
     3D command again twice over its first REPEAT_FRAMES frames, with
     identical ATE, OSPA and landmark count; a Linear2D `-a isam2` run; a
     60-frame mapping-only run (ATE exactly 0);
     `bench_isam2 --scan` and `--scan-da` over 300 frames (ATE, landmarks
     against the world's 40, OSPA); and the host synchronisations per frame
     of the navigator and of each scan runner, counted under
     torch.cuda.set_sync_debug_mode("warn") with the lines that waited,
     beside the reads the code counts itself, printed and not limited. This path runs no hand-written kernel: both launch counts
     must stay 0 over it, and TF32 must be off.
  8. `loopy`: the smoother. The beam kernel bit-identical to its plain
     version at the smoother's value-only shape (P = J*M = 1056 seeds, B=32,
     C=8, one word, 33 steps), the fused kernel with one measurement mask
     per particle ([8, M]: the leave-block-out passes) and with P=1 against
     its plain version to phase 3's tolerances, each timed (in turns with
     the parent); then `-i record
     -a loopy` over the JAX package's own chap5 s2 odometry recording
     (tests/data/chap5_s2_odometry_jax.zip) twice, identical and within
     LOOPY_JAX_TOL of the JAX package's result on it; the chap5 s2 workflow
     through cli.main as experiments/run_experiments.py runs it (-a phd -p 50
     on linear2d.world + mov2d.in with chap5-default2d.cfg, the odometry
     replay of that recording, then `-i record -a loopy`) once, under the
     limits below; a float64 `-a loopy` run on the card (90 frames); one 3D
     `-a loopy` run over phase 6's PHD recording (cut to LOOPY_BUDGET_S);
     both kernels launched over the float32 runs, and the host
     synchronisations per node of the smoother.
  9. `kinect`: the RGB-D input. The beam kernel bit-identical to its plain
     version at the path's shape (P=2000, B=200, C=8, M=64, 4 words), timed;
     convert_tum of assets/tum_real (the PNG decoder that ran printed);
     experiments_kinect.k6real twice (`-a isam2` float64 identical in both
     and under its limit; `-a phd -y` mapping with measurements every frame
     and a map); experiments_kinect.k9: `-a phd -p 2000` in float32 (beam
     kernel once a frame, fused kernel never: the Kinect model has depth
     occlusion), twice, identical, with its host reads a frame and peak
     device memory, and `odometry` and `isam2` in float64, each under its
     limit; the idle share of 10 profiled frames (profile_step --kinect);
     then `cli.main -i kinect` with `-a isam2` (float64), `-a phd -p 200`
     and `-a odometry` over the converted sequence, postanalysis on each,
     and the recording's sidebar.avi: one baseline JPEG a frame at the
     subsampled image's size.
 10. `grid`: the experiment grids. Both kernels at the grid's shapes against
     their plain versions: the beam bit for bit at the command line's shape
     (B=200, C=8, 4 words, 48 slots) with 800 and 2000 particles and at
     bench_scaling's (B=32, C=6, 24 steps) with 10,000, on random and
     tie-heavy options; the fused kernel to compare_fused's tolerances at
     chap3-default.cfg's capacity (K0=500, 48 slots) with 800 and 2000
     particles and at bench_scaling's shape (K0=128, 48 slots, 4 merge
     rounds) with 10,000; each timed (in turns with the parent), with the
     launch's peak device memory and the phase split. Then
     run_gpu_grid chap3-s1 (800 particles, float32, all 300 frames: 300
     launches of each kernel over the phd leg, none over the odometry replay,
     ATE / OSPA under GRID_S1), run_gpu_grid.throughput at 200 and 2000
     particles and bench_scaling at 10,000 (frames/s, particle updates/s,
     peak memory, ATE under the bench limit), and summarize over the
     phase's outdir (the rows there, chap3-s1 phd held against the JAX
     package's row).
 11. `parallel`: the multi-device paths (monorfs_tpu_torch/parallel) over
     NCCL with a world of one (NCCL takes no two ranks on one card; N > 1
     runs are the CPU tests' gloo ranks). The particle-sharded step against
     the single-card step over the bench path's PARALLEL_FRAMES frames with
     the same vehicle frames and draws (poses atol 1e-5, log-weights atol
     2e-3, best and ancestors equal), each kernel launched once a frame on
     the sharded run; one block-sharded smoother sweep against the
     sequential sweep (then relinearize) over PARALLEL_NODES nodes of the 2D
     chap5 odometry run at full width in float32 (fused mean / cov and map
     messages atol 1e-5), the fused kernel launched by its cavity passes;
     the landmark-sharded Schur BA against graph.gauss_newton in float64
     on a random 3D graph (atol 1e-8); then bench_flagship at its defaults
     (100,000 particles, 10,240 landmarks x 128 poses): seconds a step,
     particle updates a second, seconds a Gauss-Newton iteration, peak
     memory. The phase's seconds are printed beside PARALLEL_BUDGET_S.
 12. `view`: the viewers, drawn on the card by the port's rasterizer
     (monorfs_tpu_torch/render). manipulator.ManipulatorLoop over the 3D asset
     world and mov3d.in at full width (200 particles, float32, the default
     PHDConfig) with keys sent as a user would (i held over frames 20-40 with
     shift over 30-40, m at 100 and 120, escape twice, delete at the end),
     every 10th frame rendered by viewer3d.render_3d: the fused kernel
     launched once per frame and the beam kernel once per SLAM frame,
     postanalysis's ATE / OSPA finite. viewer.main over that recording: the 3D
     overview, --flat, --frames at stride 30, two --tag and --tag-shots,
     --avi at stride 10 read back (read_mjpeg) and decoded (decode_frames)
     within a mean error of 3 levels of the rendered frames; the 2D overview
     of phase 6's 2D recording (or a short new one). The sidebar of phase 9's
     k9 recording (or of a short -i kinect run) decoded on the card and on
     the CPU: equal. One frame rendered twice on the card: identical PNG
     bytes; on the CPU: the largest difference and the pixels that differ.
     ms per rendered frame (batched and alone), write_png ms, ms per decoded
     frame (host Huffman, device), PNG bytes; the phase's seconds beside
     VIEW_BUDGET_S. It runs inside the temporary directory after phase 10.
 13. `vehicle`: the simulated vehicle's frame as one CUDA graph
     (sim/vehicle.py::FrameRunner), run after phase 5. For PRM3D, Linear2D
     and Linear1D over VEHICLE_FRAMES frames of the asset world, eager
     update + measure and the runner in turns: every output of every frame
     bit-equal, each held to the end; host ms a frame and syncs a frame of
     each. A Simulation without its history (a sleeping kernel a frame
     keeps the device behind the host) moves the vehicle as one with it
     (the pinned reading's guard); one capture and a replay a frame in
     both; a replayed recording builds no graph; a runner captured under
     torch.profiler gives the eager frame, and the kernel events a replayed
     frame records. The phase's seconds beside VEHICLE_BUDGET_S.
Cuts for the time limit: phase 6 runs the 180-landmark world over the first
CLI180_FRAMES of mov3d.in's 300 frames; phase 7 repeats the 3D `-a isam2`
command over its first REPEAT_FRAMES of 300 frames; phase 8 runs the port's own
s2 recording once (the repeat runs on the JAX recording) and its 3D run to
LOOPY_BUDGET_S. Phase 4 still runs all 300 frames.

A kernel's time is its device time: torch.profiler's CUDA kernel events
selected by the kernel's name, their mean over the launches. The wrapper's wall
time per call is printed beside it. --parent DIR also loads the port from
another checkout (DIR/monorfs_tpu_torch, built by its own _build), times
its kernels on the same inputs, in turns with this checkout's
(parent, this, this, parent), and holds the fused kernel's PRM3D results
to the parent's bit for bit at the bench shape's states. --phases runs a
subset (kernels = 1's checks, 2, 3 and the weight stage's kernels). Every
path's launch counts hold the mixture likelihood kernel to once a float32
SLAM frame, as the beam, and to none where no particle is weighed (mapping
only, float64, the smoother, the graph backend); the association kernel the
same, and to none with the Kinect model either.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from monorfs_tpu_torch import (_build, bench_core, bench_flagship, bench_isam2, bench_scaling, cli,
                               experiments_kinect, manipulator, native, postanalysis, viewer, viewer3d)
from monorfs_tpu_torch.bench import BENCH_CONFIG, run as run_bench
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.experiments import run_experiments, run_gpu_grid, summarize
from monorfs_tpu_torch.frontend.dataset import RGBDDataset, convert_tum
from monorfs_tpu_torch.geometry import pose3d
from monorfs_tpu_torch.gm.mixture import DEAD, SGM
from monorfs_tpu_torch.io import Recording, World, parse_commands
from monorfs_tpu_torch.io import avi
from monorfs_tpu_torch.io.avi import jpeg_size, read_mjpeg
from monorfs_tpu_torch.kernel_bounds import assoc_bound, beam_bound, fused_bound, mixture_bound
from monorfs_tpu_torch.kernel_cases import ASSOC_CASES, MIXTURE_EDGES, assoc_case, beam_ties, fused_state, mixture_case
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.models import get as get_model
from monorfs_tpu_torch.render import axes
from monorfs_tpu_torch.render.png import encode_png, read_png
from monorfs_tpu_torch.profile_step import (count_syncs, host_syncs, in_package, loopy_navigator,
                                            profile_kinect)
from monorfs_tpu_torch.parallel import chain, dist_ba, make_mesh, make_sharded_step, multihost, shard_state
from monorfs_tpu_torch.sim import vehicle as vehicle_mod
from monorfs_tpu_torch.sim.simulation import Simulation
from monorfs_tpu_torch.gm import mixture
from monorfs_tpu_torch.slam import assoc_kernel, association, beam_kernel, fused_kernel, graph, loopy, mixture_kernel
from monorfs_tpu_torch.slam.isam2_scan import build_isam2_scan_runner, scan_draws
from monorfs_tpu_torch.slam.isam2_scan_da import build_mahalanobis_scan
from monorfs_tpu_torch.slam import phd
from monorfs_tpu_torch.slam.phd import PHDConfig

ATE_LIMIT = 0.03  # ~3x the JAX package's 0.0108 on this config
BENCH_FRAMES = 300  # the whole of mov3d.in
BEAM_KERNEL = "beam_scan"  # substring of every beam kernel's name
FUSED_KERNEL = "fused_stage_kernel"
MIXTURE_KERNEL = "mixture_ll_kernel"
ASSOC_KERNEL = "assoc_options_kernel"
KERNEL_NAMES = ("beam_scan", "fused_stage", "mixture_ll", "assoc_options")  # the launch counters


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, timed with CUDA events
    after a warm-up call (for the plain versions: many small kernels)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps, kernel):
    """Device milliseconds per launch of the kernel whose name holds
    `kernel`: torch.profiler's CUDA kernel events of reps calls of fn, their
    mean duration (as profile_step reads them). Once a process has run for
    a minute or so, the tracer drops a leading run of a session's kernel
    events (whatever the host does before the first launch); so a session
    with fewer than reps - 1 events is taken again, up to three, said as
    `profiler-short`, and the fullest kept: each event is a whole launch of
    the same kernel on the same inputs. No event in all three raises, as
    more events than calls does."""
    fn()
    torch.cuda.synchronize()
    best = []
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
        best = max(best, events, key=len)
        if len(best) >= reps - 1:
            break
        say("profiler-short", kernel=kernel, reps=reps, events=len(events), attempt=attempt)
    if not 1 <= len(best) <= reps:
        raise AssertionError(f"{len(best)} {kernel} kernel events for {reps} calls")
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / len(best)


def wall_ms(fn, reps):
    """Host wall milliseconds per call of fn, the device drained at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def in_turns(new_fn, parent_fn, reps, kernel):
    """Device ms of this checkout's kernel and, with a parent, the parent's:
    parent, this, this, parent; returns (this [ms, ms], parent [ms, ms])."""
    if parent_fn is None:
        return [kernel_ms(new_fn, reps, kernel)], None
    a = kernel_ms(parent_fn, reps, kernel)
    b = kernel_ms(new_fn, reps, kernel)
    c = kernel_ms(new_fn, reps, kernel)
    d = kernel_ms(parent_fn, reps, kernel)
    return [b, c], [a, d]


def load_parent(root):
    """(beam_kernel, fused_kernel) of the port in another checkout, imported
    as the package `parent_port`; its kernels build into its own tree."""
    pkg = pathlib.Path(root).resolve() / "monorfs_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("parent_port.slam.beam_kernel"),
            importlib.import_module("parent_port.slam.fused_kernel"))


# ---- phase 2: beam ---------------------------------------------------------------

def beam_random(dev, seed, p, n, m, c):
    """Option tensors from a random gated likelihood through prepare_options."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ll = torch.randn((p, n, m), generator=g, device=dev) * 3
    ll = torch.where(torch.rand((p, n, m), generator=g, device=dev) < 0.7,
                     torch.full_like(ll, association.NEG), ll)
    log_miss = torch.randn((p, n), generator=g, device=dev) * 0.5 - 1
    n_mask = torch.rand((p, n), generator=g, device=dev) < 0.8
    m_mask = torch.rand((p, m), generator=g, device=dev) < 0.8
    base, od, wk, bk, n_words = association.prepare_options(ll, log_miss, -2.5, n_mask, m_mask, c)
    return (base, od, wk, bk), n_words


def beam_check(name, inputs, b, n_words):
    out = beam_kernel.beam_scan_batch(*inputs, b, n_words)
    ref = beam_kernel.beam_scan_plain(*inputs, b, n_words)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        diff = (out != ref).sum().item()
        raise AssertionError(f"beam kernel differs from plain on {name}: {diff} scores")
    say("beam-check", case=name, equal=True, shape=dict(P=inputs[1].shape[0], M=inputs[1].shape[1],
                                                         C=inputs[1].shape[2] - 1, B=b, n_words=n_words))


# The block design's shapes (csrc/beam_scan.cu: B > 32 or C+1 > 8), each as
# the path that runs it builds it: name, P, landmarks, M, C, B, timing reps.
BLOCK_SHAPES = [
    ("default-B200-C8-W4-M24", 200, 128, 24, 8, 200, 10),  # the default PHDConfig, 24 slots
    ("cli-B200-C8-W4-M48", 200, 128, 48, 8, 200, 10),  # the command line's 48 slots
    ("grid-P800-B200-C8-W4-M48", 800, 128, 48, 8, 200, 5),  # the grid at 800 particles
    ("grid-P2000-B200-C8-W4-M48", 2000, 128, 48, 8, 200, 5),  # and at 2000
    ("kinect-P2000-B200-C8-W4-M64", 2000, 128, 64, 8, 200, 5),  # k9
    ("loopy-P1056-B32-C8-W1-M33", 1056, 32, 33, 8, 32, 10),  # the smoother's value-only seeds, 2D
    ("loopy3d-P1536-B32-C8-W1-M48", 1536, 32, 48, 8, 32, 10),  # and 3D
    ("B64-C8-W3-M24", 200, 96, 24, 8, 64, 10),
]


def beam_block(dev, parent):
    """The `beam-block` line: at each block-design shape, this checkout's
    kernel time (device, profiler events), the parent's in turns under
    --parent, the plain scan's CUDA-graph replay and the bound. Each input
    is held to the plain version bit for bit first. Returns the rows."""
    rows = []
    for i, (name, p, n, m, c, b, reps) in enumerate(BLOCK_SHAPES):
        inputs, n_words = beam_random(dev, 41 + i, p, n, m, c)
        beam_check(name, inputs, b, n_words)
        ms, parent_ms = in_turns(
            lambda: beam_kernel.beam_scan_batch(*inputs, b, n_words),
            None if parent is None else (lambda: parent[0].beam_scan_batch(*inputs, b, n_words)),
            reps, BEAM_KERNEL)
        bms, by = beam_bound(inputs, b)
        row = dict(case=name, shape=dict(P=p, M=m, C=c, B=b, n_words=n_words), max_abs_err=0.0,
                   ms=float(np.mean(ms)), ms_runs=ms,
                   parent_ms=None if parent_ms is None else float(np.mean(parent_ms)),
                   parent_ms_runs=parent_ms,
                   plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 2),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
    say("beam-block", shapes=rows)
    return rows


def beam_phase(dev, parent):
    p, n, m, c, b = 200, BENCH_CONFIG.estimate_cap, BENCH_CONFIG.beam_meas_cap, \
        BENCH_CONFIG.beam_candidates, BENCH_CONFIG.beam_width
    inputs, n_words = beam_random(dev, 3, p, n, m, c)
    beam_check("bench", inputs, b, n_words)
    ties = [torch.as_tensor(x, device=dev) for x in beam_ties(5, p, m, c, n_words)]
    beam_check("ties", ties, b, n_words)
    beam_check("B64-C8-W3", beam_random(dev, 7, p, 96, m, 8)[0], 64, 3)
    beam_check("ties-B64-C8-W3", [torch.as_tensor(x, device=dev) for x in beam_ties(9, p, m, 8, 3)], 64, 3)
    default = PHDConfig()
    wide = beam_random(dev, 11, p, default.estimate_cap, m, default.beam_candidates)[0]
    wide_b, wide_w = default.beam_width, (default.estimate_cap + 31) // 32
    beam_check("default-B200-C8-W4", wide, wide_b, wide_w)
    # tie-heavy options at the block design's shapes: the command line's
    # B=200 C=8 over 48 steps, the smoother's B=32 C=8 with one word
    beam_check("ties-B200-C8-W4-M48", [torch.as_tensor(x, device=dev) for x in beam_ties(13, p, 48, 8, 4)],
               200, 4)
    beam_check("ties-B32-C8-W1-M33", [torch.as_tensor(x, device=dev) for x in beam_ties(15, 1056, 33, 8, 1)],
               32, 1)

    def run():
        return beam_kernel.beam_scan_batch(*inputs, b, n_words)

    parent_run = None if parent is None else (lambda: parent[0].beam_scan_batch(*inputs, b, n_words))
    ms, parent_ms = in_turns(run, parent_run, 50, BEAM_KERNEL)
    w_ms = wall_ms(run, 50)
    plain_ms = cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 5)
    bms, by = beam_bound(inputs, b)
    block = beam_block(dev, parent)
    say("beam", ms=ms, parent_ms=parent_ms, wrapper_ms=w_ms, plain_ms=plain_ms,
        shape=dict(P=p, M=m, C=c, B=b, n_words=n_words),
        default_shape_ms=block[0]["ms_runs"], default_shape_parent_ms=block[0]["parent_ms_runs"])
    row = dict(name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
               replaces="monorfs_tpu/slam/beam_pallas.py:178", max_abs_err=0.0, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               shapes=[{k: v for k, v in r.items() if not k.endswith("_runs")} for r in block[:2]])
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


# The beam past the 256-thread block's 8,192 candidates: B(C+1) = 9,000 on
# the 1024-thread block, 8 particles, 24 slots, 4 words; and the first shapes
# no design takes (shared memory at 4 words, the 65,535 candidates at 1 word).
WIDE_BEAM = dict(P=8, B=1000, C=8, M=24, n_lm=128)
WIDE_FRAMES = 5
BEYOND_BEAM = ((4769, 128), (7282, 32))  # (B, landmarks) at C=8, M=24


def beam_wide(dev):
    """The `beam-wide` line: the kernel at WIDE_BEAM bit-identical to the
    plain scan on random and tie-heavy options, timed beside the plain scan
    and the bound; the wrapper raises at BEYOND_BEAM. Then WIDE_FRAMES
    float32 SLAM steps at that beam width through bench_core (the 3D asset
    world): both kernels once a frame, finite weights. Returns the row."""
    p, b, c, m = WIDE_BEAM["P"], WIDE_BEAM["B"], WIDE_BEAM["C"], WIDE_BEAM["M"]
    inputs, n_words = beam_random(dev, 61, p, WIDE_BEAM["n_lm"], m, c)
    beam_check("wide-B1000-C8-W4-M24", inputs, b, n_words)
    beam_check("ties-B1000-C8-W4-M24", [torch.as_tensor(x, device=dev) for x in beam_ties(63, p, m, c, n_words)],
               b, n_words)
    for i, (bb, n_lm) in enumerate(BEYOND_BEAM):
        far, nw = beam_random(dev, 65 + i, 1, n_lm, m, c)
        if beam_kernel.takes(m, c, bb, nw):
            raise AssertionError(f"beam_kernel.takes B={bb} C={c} n_words={nw}")
        try:
            beam_kernel.beam_scan_batch(*far, bb, nw)
        except ValueError:
            continue
        raise AssertionError(f"the beam at B={bb} C={c} n_words={nw}: the wrapper did not raise")
    ms = kernel_ms(lambda: beam_kernel.beam_scan_batch(*inputs, b, n_words), 10, BEAM_KERNEL)
    plain_ms = cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 2)
    bms, by = beam_bound(inputs, b)

    assets = pathlib.Path(__file__).resolve().parent / "assets"
    pcfg = PHDConfig(num_particles=p, max_components=128, max_measurements=48, meas_compact=m,
                     beam_width=b, beam_candidates=c)
    runner, carry, cmds = bench_core.setup(assets / "sim3d.world", assets / "mov3d.in", p, WIDE_FRAMES,
                                           phd_cfg=pcfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    draws = bench_core.draw_chunk(runner, gen, WIDE_FRAMES, carry.vstate.landmarks.shape[0], torch.float32)
    reset_launches()
    out, _ = bench_core.run_frames(runner, carry, cmds, draws)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != dict.fromkeys(KERNEL_NAMES, WIDE_FRAMES):
        raise AssertionError(f"B={b} steps: launches {launches}")
    if not torch.isfinite(out.nstate.logweight).all():
        raise AssertionError(f"B={b} steps: log-weights not finite")
    row = dict(case="wide-B1000-C8-W4-M24", shape=dict(P=p, M=m, C=c, B=b, n_words=n_words), max_abs_err=0.0,
               ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    say("beam-wide", **row, beyond_raises=[dict(B=bb, C=c, M=m) for bb, _ in BEYOND_BEAM],
        frames=WIDE_FRAMES, launches=launches)
    return row


# ---- phase 3: fused --------------------------------------------------------------

def warm_state(seed, p, k0, m, n_lm, dev, merge_ties=False, model="PRM3D"):
    """kernel_cases.fused_state as float32 tensors on the device."""
    pose, leaves, z, z_mask = fused_state(seed, p, k0, m, n_lm, merge_ties, model)
    maps = SGM(*[torch.tensor(x, dtype=torch.float32, device=dev) for x in leaves])
    return (torch.tensor(pose, dtype=torch.float32, device=dev), maps,
            torch.tensor(z, dtype=torch.float32, device=dev), torch.tensor(z_mask, device=dev))


def _close(a, b, rtol, atol, rows, what, bad):
    """Record in `bad` (what -> the first failing particle) where a differs
    from b beyond atol + rtol * |b| on the particles in `rows` [P]."""
    off = rows & ~(torch.abs(a - b) <= atol + rtol * torch.abs(b)).all(-1)
    bad.append((what, off))


def compare_fused(pred, cor, pred_ref, cor_ref):
    """Raises unless the kernel's output matches the plain version's within
    the stated tolerances; returns the largest absolute difference seen.

    Predicted maps: every leaf within rtol / atol 2e-5 (weights of live
    components only). Corrected maps, per particle: as many live components
    as the plain version, the weights in weight order within 1e-4, and each
    component in weight order matched to the nearest unused plain component,
    means within 1e-4, covariances within rtol 1e-3 / atol 1e-5 (the
    tolerances of tests/test_fused_pallas.py). All particles at once on the
    device, one component rank a step."""
    err = 0.0
    live = pred_ref.logw > DEAD / 4
    for name, a, b in zip(SGM._fields, pred, pred_ref):
        a, b = (a[live], b[live]) if name == "logw" else (a, b)
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=f"predicted {name}")
        err = max(err, (a - b).abs().max().item())
    got, ref = [torch.stack(list(s), -1) for s in (cor, cor_ref)]  # [P, K, 10]
    g_live, r_live = got[..., 9] > DEAD / 4, ref[..., 9] > DEAD / 4
    n, n_ref = g_live.sum(1), r_live.sum(1)
    if (n != n_ref).any():
        i = int(torch.nonzero(n != n_ref)[0, 0])
        raise AssertionError(f"particle {i}: {int(n[i])} components vs plain {int(n_ref[i])}")

    def by_weight(x, alive):  # live components first, by weight, ties in slot order
        key = torch.where(alive, x[..., 9], torch.full_like(x[..., 9], -float("inf")))
        idx = torch.sort(key, dim=1, descending=True, stable=True).indices
        return torch.gather(x, 1, idx[..., None].expand_as(x))

    g, r = by_weight(got, g_live), by_weight(ref, r_live)
    p, k = g.shape[:2]
    slot = torch.arange(k, device=g.device)[None, :] < n[:, None]
    off = slot & ~(torch.abs(g[..., 9] - r[..., 9]) <= 1e-4 + 1e-4 * torch.abs(r[..., 9]))
    bad = [("weights", off.any(1))]
    used = ~slot
    rows = torch.arange(p, device=g.device)
    worst = torch.zeros((), dtype=g.dtype, device=g.device)
    for j in range(int(n.max()) if p else 0):
        act = j < n
        d = torch.linalg.norm(r[..., :3] - g[:, j : j + 1, :3], dim=-1) + torch.where(used, 1e9, 0.0)
        jj = torch.argmin(d, dim=1)
        used[rows[act], jj[act]] = True
        m = r[rows, jj]
        _close(g[:, j, :3], m[:, :3], 1e-4, 1e-4, act, f"means of rank {j}", bad)
        _close(g[:, j, 3:9], m[:, 3:9], 1e-3, 1e-5, act, f"covariances of rank {j}", bad)
        worst = torch.maximum(worst, torch.where(act, (g[:, j] - m).abs().amax(1), 0.0).max())
    for what, off in bad:
        if off.any():
            i = int(torch.nonzero(off)[0, 0])
            raise AssertionError(f"particle {i}: corrected {what} differ from the plain version's")
    return max(err, float(worst))


def phase_split(args, fk=fused_kernel):
    """Cycles of each fused-kernel phase across blocks (median, max), from
    one launch with the phase clock probe; fk: this checkout's fused_kernel
    module or the parent's."""
    p, k0, m = args[4].logw.shape[0], args[4].capacity, args[5].shape[0]
    names = fk.PHASES
    clk = torch.zeros((p, len(names) + 1), dtype=torch.int64, device=args[3].device)
    fk.fused_stage(*args, phase_clock=clk)
    d = torch.diff(clk, dim=1).cpu().numpy()
    split = {name: [float(np.median(d[:, i])), int(d[:, i].max())] for i, name in enumerate(names)}
    total = d.sum(1)
    split["total"] = [float(np.median(total)), int(total.max())]
    return split


def fused_turns(args, parent, reps):
    """(this checkout's device ms runs, the parent's or None, the parent's
    phase split or None) of the fused kernel on args, in turns with the
    parent where the parent launches this shape (a checkout without the live
    design raises where the block layout does not fit)."""
    parent_run = None
    if parent is not None:
        try:
            parent[1].fused_stage(*args)
            torch.cuda.synchronize()
            parent_run = lambda: parent[1].fused_stage(*args)  # noqa: E731
        except ValueError as exc:
            say("fused-parent-refuses", shape=dict(P=args[3].shape[0], K0=args[4].capacity, M=args[5].shape[0]),
                error=str(exc))
    ms, parent_ms = in_turns(lambda: fused_kernel.fused_stage(*args), parent_run, reps, FUSED_KERNEL)
    split = None if parent_run is None else phase_split(args, parent[1])
    return ms, parent_ms, split


def fused_row(name, mname, args, reps, parent, err, plain=True):
    """The row of one timed fused shape: sizes, device ms (in turns with the
    parent where it launches), plain ms (plain=False: not timed), bound,
    phase splits."""
    model, pcfg, params, pose, maps, z, z_mask = args
    pp, kk, mm = pose.shape[0], maps.capacity, z.shape[0]
    pred, cor = fused_kernel.fused_stage(*args)
    ms, parent_ms, parent_split = fused_turns(args, parent, reps)
    bms, by = fused_bound(pp, kk, mm, model.meas_dim, model.pose.state_dim, maps, pred, z_mask, cor, params)
    return dict(case=name, model=mname, shape=dict(P=pp, K0=kk, M=mm, KP=kk + mm), max_abs_err=err,
                alive_out=int((cor.logw > DEAD / 2).sum().item()),
                alive_in_max=int((maps.logw > DEAD / 2).sum(1).max().item()),
                smem_bytes=fused_kernel.smem_bytes(kk, mm),
                workspace_floats=fused_kernel.workspace_floats(kk, mm),
                ms=float(np.mean(ms)), ms_runs=ms,
                parent_ms=None if parent_ms is None else float(np.mean(parent_ms)), parent_ms_runs=parent_ms,
                parent_launches=None if parent is None else parent_ms is not None,
                plain_ms=cuda_ms(lambda: fused_kernel.fused_stage_plain(*args), 2) if plain else None,
                bound_ms=bms, bound_by=by,
                cycles_median_max=phase_split(args), parent_cycles_median_max=parent_split)


# The flagship deployment's fused shape (flagship-p100k): bench_flagship's
# budget (K0 128, 48 slots, gate_top 8, 4 merge rounds) at 100,000 particles,
# from a state whose cap binds (124 landmarks in 128 slots, as the cell's
# 124-128 live components); the plain version takes a chunk of particles at
# a time ([P, K, K] temporaries)
FLAGSHIP_FUSED = (100_000, 124, 61)  # particles, landmarks, seed
FLAGSHIP_PLAIN_CHUNK = 5_000


def flagship_fused(dev, params, parent):
    """The `fused-shape` row of the flagship's shape: the kernel against its
    plain version chunk by chunk, then timed (in turns with the parent)."""
    p, n_lm, seed = FLAGSHIP_FUSED
    cfg = bench_flagship.flagship_config(p)
    pose, maps, z, z_mask = warm_state(seed, p, cfg.max_components, cfg.max_measurements, n_lm, dev)
    args = (PRM3D, cfg, params, pose, maps, z, z_mask)
    pred, cor = fused_kernel.fused_stage(*args)
    err = 0.0
    for lo in range(0, p, FLAGSHIP_PLAIN_CHUNK):
        rows = slice(lo, lo + FLAGSHIP_PLAIN_CHUNK)
        part = lambda sgm: SGM(*[leaf[rows] for leaf in sgm])  # noqa: E731
        ref = fused_kernel.fused_stage_plain(PRM3D, cfg, params, pose[rows], part(maps), z, z_mask)
        err = max(err, compare_fused(part(pred), part(cor), *ref))
    row = fused_row(f"flagship-P{p}-K{cfg.max_components}-M{cfg.max_measurements}-cap-binds", "PRM3D", args,
                    10, parent, err, plain=False)
    say("fused-shape", **row)
    say("fused-phases", case=row["case"], cycles_median_max=row["cycles_median_max"],
        parent_cycles_median_max=row["parent_cycles_median_max"])
    return row


# csrc/'s shape decisions, copied in Python (fused_kernel.layout_bytes /
# workspace_floats, beam_kernel.layout_bytes, mixture_kernel.layout_bytes,
# assoc_kernel.launch_shape), against the built C functions
LAYOUT_FUSED_K0 = (16, 64, 128, 300, 400, 500, 600, 663, 1000, 2000)
LAYOUT_FUSED_M = (1, 20, 24, 33, 48, 64, 180, 188)
LAYOUT_BEAM = [(m, c, b, w) for m in (24, 48, 188) for c in (6, 7, 8)
               for b in (1, 32, 33, 64, 200, 910, 911, 1000, 1821, 3641, 4768, 4769, 7281, 7282)
               for w in (1, 2, 4)]
LAYOUT_MIXTURE = [(k, e) for k in (1, 37, 152, 548, 648, 1064, 2047, 2048, 2500, 10**5)
                  for e in (1, 48, 128, 4096)]
LAYOUT_ASSOC = [(e, m, mz, d) for e in (0, 4, 48, 128, 2000, 7000, 11_600, 11_700)
                for m, mz in ((0, 0), (24, 24), (24, 48), (48, 48), (188, 188), (300, 300)) for d in (1, 2, 3)]


def layout_check():
    bad = []
    for k0 in LAYOUT_FUSED_K0:
        for m in LAYOUT_FUSED_M:
            got = (fused_kernel.layout_bytes(k0, m), fused_kernel.workspace_floats(k0, m))
            want = (fused_kernel.smem_bytes(k0, m), fused_kernel.workspace_floats_built(k0, m))
            if got != want or not 0 < got[0] <= _build.SMEM_LIMIT:
                bad.append(("fused", k0, m, got, want))
    for m, c, b, w in LAYOUT_BEAM:
        got, want = beam_kernel.layout_bytes(m, c, b, w), beam_kernel.smem_bytes(m, c, b, w)
        if got != want:
            bad.append(("beam", m, c, b, w, got, want))
    for k, e in LAYOUT_MIXTURE:
        got, want = mixture_kernel.layout_bytes(k, e), mixture_kernel.smem_bytes(k, e)
        if got != want:
            bad.append(("mixture", k, e, got, want))
    for e, m, mz, d in LAYOUT_ASSOC:
        got = assoc_kernel.launch_shape(e, m, mz, d)
        want = (assoc_kernel.particles_per_block(e, m, mz, d), assoc_kernel.smem_bytes(e, m, mz, d))
        if got != want:
            bad.append(("assoc", e, m, mz, d, got, want))
    if bad:
        raise AssertionError(f"Python layout copies differ from csrc/: {bad[:10]}")
    say("layout-check", fused_shapes=len(LAYOUT_FUSED_K0) * len(LAYOUT_FUSED_M), beam_shapes=len(LAYOUT_BEAM),
        mixture_shapes=len(LAYOUT_MIXTURE), assoc_shapes=len(LAYOUT_ASSOC), equal=True, fused_live_smem_bytes=fused_kernel.layout_bytes(600, 48),
        beam_block_k_B910_B911_C8=[beam_kernel.block_k(910 * 9), beam_kernel.block_k(911 * 9)],
        beam_takes_B4768_B4769_C8_W4=[beam_kernel.takes(24, 8, 4768, 4), beam_kernel.takes(24, 8, 4769, 4)])


def model_phd_params(name, dev):
    cfg = Config()
    cfg.set_model_defaults(name)
    return cfg.phd_params(torch.float32, dev)


def fused_phase(dev, parent):
    params = model_phd_params("PRM3D", dev)
    p, k0 = 200, BENCH_CONFIG.max_components
    m = BENCH_CONFIG.meas_compact
    cap_cfg = PHDConfig(num_particles=p, max_components=16, max_measurements=m,
                        gate_top=4, merge_rounds=4)
    second_cfg = PHDConfig(num_particles=p, max_components=64, max_measurements=40,
                           gate_top=6, merge_rounds=3)
    cases = [("bench", BENCH_CONFIG, m, 0, 40, False), ("bench-seed3", BENCH_CONFIG, m, 3, 40, False),
             ("cap-binds", cap_cfg, m, 7, 14, False), ("merge-ties", BENCH_CONFIG, m, 13, 30, True),
             ("K64-M40", second_cfg, 40, 11, 20, False)]
    err = 0.0
    for name, pcfg, mm, seed, n_lm, ties in cases:
        pose, maps, z, z_mask = warm_state(seed, p, pcfg.max_components, mm, n_lm, dev, ties)
        pred, cor = fused_kernel.fused_stage(PRM3D, pcfg, params, pose, maps, z, z_mask)
        pred_ref, cor_ref = fused_kernel.fused_stage_plain(PRM3D, pcfg, params, pose, maps, z, z_mask)
        torch.cuda.synchronize()
        err = max(err, compare_fused(pred, cor, pred_ref, cor_ref))
        same = None
        if parent is not None:  # the PRM3D instantiation against the parent's kernel, bit for bit
            ppred, pcor = parent[1].fused_stage(PRM3D, pcfg, params, pose, maps, z, z_mask)
            same = all(torch.equal(a, b) for a, b in zip(list(pred) + list(cor), list(ppred) + list(pcor)))
            if not same:
                raise AssertionError(f"fused kernel differs from the parent's on {name}")
        say("fused-check", case=name, ok=True, alive_out=int((cor.logw > DEAD / 2).sum().item()),
            equals_parent=same)
    pose, maps, z, z_mask = warm_state(0, p, k0, m, 40, dev)
    args = (PRM3D, BENCH_CONFIG, params, pose, maps, z, z_mask)
    split = phase_split(args)
    say("fused-phases", case="bench", cycles_median_max=split,
        parent_cycles_median_max=None if parent is None else phase_split(args, parent[1]))

    def run():
        return fused_kernel.fused_stage(*args)

    parent_run = None if parent is None else (lambda: parent[1].fused_stage(*args))
    ms, parent_ms = in_turns(run, parent_run, 20, FUSED_KERNEL)
    w_ms = wall_ms(run, 20)
    plain_ms = cuda_ms(lambda: fused_kernel.fused_stage_plain(*args), 3)
    pred, cor = run()
    kp = k0 + m
    bms, by = fused_bound(p, k0, m, 3, 7, maps, pred, z_mask, cor, params)
    say("fused", ms=ms, parent_ms=parent_ms, wrapper_ms=w_ms, plain_ms=plain_ms, max_abs_err=err,
        smem_bytes=fused_kernel.smem_bytes(k0, m), shape=dict(P=p, K0=k0, M=m, KP=kp))

    # the other families, and the command line's capacity (K0 = 600) and
    # beyond it: K0 = 600 with 180 slots (a 172-landmark world), K0 = 663 and
    # K0 = 1000; each state vs the plain version, then device ms (in turns
    # with the parent where it launches), plain ms, bound and phase split at
    # that shape; then the flagship deployment's shape
    cli = PHDConfig(num_particles=p)  # the command line's default: K=600, gate_top 16, 8 rounds
    bind = PHDConfig(num_particles=32)
    shapes = [
        # name, model, config, P, M, seed, landmarks
        ("lin2d-K128-M24", "Linear2D", BENCH_CONFIG, p, m, 21, 20),
        ("lin1d-K128-M24", "Linear1D", BENCH_CONFIG, p, m, 22, 10),
        ("prm3d-K600-M48", "PRM3D", cli, p, 48, 23, 40),
        ("prm3d-K600-M48-cap-binds", "PRM3D", bind, 32, 48, 24, 580),
        ("lin2d-K600-M33", "Linear2D", cli, p, 33, 25, 25),
        ("lin1d-K600-M20", "Linear1D", cli, p, 20, 26, 12),
        ("prm3d-K600-M180", "PRM3D", cli, p, 180, 27, 172),
        ("prm3d-K663-M48", "PRM3D", PHDConfig(num_particles=p, max_components=663), p, 48, 28, 40),
        ("prm3d-K1000-M64", "PRM3D", PHDConfig(num_particles=p, max_components=1000), p, 64, 29, 60),
    ]
    extra = []
    for name, mname, pcfg, pp, mm, seed, n_lm in shapes:
        model, mparams = get_model(mname), model_phd_params(mname, dev)
        pose, maps, z, z_mask = warm_state(seed, pp, pcfg.max_components, mm, n_lm, dev, model=mname)
        sargs = (model, pcfg, mparams, pose, maps, z, z_mask)
        pred, cor = fused_kernel.fused_stage(*sargs)
        pred_ref, cor_ref = fused_kernel.fused_stage_plain(*sargs)
        torch.cuda.synchronize()
        e = compare_fused(pred, cor, pred_ref, cor_ref)
        err = max(err, e)
        row = fused_row(name, mname, sargs, 10, parent, e)
        say("fused-shape", **row)
        if name == "prm3d-K600-M48":  # the command line's 3D shape
            say("fused-phases", case=name, cycles_median_max=row["cycles_median_max"],
                parent_cycles_median_max=row["parent_cycles_median_max"])
        extra.append({k: v for k, v in row.items() if not k.endswith("_runs") and "cycles" not in k})
    row = flagship_fused(dev, params, parent)
    extra.append({k: v for k, v in row.items() if not k.endswith("_runs") and "cycles" not in k})
    row = dict(name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
               replaces="monorfs_tpu/slam/fused_pallas.py:621", max_abs_err=err, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               shapes=extra)
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


# ---- phase 3b: the mixture likelihoods -------------------------------------------

# The shapes the mixture likelihood kernel serves, each with the live
# components a filter's maps hold there: name, P, KP, KC, E, live (predicted,
# corrected), timing reps. chap3: chap3-default.cfg (K0 500, 48 slots, MAP
# cap 128), also with every slot live; cli: the command line's default PHDConfig
# (K0 600); bench and flagship: bench.py's (K0 128, 24 slots, MAP cap 48) at
# 200 and at bench_flagship's 100,000 particles.
MIXTURE_SHAPES = [
    ("chap3-P2000-K548-500-E128", 2000, 548, 500, 128, 330, 280, 20),
    ("chap3-P2000-K548-500-E128-all-live", 2000, 548, 500, 128, 548, 500, 20),
    ("chap3-P800-K548-500-E128", 800, 548, 500, 128, 330, 280, 20),
    ("cli-P200-K648-600-E128", 200, 648, 600, 128, 400, 340, 20),
    ("bench-P200-K152-128-E48", 200, 152, 128, 48, 100, 90, 20),
    ("flagship-P100000-K152-128-E48", 100_000, 152, 128, 48, 100, 90, 5),
]
MIXTURE_PLAIN_CHUNK = 20_000  # particles a plain call takes at once ([P, E, K] temporaries)
# The kernel and the plain version give every pair the same score bit for bit
# (csrc/mixture_ll.cu) and add the same terms in other orders: a row's exp
# terms, the valid rows' log-likelihoods and each map's weights. Each order
# moves a sum by a few of its own ulps; 64 float32 ulps (eps 2^-23) of the
# particle's scale, the sum of the magnitudes of every term that enters its
# rest (|row log-likelihoods| of both maps and both expected sizes), bounds
# that with room, and a row or a component dropped or counted twice moves it
# by far more.
MIXTURE_RTOL = 64 * 2.0 ** -23


MIXTURE_DRAWN = 10_000  # particles drawn on the host; a larger P repeats them on the card


def mixture_inputs(seed, p, kp, kc, e, dev, views=True, **kw):
    """mixture_case on the card: (predicted, corrected, jmeans, jvalid) in
    float32; jmeans as views of one [P, E, 3] tensor (the weight inputs'
    gather) or, with views=False, three contiguous [P, E] tensors. Past
    MIXTURE_DRAWN particles the drawn ones repeat (drawing 100,000 with
    numpy on one host core takes tens of seconds)."""
    pred, cor, jm, jv = mixture_case(seed, min(p, MIXTURE_DRAWN), kp, kc, e, **kw)
    reps = -(-p // MIXTURE_DRAWN)

    def card(x, dtype, axis):  # the particle axis repeated up to p
        x = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
        return torch.cat([x] * reps, dim=axis).narrow(axis, 0, p).contiguous()

    as_sgm = lambda leaves: SGM(*card(leaves, torch.float32, 1).unbind(0))  # noqa: E731
    jm = card(np.moveaxis(jm, 0, -1), torch.float32, 0)  # [P, E, 3]
    jmeans = [jm[..., i] for i in range(3)] if views else [jm[..., i].contiguous() for i in range(3)]
    return as_sgm(pred), as_sgm(cor), jmeans, card(jv, torch.bool, 0)


def mixture_plain(pred, cor, jmeans, jvalid, scale=False):
    """mixture_rest_plain over MIXTURE_PLAIN_CHUNK particles at a time; with
    scale, also each particle's scale (MIXTURE_RTOL)."""
    rest, scales = [], []
    for a in range(0, jvalid.shape[0], MIXTURE_PLAIN_CHUNK):
        cut = slice(a, a + MIXTURE_PLAIN_CHUNK)
        args = (SGM(*[x[cut] for x in pred]), SGM(*[x[cut] for x in cor]), [x[cut] for x in jmeans], jvalid[cut])
        rest.append(mixture_kernel.mixture_rest_plain(*args))
        if scale:
            s = 0.0
            for gm in args[:2]:
                lv = torch.clamp(mixture.log_evaluate_many_soa(gm, args[2]), min=mixture_kernel.LOG_EVAL_FLOOR)
                s = s + torch.where(args[3], lv.abs(), torch.zeros_like(lv)).sum(-1) + mixture.expected_size(gm)
            scales.append(s)
    return (torch.cat(rest), torch.cat(scales)) if scale else torch.cat(rest)


def mixture_check(name, args):
    """The kernel against the plain version on args; returns the largest
    error over the particle's scale (raises past MIXTURE_RTOL)."""
    out = mixture_kernel.mixture_rest(*args)
    ref, scale = mixture_plain(*args, scale=True)
    if out.is_cuda:
        torch.cuda.synchronize()
    rel = ((out - ref).abs() / scale.clamp(min=1.0)).max().item() if out.numel() else 0.0
    if not (torch.isfinite(out).all() and rel <= MIXTURE_RTOL):
        raise AssertionError(f"mixture kernel differs from plain on {name}: {rel} of the scale "
                             f"(limit {MIXTURE_RTOL})")
    return rel


def mixture_phase(dev):
    """The mixture likelihood kernel against mixture_rest_plain: the edge
    cases (kernel_cases.MIXTURE_EDGES; more live components than a tile
    walks two tiles), contiguous and strided MAP means giving equal
    results, two launches equal; then at each of MIXTURE_SHAPES its device
    time, the wrapper's wall time, the plain version's time and the bound.
    The wrapper raises on float64. Returns the kernel table's row."""
    edges = {}
    for i, (name, (p, kp, kc, e, kw)) in enumerate(MIXTURE_EDGES.items()):
        edges[name] = mixture_check(name, mixture_inputs(80 + i, p, kp, kc, e, dev, views=False, **kw))
    strided = mixture_inputs(90, 800, 548, 500, 128, dev, live_p=330, live_c=280)
    contiguous = (*strided[:2], [x.contiguous() for x in strided[2]], strided[3])
    once = mixture_kernel.mixture_rest(*strided)
    if not (torch.equal(once, mixture_kernel.mixture_rest(*contiguous))
            and torch.equal(once, mixture_kernel.mixture_rest(*strided))):
        raise AssertionError("the mixture kernel's result moved with the MAP means' strides or between launches")
    try:
        mixture_kernel.mixture_rest(*[SGM(*[x.double() for x in m]) for m in strided[:2]],
                                    [x.double() for x in strided[2]], strided[3])
    except ValueError:
        pass
    else:
        raise AssertionError("the mixture kernel's wrapper took float64 maps")
    say("mixture-check", max_rel_err=edges, rtol=MIXTURE_RTOL, equal_strided_contiguous=True,
        equal_twice=True, float64_raises=True)
    rows = []
    for i, (name, p, kp, kc, e, live_p, live_c, reps) in enumerate(MIXTURE_SHAPES):
        args = mixture_inputs(100 + i, p, kp, kc, e, dev, live_p=live_p, live_c=live_c)
        rel = mixture_check(name, args)
        ms = kernel_ms(lambda: mixture_kernel.mixture_rest(*args), reps, MIXTURE_KERNEL)
        bms, by = mixture_bound(*args)
        row = dict(case=name, shape=dict(P=p, KP=kp, KC=kc, E=e, live=[live_p, live_c],
                                         valid_rows_mean=args[3].sum(1).double().mean().item()),
                   max_rel_err=rel, ms=ms, wrapper_ms=wall_ms(lambda: mixture_kernel.mixture_rest(*args), reps),
                   plain_ms=cuda_ms(lambda: mixture_plain(*args), 2), bound_ms=bms, bound_by=by,
                   smem_bytes=mixture_kernel.smem_bytes(max(kp, kc), e))
        say("mixture-shape", **row)
        rows.append(row)
    head = rows[0]
    return dict(name="mixture_ll", route="cuda", source="monorfs_tpu_torch/csrc/mixture_ll.cu",
                replaces="none (XLA in the JAX package: monorfs_tpu/slam/phd.py's weight inputs)",
                max_abs_err=None, max_rel_err=max([r["max_rel_err"] for r in rows] + list(edges.values())),
                ms=head["ms"], wrapper_ms=head["wrapper_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=None, shapes=rows)


# ---- phase 3c: the association options -------------------------------------------

# The shapes the association kernel serves: name, model, P, E, slots, live
# slots, beam_meas_cap, C, timing reps. chap3: chap3-default.cfg (MAP cap 128,
# 48 slots, C 8) at 2000 and 800 particles; flagship: experiments/configs/
# flagship.cfg (MAP cap 48, 48 slots cut to 24, C 6) at 100,000; bench:
# bench.py's (24 compacted slots); cli3d and the linear worlds: the command
# line's default PHDConfig (MAP cap 128, C 8) at 200 particles.
ASSOC_SHAPES = [
    ("chap3-P2000-E128-M48-C8", "PRM3D", 2000, 128, 48, 40, 0, 8, 20),
    ("flagship-P100000-E48-M24-C6", "PRM3D", 100_000, 48, 48, 41, 24, 6, 5),
    ("chap3-P800-E128-M48-C8", "PRM3D", 800, 128, 48, 40, 0, 8, 20),
    ("bench-P200-E48-M24-C6", "PRM3D", 200, 48, 24, 20, 24, 6, 20),
    ("cli3d-P200-E128-M48-C8", "PRM3D", 200, 128, 48, 40, 0, 8, 20),
    ("lin2d-P200-E128-M33-C8", "Linear2D", 200, 128, 33, 26, 0, 8, 20),
    ("lin1d-P200-E128-M20-C8", "Linear1D", 200, 128, 20, 13, 0, 8, 20),
]
ASSOC_DRAWN = 10_000  # particles drawn on the host; a larger P repeats them on the card
# base: the kernel adds the E valid rows' log miss in landmark order, the
# plain version's torch.sum in its own order. Every term is <= 0, so each
# order lies within (E - 1) float32 rounding units (2^-24) of |base| of the
# exact sum, and the two within E * 2^-23 * |base| of each other; a row
# dropped or counted twice moves base by a whole term, ~0.1 or more.
ASSOC_BASE_ULPS = 2.0 ** -23


def assoc_inputs(seed, mname, p, e, mz, n_live, cap, c, dev, **kw):
    """assoc_case on the card: (model, cfg, params, pose, jmeans, jvalid, z,
    z_mask) in float32, jmeans as views of one [P, E, 3] tensor (the weight
    inputs' gather); past ASSOC_DRAWN particles the drawn ones repeat."""
    pose, jm, jv, z, zm = assoc_case(seed, min(p, ASSOC_DRAWN), e, mz, n_live, model=mname, **kw)
    reps = -(-p // ASSOC_DRAWN)

    def card(x, dtype):  # the particle axis repeated up to p
        x = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
        return torch.cat([x] * reps).narrow(0, 0, p).contiguous()

    jm = card(np.moveaxis(jm, 0, -1), torch.float32)  # [P, E, 3]
    cfg = PHDConfig(num_particles=p, estimate_cap=e, max_measurements=mz, beam_meas_cap=cap, beam_candidates=c)
    return (get_model(mname), cfg, model_phd_params(mname, dev), card(pose, torch.float32),
            [jm[..., i] for i in range(3)], card(jv, torch.bool),
            torch.as_tensor(z, dtype=torch.float32, device=dev), torch.as_tensor(zm, device=dev))


def assoc_check(name, args, packed=None):
    """The kernel against the plain version on args: opt_delta, word_k and
    bit_k bit for bit, base within E * ASSOC_BASE_ULPS of its size (NaN
    where the plain version's is); returns the largest base gap over that
    limit's scale."""
    out = assoc_kernel.assoc_options(*args, packed)
    ref = assoc_kernel.assoc_options_plain(*args)
    torch.cuda.synchronize()
    for what, a, b in zip(("opt_delta", "word_k", "bit_k"), out[1:], ref[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"association kernel differs from plain on {name}: {what}, "
                                 f"{int((a != b).sum().item())} of {a.numel()} entries")
    e = args[5].shape[1]
    base, want = out[0], ref[0]
    if not torch.equal(torch.isnan(base), torch.isnan(want)):
        raise AssertionError(f"association kernel's base differs from plain on {name}: NaN rows")
    ok = ~torch.isnan(want)
    gap = (base[ok] - want[ok]).abs()
    scale = e * ASSOC_BASE_ULPS * want[ok].abs()
    rel = (gap / scale.clamp(min=1e-30)).max().item() if gap.numel() else 0.0
    if not (gap <= scale).all():
        raise AssertionError(f"association kernel's base differs from plain on {name}: "
                             f"{gap.max().item()} (limit E * 2^-23 * |base|)")
    return rel


def assoc_phase(dev):
    """The association kernel against assoc_options_plain: the edge cases
    (kernel_cases.ASSOC_CASES: ties, no gated pair, no valid MAP row, every
    slot dead, C past 8, E below C, the three families), strided and
    contiguous MAP means and two launches giving equal results, the
    parameter vector packed by the caller and by the wrapper equal; the
    wrapper raising on float64; then at each of ASSOC_SHAPES its device
    time, the wrapper's wall time, the plain version's time and the bound.
    Returns the kernel table's row."""
    edges = {}
    for i, (name, (mname, p, e, mz, n_live, cap, c, kw)) in enumerate(ASSOC_CASES.items()):
        edges[name] = assoc_check(name, assoc_inputs(60 + i, mname, p, e, mz, n_live, cap, c, dev, **kw))
    args = assoc_inputs(70, "PRM3D", 800, 128, 48, 40, 0, 8, dev)
    contiguous = (*args[:4], [x.contiguous() for x in args[4]], *args[5:])
    packed = assoc_kernel.pack_params(args[0], args[2])
    once = assoc_kernel.assoc_options(*args)
    for other in (assoc_kernel.assoc_options(*contiguous), assoc_kernel.assoc_options(*args, packed)):
        if not all(torch.equal(a, b) for a, b in zip(once, other)):
            raise AssertionError("the association kernel's result moved with the MAP means' strides, "
                                 "the packed vector or between launches")
    try:
        assoc_kernel.assoc_options(*args[:3], args[3].double(), *args[4:])
    except ValueError:
        pass
    else:
        raise AssertionError("the association kernel's wrapper took float64 poses")
    say("assoc-check", max_base_rel_err=edges, base_limit="E * 2^-23 * |base|", equal_strided_contiguous=True,
        equal_twice=True, float64_raises=True)
    rows = []
    for i, (name, mname, p, e, mz, n_live, cap, c, reps) in enumerate(ASSOC_SHAPES):
        args = assoc_inputs(80 + i, mname, p, e, mz, n_live, cap, c, dev)
        model = args[0]
        packed = assoc_kernel.pack_params(model, args[2])
        rel = assoc_check(name, args, packed)
        m = min(cap or mz, mz)
        # the wrapper allocates its four outputs and nothing of size [P, E, M]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        outs = assoc_kernel.assoc_options(*args, packed)
        torch.cuda.synchronize()
        alloc = torch.cuda.max_memory_allocated(dev) - before
        out_bytes = sum(x.numel() * x.element_size() for x in outs)
        del outs
        if alloc > out_bytes + 2**20:
            raise AssertionError(f"the association kernel's call on {name} allocated {alloc} bytes, "
                                 f"its outputs {out_bytes}")
        ms = kernel_ms(lambda: assoc_kernel.assoc_options(*args, packed), reps, ASSOC_KERNEL)
        bms, by = assoc_bound(p, e, m, mz, c, model.meas_dim, model.pose.state_dim, min(n_live, m))
        row = dict(case=name, shape=dict(P=p, E=e, M=m, slots=mz, live=n_live, C=c, model=mname),
                   max_base_rel_err=rel, call_alloc_bytes=alloc, output_bytes=out_bytes, ms=ms,
                   wrapper_ms=wall_ms(lambda: assoc_kernel.assoc_options(*args, packed), reps),
                   plain_ms=cuda_ms(lambda: assoc_kernel.assoc_options_plain(*args), 2), bound_ms=bms, bound_by=by,
                   particles_per_block=assoc_kernel.particles_per_block(e, m, mz, model.meas_dim),
                   smem_bytes=assoc_kernel.smem_bytes(e, m, mz, model.meas_dim))
        say("assoc-shape", **row)
        rows.append(row)
    head = rows[0]
    return dict(name="assoc_options", route="cuda", source="monorfs_tpu_torch/csrc/assoc_options.cu",
                replaces="none (XLA in the JAX package: monorfs_tpu/slam/phd.py's weight inputs)",
                max_abs_err=0.0, max_base_rel_err=max([r["max_base_rel_err"] for r in rows] + list(edges.values())),
                ms=head["ms"], wrapper_ms=head["wrapper_ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=None, shapes=rows)


def reset_launches():
    beam_kernel.beam_scan_batch.launches = 0
    fused_kernel.fused_stage.launches = 0
    mixture_kernel.mixture_rest.launches = 0
    assoc_kernel.assoc_options.launches = 0


def read_launches():
    return {"beam_scan": beam_kernel.beam_scan_batch.launches,
            "fused_stage": fused_kernel.fused_stage.launches,
            "mixture_ll": mixture_kernel.mixture_rest.launches,
            "assoc_options": assoc_kernel.assoc_options.launches}


def bench_phase(dev, kernels):
    """Phase 4: the bench path, both kernels once per frame, ATE under its limit."""
    reset_launches()
    result = run_bench(frames=BENCH_FRAMES, device=dev)
    launches = read_launches()
    frames_run = 2 * result["frames"]  # warm-up run + timed run
    for name, n in launches.items():
        if n != frames_run:
            raise AssertionError(f"{name} launched {n} times over {frames_run} frames")
    if not np.isfinite(result["ate_rmse_loc"]) or result["ate_rmse_loc"] >= ATE_LIMIT:
        raise AssertionError(f"ATE {result['ate_rmse_loc']} not below {ATE_LIMIT}")
    say("main-path", **result, launches=launches)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {"bench": launches[k["name"]]}


# ---- phase 13: the simulated vehicle as one CUDA graph ------------------------------

VEHICLE_WORLDS = {"PRM3D": ("sim3d.world", "mov3d.in"), "Linear2D": ("linear2d.world", "mov2d.in"),
                  "Linear1D": ("linear1d.world", "mov1d.in")}
VEHICLE_FRAMES = 300  # each command file repeated to this many frames
VEHICLE_LAG_CYCLES = 2_000_000  # ~1 ms of device clock a frame, so the host runs ahead
VEHICLE_BUDGET_S = 30.0  # the phase's share of the script's time, printed beside its seconds


def vehicle_sim(name, dev, frames=VEHICLE_FRAMES, **kw):
    world_file, command_file = VEHICLE_WORLDS[name]
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    commands = parse_commands((assets / command_file).read_text())
    commands = (commands * (1 + frames // len(commands)))[:frames]
    cfg = Config()
    cfg.set_model_defaults(name)
    return Simulation(cfg, World.from_file(assets / world_file), commands, algorithm="odometry",
                      dtype=np.float32, seed=5, device=dev, **kw), commands


def vehicle_turns(name, dev):
    """Eager update + measure and a vehicle_mod.FrameRunner over the same
    VEHICLE_FRAMES frames in turns (eager, graph, graph, eager): every output
    of every frame bit-equal, each frame's outputs held to the end (so none
    is a buffer a later replay rewrites); host ms a frame of each side (the
    loop before its closing synchronise) and the syncs a frame."""
    sim, commands = vehicle_sim(name, dev)
    model, params, odo = sim.model, sim.vparams, sim.model.pose.odo_dim
    draws = [sim.draws.frame(i) for i in range(len(commands))]

    def eager():
        state, out = sim.vstate, []
        for cmd, d in zip(commands, draws):
            state, noisy = vehicle_mod.update(model, params, state, sim._tensor(cmd[:odo]), d["odo_normals"])
            out.append((state.pose, noisy) + vehicle_mod.measure(
                model, params, state, d["detect_u"], d["meas_normals"], d["clutter_draw"], d["clutter_u"],
                sim.max_clutter))
        return out

    runner = vehicle_mod.FrameRunner(model, params, sim.vstate, draws[0], sim.max_clutter)

    def graph():
        pose, out = sim.vstate.pose, []
        for cmd, d in zip(commands, draws):
            out.append(runner(pose, cmd[:odo], d))
            pose = out[-1][0]
        return out

    outs, host_ms = {}, {"eager": [], "graph": []}
    for side, fn in (("eager", eager), ("graph", graph), ("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[side] = fn()
        host_ms[side].append((time.perf_counter() - t0) * 1e3 / len(commands))
        torch.cuda.synchronize()
    fields = ("pose", "noisy", "z", "mask", "labels", "visible", "detected")
    for f, (a, b) in enumerate(zip(outs["eager"], outs["graph"], strict=True)):
        for field, x, y in zip(fields, a, b, strict=True):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"vehicle {name} frame {f}: the graph's {field} differs from the eager one")
    syncs = {side: count_syncs(fn, len(commands))[0] for side, fn in (("eager", eager), ("graph", graph))}
    detected = sum(int(o[3].sum()) for o in outs["graph"])
    say("vehicle", model=name, frames=len(commands), bit_equal=True, measurements=detected,
        host_ms_per_frame_eager=host_ms["eager"], host_ms_per_frame_graph=host_ms["graph"],
        syncs_per_frame_eager=syncs["eager"], syncs_per_frame_graph=syncs["graph"])


def vehicle_phase(dev):
    """Phase 13: the simulated vehicle's frame as one CUDA graph."""
    t0 = time.perf_counter()
    for name in VEHICLE_WORLDS:
        vehicle_turns(name, dev)

    # the pinned reading's guard: without the history nothing makes the host
    # wait, and a sleeping kernel a frame keeps the device behind it
    hist, commands = vehicle_sim("PRM3D", dev)
    free, _ = vehicle_sim("PRM3D", dev, collect_history=False)
    poses = []
    for cmd in commands:
        hist.step(cmd)
        free.step(cmd)
        torch.cuda._sleep(VEHICLE_LAG_CYCLES)
        poses.append(free.vstate.pose)
    got = torch.stack(poses).cpu().numpy()
    want = np.stack([p for _, p in hist.waypoints])
    if not np.array_equal(got, want):
        raise AssertionError("the run without history moved the vehicle otherwise: the staged reading raced")
    counts = [(s.vehicle_captures, s.vehicle_replays) for s in (hist, free)]
    if counts != [(1, len(commands))] * 2:
        raise AssertionError(f"captures and replays {counts} for {len(commands)} frames")

    # a replay of that recording runs no vehicle, so no graph
    with tempfile.TemporaryDirectory() as tmp:
        hist.save(pathlib.Path(tmp) / "v.zip")
        rec = Recording.load(pathlib.Path(tmp) / "v.zip")
    replay = Simulation(hist.cfg, rec.world, [], algorithm="odometry", dtype=np.float32, device=dev,
                        replay=rec).run()
    if replay.vehicle_captures or replay.vehicle_replays or replay._vehicle_runner is not None:
        raise AssertionError("a replayed run built the vehicle's graph")

    # a runner built and replayed under the profiler, as a traced slice that
    # starts a sequence would: the same outputs, and the kernels it records
    sim, commands = vehicle_sim("PRM3D", dev, frames=10)
    model, params, odo = sim.model, sim.vparams, sim.model.pose.odo_dim
    draws = [sim.draws.frame(i) for i in range(len(commands))]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        runner = vehicle_mod.FrameRunner(model, params, sim.vstate, draws[0], sim.max_clutter)
        first = runner(sim.vstate.pose, commands[0][:odo], draws[0])
        torch.cuda.synchronize()
    state, noisy = vehicle_mod.update(model, params, sim.vstate, sim._tensor(commands[0][:odo]),
                                      draws[0]["odo_normals"])
    want = (state.pose, noisy) + vehicle_mod.measure(
        model, params, state, draws[0]["detect_u"], draws[0]["meas_normals"], draws[0]["clutter_draw"],
        draws[0]["clutter_u"], sim.max_clutter)
    if not all(torch.equal(a, b) for a, b in zip(first, want, strict=True)):
        raise AssertionError("a graph captured under the profiler differs from the eager frame")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pose = first[0]
        for cmd, d in zip(commands[1:], draws[1:]):
            pose = runner(pose, cmd[:odo], d)[0]
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    seconds = time.perf_counter() - t0
    say("vehicle-phase", history_free_equal=True, captures_replays=counts, replay_path_replays=0,
        profiled_capture_equal=True, device_events_per_frame=len(device) / (len(commands) - 1),
        kernel_events_per_frame=len(kernels) / (len(commands) - 1), phase_seconds=seconds,
        budget_s=VEHICLE_BUDGET_S, within_budget=seconds <= VEHICLE_BUDGET_S)


# ---- phase 6: the command-line path ----------------------------------------------

# Limits on what postanalysis prints for each run, and where they come from.
# 3D trajectory: the bench limit above. Maps of the 3D world:
# tests/test_simulation.py:81 of the JAX package (mapping OSPA below 0.25).
# Linear worlds' trajectories: tests/test_simulation.py:97 (SLAM ATE below 0.6).
# Linear worlds' maps: the JAX package's own command (`python -m monorfs_tpu.cli
# -f assets/<world> -c assets/<commands> -a phd -p 30 --dtype float64`, on a
# CPU, seed 0) gave ATE 0.141286 and OSPA 0.547023 on linear2d and ATE 0.241264
# and OSPA 0.764199 on linear1d; the limits sit just above those. OSPA's cutoff
# is 1, so a run without a map (odometry) reads exactly 1.
CLI_RUNS = [
    # name, arguments after -f/-c, frames, (fused, beam) launches per frame, ATE limit, OSPA limit
    ("3d-slam", ["sim3d.world", "mov3d.in"], ["-a", "phd", "-p", "200"], 300, (1, 1), 0.03, 0.25),
    ("2d-slam", ["linear2d.world", "mov2d.in"], ["-a", "phd", "-p", "200"], 270, (1, 1), 0.6, 0.6),
    ("1d-slam", ["linear1d.world", "mov1d.in"], ["-a", "phd", "-p", "200"], 200, (1, 1), 0.6, 0.8),
    ("3d-mapping", ["sim3d.world", "mov3d.in"], ["-a", "phd", "-y", "-p", "1"], 300, (1, 0), 1e-6, 0.25),
    ("2d-float64", ["linear2d.world", "mov2d.in"],
     ["-a", "phd", "-p", "200", "--dtype", "float64", "--frames", "30"], 30, (0, 0), 0.6, 1.0),
]


CLI180_LANDMARKS, CLI180_FRAMES = 180, 60


def printed_number(text, label):
    for line in text.splitlines():
        if line.startswith(label):
            return float(line.split(":")[1])
    raise AssertionError(f"postanalysis printed no '{label}' line:\n{text}")


def run_cli(name, argv, frames, per_frame, ate_limit, ospa_limit, record):
    """cli.main then postanalysis.main on its recording, as a user runs
    them; returns the row printed for the run."""
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv + ["-r", str(record)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    # the mixture likelihoods run once a SLAM frame, as the beam does; the
    # association options once a SLAM frame where the fused stage runs (no
    # depth model, float32)
    want = {"fused_stage": per_frame[0] * frames, "beam_scan": per_frame[1] * frames,
            "mixture_ll": per_frame[1] * frames, "assoc_options": per_frame[0] * per_frame[1] * frames}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    with contextlib.redirect_stdout(out):
        postanalysis.main(["-f", str(record)])
    text = out.getvalue()
    ate = printed_number(text, "ATE loc RMSE")
    ospa = printed_number(text, "final OSPA")
    rec = Recording.load(record)
    if len(rec.trajectory) != frames or len(rec.estimate) != frames or len(rec.maps) != frames:
        raise AssertionError(f"{name}: recording holds {len(rec.trajectory)} frames, not {frames}")
    if not (np.isfinite(ate) and (ate_limit is None or ate <= ate_limit)
            and np.isfinite(ospa) and ospa <= ospa_limit):
        raise AssertionError(f"{name}: ATE {ate} (limit {ate_limit}), OSPA {ospa} (limit {ospa_limit})")
    row = dict(run=name, frames=frames, seconds=seconds, ms_per_frame=seconds * 1e3 / frames,
               ate=ate, ate_limit=ate_limit, ospa=ospa, ospa_limit=ospa_limit, launches=launches,
               kernels_on_path=("none: dead reckoning runs no filter" if "odometry" in argv else
                                "none: the graph backend has no hand-written kernel" if "isam2" in argv else
                                "none: float64 takes the XLA-semantics functions and the plain beam"
                                if per_frame == (0, 0) else
                                "fused only: mapping-only weighs no particle" if per_frame == (1, 0) else
                                "mixture likelihoods and beam: the Kinect model's depth occlusion keeps the "
                                "fused and association kernels off" if per_frame == (0, 1) else
                                "fused, mixture likelihoods, association options and beam"))
    say("cli-run", **row)
    return row, rec, launches


def cli_phase(dev, kernels, tmp):
    """Phase 6: the command line's own entry on every asset family, then
    postanalysis on each recording (written under `tmp`); launch counts,
    error limits and the odometry replay against the recorded odometry
    integrated."""
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    total = dict.fromkeys(KERNEL_NAMES, 0)
    for name, files, flags, frames, per_frame, ate_limit, ospa_limit in CLI_RUNS:
        argv = ["-f", str(assets / files[0]), "-c", str(assets / files[1])] + flags
        _, _, launches = run_cli(name, argv, frames, per_frame, ate_limit, ospa_limit,
                                 tmp / f"{name}.zip")
        for k, n in launches.items():
            total[k] += n
    # a 3D world of CLI180_LANDMARKS landmarks (sim3d.world's 40 and seeded
    # ones inside their bounding box): 188 measurement slots at the default
    # MaxQuantity of 600, and a beam of 188 steps; cut to CLI180_FRAMES
    world = World.from_file(assets / "sim3d.world")
    lm = np.asarray(world.landmarks)
    more = np.random.default_rng(CLI180_LANDMARKS).uniform(lm.min(0), lm.max(0), (CLI180_LANDMARKS - len(lm), 3))
    (tmp / "sim3d-180.world").write_text(World(world.pose, np.concatenate([lm, more]),
                                               world.measurer_params).serialize())
    _, _, launches = run_cli("3d-slam-180-landmarks",
                             ["-f", str(tmp / "sim3d-180.world"), "-c", str(assets / "mov3d.in"), "-a", "phd",
                              "-p", "200", "--frames", str(CLI180_FRAMES)],
                             CLI180_FRAMES, (1, 1), *CLI_RUNS[0][-2:], tmp / "3d-180.zip")  # the 3D run's limits
    say("cli-180", landmarks=CLI180_LANDMARKS, measurement_slots=CLI180_LANDMARKS + 8, frames=CLI180_FRAMES)
    for k, n in launches.items():
        total[k] += n
    # replay the 3D recording through dead reckoning: its trajectory is the
    # recorded odometry integrated from the first pose
    _, rec, _ = run_cli("3d-replay-odometry", ["-f", str(tmp / "3d-slam.zip"), "-i", "record",
                                               "-a", "odometry"], 300, (0, 0), None, 1.0,
                        tmp / "3d-odometry.zip")
    src = Recording.load(tmp / "3d-slam.zip")
    pose = torch.as_tensor(src.world.pose, dtype=torch.float64)
    worst = 0.0
    for (_, odo), (_, est) in zip(src.odometry, rec.estimate[-1][1]):
        pose = PRM3D.pose.add_odometry(pose, torch.as_tensor(odo, dtype=torch.float64))
        worst = max(worst, float(np.abs(pose.numpy() - est).max()))
    if worst > 1e-4:  # float32 steps and the recording's 6 significant digits
        raise AssertionError(f"odometry replay is {worst} off the recorded odometry integrated")
    say("cli-replay", max_abs_difference=worst, tolerance=1e-4)
    for k in kernels:  # each path's count was read with the counters set to 0 before it
        k["launches"] = k.get("launches", 0) + total[k["name"]]
        k.setdefault("launches_by_path", {})["cli"] = total[k["name"]]


# ---- phase 7: the graph backend --------------------------------------------------

# Limits of the 3D `-a isam2` runs: no worse than twice what the JAX package's
# own run of the same command gives on a CPU in float64 (seed 0, x64 enabled):
#   python -m monorfs_tpu.cli -f assets/sim3d.world -c assets/mov3d.in -a isam2 --dtype float64
#     -> ATE loc RMSE 0.00465604, final OSPA 0.00508514, 40 landmarks.
# (tests/test_graph.py:145-178 holds the JAX navigator to 0.05 in pose and
# landmark position on its own small world.) The replay of the PHD recording
# sees the same world through other noise: the same limits.
# The 2D world is held to phase 6's limits for it. The JAX package's run of
#   python -m monorfs_tpu.cli -f assets/linear2d.world -c assets/mov2d.in -a isam2 --dtype float64
# gives ATE 0.106666, OSPA 0.106264 and 25 landmarks, and the port's navigator
# gives exactly these over that recording (-i record), but on this world the
# result hangs on the noise drawn: the port's own CPU runs with seeds 0 to 4
# give ATE 0.48, 0.68, 0.064, 0.071, 0.072 and OSPA 0.60, 0.63, 0.039, 0.049,
# 0.091, so twice one run's value is no bound for another seed's draws.
# The scan runners work in float32 on their own draws: the 3D trajectory
# limit of phase 6 for the known-label scan; for the Mahalanobis scan the JAX
# package's own test bounds (tests/test_isam2_scan_da.py: ATE below 0.08, at
# most 6 landmarks beyond the world's) and phase 6's 3D map limit.
ISAM2_3D = (2 * 0.00465604, 2 * 0.00508514)
# The repeat of the 3D command, cut to its first REPEAT_FRAMES frames: the
# trajectory under the whole run's ATE limit; the map then holds only the
# landmarks seen so far, so its OSPA is held under the cutoff of 1 only.
REPEAT_FRAMES = 100
ISAM2_3D_CUT = (ISAM2_3D[0], 0.9)
ISAM2_2D = (0.6, 0.6)
# Mapping-only pins every pose: ATE exactly 0. With all poses pinned the
# navigator of both packages stops minting landmarks early on this world (a
# 60-frame CPU run of the port maps 18 of the 40, OSPA 0.561757, and the JAX
# package's replay of that recording gives the same 18 and 0.561757), so the
# map is only required to be non-empty and under the OSPA cutoff of 1.
ISAM2_MAPPING = (1e-6, 0.9)
SCAN_ATE, SCAN_DA_ATE, SCAN_DA_OSPA, SCAN_DA_EXTRA = 0.03, 0.08, 0.25, 6
SYNC_FRAMES = 20


def run_bench_isam2(argv):
    """bench_isam2.main as a user runs it; returns its detail line."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        bench_isam2.main(argv)
    headline = json.loads(out.getvalue().strip().splitlines()[-1])
    detail = json.loads(err.getvalue().strip().splitlines()[-1])["detail"]
    if headline["value"] != detail["fps"] or not np.isfinite(detail["fps"]):
        raise AssertionError(f"bench_isam2 {argv}: headline {headline} against detail {detail}")
    return detail


def graph_sync_counts(dev):
    """Host synchronisations per frame over SYNC_FRAMES frames of the
    navigator (after 10 frames) and of each scan runner at its 300-frame
    capacity, beside what the code counts itself."""
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    world = World.from_file(assets / "sim3d.world")
    commands = parse_commands((assets / "mov3d.in").read_text())
    sim = Simulation(Config(), world, commands, algorithm="isam2", particles=1, device=dev)
    for cmd in commands[:10]:
        sim.step(cmd)
    nav = sim.isam2
    reads0, uploads0, graph.counts["cholesky"] = nav.reads, nav.uploads, 0

    def nav_frames():
        for cmd in commands[10 : 10 + SYNC_FRAMES]:
            sim.step(cmd)

    per_frame, where = count_syncs(nav_frames, SYNC_FRAMES)
    rows = [dict(path="navigator", syncs_per_frame=per_frame,
                 reads_counted_per_frame=(nav.reads - reads0 + graph.counts["cholesky"]) / SYNC_FRAMES,
                 uploads_counted_per_frame=(nav.uploads - uploads0) / SYNC_FRAMES, where=where)]
    _, cmds = bench_isam2.world_and_commands(300, torch.float32, dev)
    for name, build, cfg in (
        ("scan", build_isam2_scan_runner, Config()),
        ("scan-da", build_mahalanobis_scan,
         Config.from_file(assets.parent / "experiments" / "configs" / "chap4-default.cfg")),
    ):
        runner, carry, model = build(cfg, world, 300, device=dev)
        draws = scan_draws(model, cfg, world, 300, device=dev)
        stats = {"iterations": [], "reads": 0}
        kw = dict(stats=stats) if name == "scan-da" else {}
        graph.counts["cholesky"] = 0
        per_frame, where = count_syncs(lambda: runner(carry, cmds[:SYNC_FRAMES], draws, **kw), SYNC_FRAMES)
        rows.append(dict(path=name, syncs_per_frame=per_frame,
                         reads_counted_per_frame=(stats["reads"] + graph.counts["cholesky"]) / SYNC_FRAMES,
                         where=where))
    for row in rows:
        say("graph-syncs", frames=SYNC_FRAMES, **row)


def graph_phase(dev, kernels, tmp):
    """Phase 7: the graph backend through cli.main, postanalysis.main and
    bench_isam2.main."""
    graph.assert_full_precision()
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    world3d = ["-f", str(assets / "sim3d.world"), "-c", str(assets / "mov3d.in")]
    total = dict.fromkeys(KERNEL_NAMES, 0)

    def run(name, argv, frames, limits):
        row, rec, launches = run_cli(name, argv, frames, (0, 0), limits[0], limits[1], tmp / f"{name}.zip")
        for k, n in launches.items():
            total[k] += n
        return row["ate"], row["ospa"], len(rec.maps[-1][1])

    first = run("3d-isam2", world3d + ["-a", "isam2"], 300, ISAM2_3D)
    if abs(first[2] - 40) > SCAN_DA_EXTRA:
        raise AssertionError(f"-a isam2 mapped {first[2]} landmarks of the world's 40")

    source = tmp / "3d-slam.zip"  # phase 6's PHD recording
    if not source.exists():
        source = tmp / "3d-isam2.zip"
    replay = run("3d-replay-isam2", ["-f", str(source), "-i", "record", "-a", "isam2"], 300, ISAM2_3D)
    say("graph-replay", source=source.name, ate=replay[0], ospa=replay[1], landmarks=replay[2])
    # the same 3D command twice, identical, cut to REPEAT_FRAMES for the time limit
    cut = world3d + ["-a", "isam2", "--frames", str(REPEAT_FRAMES)]
    once = run("3d-isam2-cut", cut, REPEAT_FRAMES, ISAM2_3D_CUT)
    again = run("3d-isam2-cut-again", cut, REPEAT_FRAMES, ISAM2_3D_CUT)
    if once != again:
        raise AssertionError(f"two runs of the same -a isam2 command differ: {once} and {again}")
    say("graph-deterministic", world="sim3d", frames=REPEAT_FRAMES, ate=once[0], ospa=once[1],
        landmarks=once[2], identical=True)
    world2d = ["-f", str(assets / "linear2d.world"), "-c", str(assets / "mov2d.in"), "-a", "isam2"]
    run("2d-isam2", world2d, 270, ISAM2_2D)
    mapping = run("3d-isam2-mapping", world3d + ["-a", "isam2", "-y", "--frames", "60"], 60, ISAM2_MAPPING)
    if mapping[2] == 0:
        raise AssertionError("-a isam2 -y mapped no landmark")
    say("graph-mapping", ate=mapping[0], ospa=mapping[1], landmarks=mapping[2])

    reset_launches()
    scan = run_bench_isam2(["--scan"])
    if not (scan["frames"] == 300 and scan["ate_rmse_loc"] < SCAN_ATE and scan["final_landmarks"] == 40):
        raise AssertionError(f"bench_isam2 --scan: {scan}")
    say("graph-scan", **scan, ate_limit=SCAN_ATE)
    da = run_bench_isam2(["--scan-da", "--variant", "default"])
    if not (da["frames"] == 300 and da["ate_rmse_loc"] < SCAN_DA_ATE and da["final_ospa"] < SCAN_DA_OSPA
            and abs(da["final_landmarks"] - 40) <= SCAN_DA_EXTRA):
        raise AssertionError(f"bench_isam2 --scan-da: {da}")
    say("graph-scan-da", **da, ate_limit=SCAN_DA_ATE, ospa_limit=SCAN_DA_OSPA)
    graph_sync_counts(dev)
    for k, n in read_launches().items():
        total[k] += n
    if any(total.values()):
        raise AssertionError(f"the graph path launched a PHD kernel: {total}")
    graph.assert_full_precision()
    for k in kernels:
        k.setdefault("launches", 0)
        k.setdefault("launches_by_path", {})["graph"] = 0


# ---- phase 8: the smoother --------------------------------------------------------

# Limits of the chap5 s2 smoother run: twice the JAX package's ATE and its OSPA
# + 0.1, from its own CPU run of the same three commands (float32, seed 0):
#   python -m monorfs_tpu.cli -f assets/linear2d.world -c assets/mov2d.in -a phd -p 50
#       -g experiments/configs/chap5-default2d.cfg -r phd.zip   (ATE 0.21316, OSPA 0.403826)
#   python -m monorfs_tpu.cli -f phd.zip -i record -a odometry -g <same cfg> -r odo.zip
#       (ATE 0.629969, OSPA 1)
#   python -m monorfs_tpu.cli -f odo.zip -i record -a loopy -g <same cfg> -r loopy.zip
#       -> ATE loc RMSE 0.251138, final OSPA 0.475211 (74 s on the CPU).
# The port's PHD run draws other noise, so its recording and smoother result
# differ; the limits bound the algorithm, not the draws.
LOOPY_2D = (2 * 0.251138, 0.475211 + 0.1)
# Over the JAX package's own odometry recording (the second command's
# recording, committed as tests/data/chap5_s2_odometry_jax.zip) the port must
# give the JAX result itself, 0.251138 / 0.475211, within what float32 sums in
# another order and a line-search near-tie can move (about 2e-5 in PR 5's two
# runs; tests/test_torch_loopy_parity.py holds the first nodes to 1e-6 in
# float64).
LOOPY_JAX = (0.251138, 0.475211)
LOOPY_JAX_TOL = (0.01, 0.02)
JAX_S2_RECORDING = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "chap5_s2_odometry_jax.zip"
# The 3D run smooths a PHD recording of the 3D asset world by the same rule;
# the JAX package's CPU run (float32, seed 0):
#   python -m monorfs_tpu.cli -f assets/sim3d.world -c assets/mov3d.in -a phd -p 200 -r phd3d.zip
#       (ATE 0.00868911, OSPA 0.0846579; 529 s on the CPU)
#   python -m monorfs_tpu.cli -f phd3d.zip -i record -a loopy -r loopy3d.zip
#       -> ATE loc RMSE 0.00748151, final OSPA 0.0830064 (181 s).
LOOPY_3D = (2 * 0.00748151, 0.0830064 + 0.1)
# The 3D run is cut to this many seconds (estimated from the s2 run's seconds
# a node; a 3D node costs 2.8 2D nodes, PERF.md section 5: 426 vs 152 ms), so
# that the whole script, the grid phase included, stays within 1000 s.
LOOPY_BUDGET_S = 60.0
LOOPY_3D_NODE_COST = 2.8
CHAP5_CFG = pathlib.Path(__file__).resolve().parent / "experiments" / "configs" / "chap5-default2d.cfg"


def shape_row(kernels, name, row, base):
    """Add a timed shape to kernel `name`'s row (made from `base` when the
    kernels phase did not run)."""
    k = next((k for k in kernels if k["name"] == name), None)
    if k is None:
        k = dict(base, max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None, shapes=[])
        kernels.append(k)
    k["max_abs_err"] = max(k["max_abs_err"], row["max_abs_err"])
    k["shapes"].append(row)


def pass_masks(z_mask, passes):
    """[passes, M] masks as the smoother's cavity passes get them, made
    harder: pass b also drops the slots j % passes == b, and pass 0 drops
    the whole frame (the pass that leaves this frame's block out)."""
    m = z_mask.shape[0]
    iota = torch.arange(m, device=z_mask.device)
    rows = z_mask[None, :] & (iota[None, :] % passes != torch.arange(passes, device=z_mask.device)[:, None])
    rows[0] = False
    return rows


def loopy_kernels(dev, kernels, parent):
    """The two kernels at the smoother's shapes on the 2D (M=33) and 3D
    (M=48) worlds, each against its plain version, timed (the fused kernel
    in turns with the parent)."""
    for name, m, seed in (("loopy-P1056-B32-C8-W1-M33", 33, 17), ("loopy3d-P1536-B32-C8-W1-M48", 48, 19)):
        p, b, c = 32 * m, 32, 8  # J*M seeds of one refit node: jmaps of 32, beam 32 x 8
        inputs, n_words = beam_random(dev, seed, p, 32, m, c)
        beam_check(name, inputs, b, n_words)
        bms, by = beam_bound(inputs, b)
        row = dict(case=name, shape=dict(P=p, M=m, C=c, B=b, n_words=n_words),
                   max_abs_err=0.0, bound_ms=bms, bound_by=by,
                   ms=kernel_ms(lambda: beam_kernel.beam_scan_batch(*inputs, b, n_words), 20, BEAM_KERNEL),
                   plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 3))
        say("beam-shape", **row)
        shape_row(kernels, "beam_scan", row, dict(
            name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
            replaces="monorfs_tpu/slam/beam_pallas.py:178"))

    cases = [  # name, model, M, passes, seed, landmarks
        ("loopy-lin2d-K128-M33-P8-mask-per-particle", "Linear2D", 33, 8, 27, 25),
        ("loopy-lin2d-K128-M33-P1", "Linear2D", 33, 1, 27, 25),
        ("loopy-prm3d-K128-M48-P8-mask-per-particle", "PRM3D", 48, 8, 29, 40),
        ("loopy-prm3d-K128-M48-P1", "PRM3D", 48, 1, 29, 40),
    ]
    for name, mname, m, pp, seed, n_lm in cases:
        model, params = get_model(mname), model_phd_params(mname, dev)
        cfg = PHDConfig(num_particles=pp, max_components=128, max_measurements=m, gate_top=8)
        pose, maps, z, z_mask = warm_state(seed, pp, 128, m, n_lm, dev, model=mname)
        pose = pose[:1].expand(pp, -1).contiguous()  # every pass at one pose, as the smoother snaps them
        if pp > 1:
            z_mask = pass_masks(z_mask, pp)
        args = (model, cfg, params, pose, maps, z, z_mask)
        pred, cor = fused_kernel.fused_stage(*args)
        pred_ref, cor_ref = fused_kernel.fused_stage_plain(*args)
        torch.cuda.synchronize()
        err = compare_fused(pred, cor, pred_ref, cor_ref)
        row = dict(fused_row(name, mname, args, 20, parent, err), mask_shape=list(z_mask.shape))
        say("fused-shape", **row)
        row = {k: v for k, v in row.items() if not k.endswith("_runs") and "cycles" not in k}
        shape_row(kernels, "fused_stage", row, dict(
            name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
            replaces="monorfs_tpu/slam/fused_pallas.py:621"))


def run_loopy_cli(name, argv, limits, record, float32=True):
    """cli.main -a loopy then postanalysis.main, as a user runs them: the
    row, with both kernels' launches over the run (none in float64)."""
    reset_launches()
    cached = set(association._GRAPHS)  # the plain beam's CUDA graphs before the run
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv + ["-r", str(record)])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    with contextlib.redirect_stdout(out):
        postanalysis.main(["-f", str(record)])
    text = out.getvalue()
    ate, ospa = printed_number(text, "ATE loc RMSE"), printed_number(text, "final OSPA")
    frames = len(Recording.load(record).trajectory)
    # the smoother's steps are mapping-only: no weight stage, so no mixture
    # likelihoods and no association options
    smoother = (launches["beam_scan"], launches["fused_stage"])
    if launches["mixture_ll"] or launches["assoc_options"] or not (all(smoother) if float32 else not any(smoother)):
        raise AssertionError(f"{name}: launches {launches} ({'float32' if float32 else 'float64'})")
    if not (np.isfinite(ate) and ate <= limits[0] and np.isfinite(ospa) and ospa <= limits[1]):
        raise AssertionError(f"{name}: ATE {ate} (limit {limits[0]}), OSPA {ospa} (limit {limits[1]})")
    row = dict(run=name, frames=frames, seconds=seconds, ms_per_node=seconds * 1e3 / frames, ate=ate,
               ate_limit=limits[0], ospa=ospa, ospa_limit=limits[1], launches=launches,
               launches_per_node={k: n / frames for k, n in launches.items()},
               beam_graphs_captured=len(set(association._GRAPHS) - cached))
    say("loopy-run", **row)
    return row


def loopy_phase(dev, kernels, tmp):
    """Phase 8: the smoother's command line over the JAX package's s2
    recording (twice), on the port's own chap5 s2 workflow, in float64, and
    on the 3D world (its kernel shapes are checked with phases 2-3, by
    loopy_kernels)."""
    graph.assert_full_precision()
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    cfg = ["-g", str(CHAP5_CFG)]
    with contextlib.redirect_stdout(io.StringIO()):  # the recordings the smoother reads
        cli.main(["-f", str(assets / "linear2d.world"), "-c", str(assets / "mov2d.in"), "-a", "phd",
                  "-p", "50", "-r", str(tmp / "s2-phd.zip")] + cfg)
        cli.main(["-f", str(tmp / "s2-phd.zip"), "-i", "record", "-a", "odometry",
                  "-r", str(tmp / "s2-odo.zip")] + cfg)
    replay = ["-f", str(tmp / "s2-odo.zip"), "-i", "record", "-a", "loopy"] + cfg
    total = dict.fromkeys(KERNEL_NAMES, 0)

    def tally(row):
        for k, n in row["launches"].items():
            total[k] += n
        return row

    # the JAX package's recording: its result within the tolerance, twice
    jax_replay = ["-f", str(JAX_S2_RECORDING), "-i", "record", "-a", "loopy"] + cfg
    jax_limits = tuple(v + tol for v, tol in zip(LOOPY_JAX, LOOPY_JAX_TOL))
    first = tally(run_loopy_cli("s2-jax-recording-loopy", jax_replay, jax_limits, tmp / "s2-jax-loopy.zip"))
    second = tally(run_loopy_cli("s2-jax-recording-loopy-again", jax_replay, jax_limits,
                                 tmp / "s2-jax-loopy-2.zip"))
    gap = (first["ate"] - LOOPY_JAX[0], first["ospa"] - LOOPY_JAX[1])
    if abs(gap[0]) > LOOPY_JAX_TOL[0] or abs(gap[1]) > LOOPY_JAX_TOL[1]:
        raise AssertionError(f"the smoother over the JAX recording gives {first['ate']} / {first['ospa']}, "
                             f"the JAX package {LOOPY_JAX}")
    if (first["ate"], first["ospa"]) != (second["ate"], second["ospa"]):
        raise AssertionError(f"two runs of the same -a loopy command differ: {first} and {second}")
    say("loopy-vs-jax", ate=first["ate"], ospa=first["ospa"], jax=LOOPY_JAX, gap=gap, tolerance=LOOPY_JAX_TOL,
        identical_in_two_runs=True)
    own = tally(run_loopy_cli("s2-loopy", replay, LOOPY_2D, tmp / "s2-loopy.zip"))
    # float64 on the card, cut to a third of the frames (the plain beam and the
    # XLA-semantics filter take most of a run's time): held to the same limits
    tally(run_loopy_cli("s2-loopy-float64-90", replay + ["--dtype", "float64", "--frames", "90"],
                        LOOPY_2D, tmp / "s2-loopy-f64.zip", float32=False))
    graph.assert_full_precision()

    source = tmp / "3d-slam.zip"  # phase 6's PHD recording
    if not source.exists():
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-f", str(assets / "sim3d.world"), "-c", str(assets / "mov3d.in"), "-a", "phd",
                      "-p", "200", "-r", str(source)])
    frames = 300
    per_node_s = own["seconds"] / own["frames"] * LOOPY_3D_NODE_COST
    if per_node_s * frames > LOOPY_BUDGET_S:
        frames = int(LOOPY_BUDGET_S / per_node_s)
        say("loopy-3d-cut", frames=frames, of=300, budget_s=LOOPY_BUDGET_S,
            reason="the whole run's time limit, with phases 9 and 10 added")
    tally(run_loopy_cli("3d-loopy", ["-f", str(source), "-i", "record", "-a", "loopy",
                                     "--frames", str(frames)], LOOPY_3D, tmp / "3d-loopy.zip"))

    nav = loopy_navigator("2d", 10, dev)
    per_node, where = count_syncs(nav.sweep, 10)
    say("loopy-syncs", nodes=10, syncs_per_node=per_node, where=where,
        note="a refit sweep over 10 nodes, its two objective reads included")
    if not (total["beam_scan"] and total["fused_stage"]) or total["mixture_ll"] or total["assoc_options"]:
        raise AssertionError(f"the smoother launched a kernel no time, or a weight-stage kernel: {total}")
    for k in kernels:
        k["launches"] = k.get("launches", 0) + total[k["name"]]
        k.setdefault("launches_by_path", {})["loopy"] = total[k["name"]]


# ---- phase 9: the RGB-D input -------------------------------------------------------

# Limits, from the JAX package's committed results of the same experiments
# (experiments/out/SUMMARY.md, its CPU runs in float64):
#   chap3-k6real isam2 ATE 0.02444 (line 9): twice that;
#   chap4-k9 phd ATE 0.01505, OSPA-vs-reference-map 0.2709 (line 34; 50
#     particles in float64, the JAX package's own run): twice the ATE, the
#     OSPA + 0.1, for this 2000-particle float32 run;
#   chap4-k9 odometry ATE 0.007188 (line 35): dead reckoning over the same
#     numpy-seeded commands draws nothing, so it must equal that to its four
#     digits;
#   chap4-k9 isam2 ATE 0.002547, OSPA 0.131 (line 36): twice the ATE, OSPA + 0.1.
K6_ISAM2_ATE = 2 * 0.02444
K9_PHD = (2 * 0.01505, 0.2709 + 0.1)
K9_ODOMETRY_ATE = 0.007188
K9_ISAM2 = (2 * 0.002547, 0.131 + 0.1)
KINECT_BEAM = dict(P=2000, B=200, C=8, M=64, n_lm=128)  # the default PHDConfig at P=2000, 64 slots
TUM_REAL = pathlib.Path(__file__).resolve().parent / "assets" / "tum_real"


def kinect_beam(dev, kernels):
    """The beam kernel at the Kinect path's shape against its plain version,
    bit for bit, on random and tie-heavy options; timed."""
    p, b, c, m = (KINECT_BEAM[k] for k in ("P", "B", "C", "M"))
    name = f"kinect-P{p}-B{b}-C{c}-W4-M{m}"
    inputs, n_words = beam_random(dev, 31, p, KINECT_BEAM["n_lm"], m, c)
    if n_words != 4:
        raise AssertionError(f"{KINECT_BEAM['n_lm']} landmarks give {n_words} words, not 4")
    beam_check(name, inputs, b, n_words)
    beam_check(name + "-ties", [torch.as_tensor(x, device=dev) for x in beam_ties(33, p, m, c, n_words)],
               b, n_words)
    bms, by = beam_bound(inputs, b)
    row = dict(case=name, shape=dict(P=p, M=m, C=c, B=b, n_words=n_words), max_abs_err=0.0,
               bound_ms=bms, bound_by=by,
               ms=kernel_ms(lambda: beam_kernel.beam_scan_batch(*inputs, b, n_words), 5, BEAM_KERNEL),
               plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 2))
    say("beam-shape", **row)
    shape_row(kernels, "beam_scan", row, dict(
        name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
        replaces="monorfs_tpu/slam/beam_pallas.py:178"))


def same_result(a, b):
    """Two experiment rows agree in everything but their wall seconds."""
    return {k: v for k, v in a.items() if k != "seconds"} == {k: v for k, v in b.items() if k != "seconds"}


def check_sidebar(record, frames, size):
    """The recording's sidebar.avi: one baseline JPEG a frame, SOF0 at `size`."""
    jpegs = read_mjpeg(io.BytesIO(Recording.load(record).sidebar))
    if len(jpegs) != frames:
        raise AssertionError(f"sidebar.avi holds {len(jpegs)} frames, not {frames}")
    for j in jpegs:
        if j[:2] != b"\xff\xd8" or j[-2:] != b"\xff\xd9" or b"\xff\xc0" not in j or jpeg_size(j) != size:
            raise AssertionError(f"sidebar frame: {j[:4].hex()}..{j[-2:].hex()}, size {jpeg_size(j)} not {size}")
    return len(jpegs), sum(map(len, jpegs)) / len(jpegs)


def kinect_phase(dev, kernels, tmp):
    """Phase 9: the RGB-D input through experiments_kinect, profile_step and
    cli.main."""
    graph.assert_full_precision()
    kinect_beam(dev, kernels)
    t0 = time.perf_counter()
    npz = tmp / "seq.npz"
    convert_tum(str(TUM_REAL), str(npz))
    seq = RGBDDataset(npz)
    say("kinect-convert", seconds=time.perf_counter() - t0,
        decoder="native librfsio (build/native)" if native.available() else "pure-Python fallback",
        shapes={k: list(getattr(seq, k).shape) for k in ("time", "depth", "gray")},
        dtypes={k: str(getattr(seq, k).dtype) for k in ("time", "depth", "gray")})
    total = dict.fromkeys(KERNEL_NAMES, 0)

    def counted(fn):
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        for k, n in launches.items():
            total[k] += n
        return out, seconds, launches

    # k6real, twice: float64, no kernel
    runs = [counted(lambda i=i: experiments_kinect.k6real(tmp / f"k6-{i}", dev, torch.float64))
            for i in range(2)]
    (k6, seconds, launches), (k6b, _, _) = runs
    isam2, mapping = k6["isam2"], k6["phd"]
    if any(launches.values()) or not isam2["ate_loc_rmse"] < K6_ISAM2_ATE:
        raise AssertionError(f"k6real isam2: {isam2}, launches {launches}, ATE limit {K6_ISAM2_ATE}")
    if not (same_result(isam2, k6b["isam2"]) and same_result(mapping, k6b["phd"])):
        raise AssertionError(f"two k6real runs differ: {k6} and {k6b}")
    if mapping["frames_with_measurements"] != mapping["frames"] or mapping["map_components"] == 0:
        raise AssertionError(f"k6real phd mapping: {mapping}")
    say("kinect-k6real", **k6, seconds=seconds, ate_limit=K6_ISAM2_ATE, identical_in_two_runs=True)

    # k9 -a phd -p 2000 float32: the beam kernel once a frame, the fused never
    torch.cuda.reset_peak_memory_stats(dev)
    k9, seconds, launches = counted(
        lambda: experiments_kinect.k9(tmp / "k9", 2000, torch.float32, ("phd",), dev))
    peak = torch.cuda.max_memory_allocated(dev)
    row = k9["phd"]
    frames = row["frames"]
    if launches != {"beam_scan": frames, "fused_stage": 0, "mixture_ll": frames, "assoc_options": 0}:
        raise AssertionError(f"k9 phd: launches {launches} over {frames} frames (beam and mixture likelihoods "
                             "once a frame, fused and association options never)")
    if not (row["ate_loc_rmse"] < K9_PHD[0] and row.get("ospa_vs_refmap", 1.0) < K9_PHD[1]):
        raise AssertionError(f"k9 phd: {row}, limits {K9_PHD}")
    again, syncs = None, None

    def second():
        nonlocal again
        again = experiments_kinect.k9(tmp / "k9b", 2000, torch.float32, ("phd",), dev)

    syncs, where = count_syncs(second, 2 * frames)  # the reference map's source sees every frame too
    if not same_result(again["phd"], row):
        raise AssertionError(f"two k9 phd runs differ: {row} and {again['phd']}")
    say("kinect-k9-phd", **row, particles=2000, dtype="float32", call_seconds=seconds,
        ms_per_frame=row["seconds"] * 1e3 / frames, launches=launches, ate_limit=K9_PHD[0],
        ospa_limit=K9_PHD[1], reference_map_landmarks=k9["reference_map_landmarks"],
        peak_device_memory_gb=peak / 2**30, host_syncs_per_source_frame=syncs, sync_sites=where,
        identical_in_two_runs=True,
        note="seconds: the first run's filter alone; call_seconds with conversion and reference map; "
             "host syncs of the second call (48 source frames: the reference map's and the run's)")
    for k in kernels:
        k.setdefault("launches_by_path", {})["kinect-k9-phd"] = launches[k["name"]]

    k9b, seconds, launches = counted(
        lambda: experiments_kinect.k9(tmp / "k9-f64", 50, torch.float64, ("odometry", "isam2"), dev))
    odo, isam2 = k9b["odometry"], k9b["isam2"]
    if any(launches.values()) or round(odo["ate_loc_rmse"], 6) != K9_ODOMETRY_ATE:
        raise AssertionError(f"k9 odometry: {odo} (JAX {K9_ODOMETRY_ATE}), launches {launches}")
    if not (isam2["ate_loc_rmse"] < K9_ISAM2[0] and isam2.get("ospa_vs_refmap", 1.0) < K9_ISAM2[1]):
        raise AssertionError(f"k9 isam2: {isam2}, limits {K9_ISAM2}")
    say("kinect-k9-float64", odometry=odo, isam2=isam2, seconds=seconds, odometry_ate_jax=K9_ODOMETRY_ATE,
        isam2_limits=K9_ISAM2)

    prof = profile_kinect(10, dev)
    say("kinect-profile", **{k: prof[k] for k in ("frames", "wall_ms_per_frame", "device_ms_per_frame",
                                                  "device_idle_share", "device_events_per_frame",
                                                  "stages", "kernels", "shape")})
    reset_launches()  # the profile's launches are not the path's count

    # the command line: the default camera at KinectDelta 4 (a 40 x 30 image)
    delta = Config().kinect_delta
    size = (seq.gray.shape[2] // delta, seq.gray.shape[1] // delta)
    for name, flags, per_frame in (("kinect-isam2", ["-a", "isam2", "--dtype", "float64"], (0, 0)),
                                   ("kinect-phd", ["-a", "phd", "-p", "200"], (0, 1)),
                                   ("kinect-odometry", ["-a", "odometry"], (0, 0))):
        record = tmp / f"{name}.zip"
        _, _, launches = run_cli(name, ["-f", str(npz), "-i", "kinect"] + flags, len(seq), per_frame,
                                 None, 1.0, record)
        for k, n in launches.items():
            total[k] += n
        n, mean_bytes = check_sidebar(record, len(seq), size)
        say("kinect-sidebar", run=name, frames=n, size=list(size), mean_jpeg_bytes=mean_bytes)
    graph.assert_full_precision()
    for k in kernels:
        k["launches"] = k.get("launches", 0) + total[k["name"]]
        k.setdefault("launches_by_path", {})["kinect"] = total[k["name"]]


# ---- phase 10: the experiment grids ---------------------------------------------------

# Limits of run_gpu_grid chap3-s1 (800 particles, float32): twice the JAX
# package's TPU float32 row's ATE and its OSPA + 0.1 (experiments/out-tpu/
# SUMMARY.md: phd ATE 0.02023, OSPA 0.08123), the repo's convention.
GRID_S1 = (2 * 0.02023, 0.08123 + 0.1)
GRID_S1_PARTICLES, GRID_S1_FRAMES = 800, 300
GRID_THROUGHPUT = (200, 2000)  # of run_gpu_grid.throughput's sweep
SCALING_P = 10000  # bench_scaling's largest default count
GRID_BUDGET_S = 150.0  # the phase's share of the script's time, printed beside its seconds
CHAP3_CFG = pathlib.Path(__file__).resolve().parent / "experiments" / "configs" / "chap3-default.cfg"
BEAM_ROW = dict(name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
                replaces="monorfs_tpu/slam/beam_pallas.py:178")
FUSED_ROW = dict(name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
                 replaces="monorfs_tpu/slam/fused_pallas.py:621")


def grid_beam(dev, kernels, name, p, b, c, n_lm, m, seed):
    """The beam kernel against its plain version at one of the grid's
    shapes, bit for bit on random and tie-heavy options; timed."""
    inputs, n_words = beam_random(dev, seed, p, n_lm, m, c)
    beam_check(name, inputs, b, n_words)
    beam_check(name + "-ties", [torch.as_tensor(x, device=dev) for x in beam_ties(seed + 1, p, m, c, n_words)],
               b, n_words)
    bms, by = beam_bound(inputs, b)
    row = dict(case=name, shape=dict(P=p, M=m, C=c, B=b, n_words=n_words), max_abs_err=0.0,
               bound_ms=bms, bound_by=by,
               ms=kernel_ms(lambda: beam_kernel.beam_scan_batch(*inputs, b, n_words), 5, BEAM_KERNEL),
               plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 2))
    say("beam-shape", **row)
    shape_row(kernels, "beam_scan", row, BEAM_ROW)


def grid_fused(dev, kernels, parent, name, pcfg, params, m, seed):
    """The fused kernel against its plain version at one of the grid's
    shapes, to compare_fused's tolerances; timed (in turns with the parent),
    with its peak memory and phase split."""
    p, k0 = pcfg.num_particles, pcfg.max_components
    pose, maps, z, z_mask = warm_state(seed, p, k0, m, 40, dev)
    args = (PRM3D, pcfg, params, pose, maps, z, z_mask)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pred, cor = fused_kernel.fused_stage(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    pred_ref, cor_ref = fused_kernel.fused_stage_plain(*args)
    err = compare_fused(pred, cor, pred_ref, cor_ref)
    row = dict(fused_row(name, "PRM3D", args, 10, parent, err), launch_peak_bytes=peak)
    say("fused-shape", **row)
    say("fused-phases", case=name, cycles_median_max=row["cycles_median_max"],
        parent_cycles_median_max=row["parent_cycles_median_max"])
    shape_row(kernels, "fused_stage", {k: v for k, v in row.items() if not k.endswith("_runs") and "cycles" not in k},
              FUSED_ROW)


def grid_kernels(dev, kernels, parent):
    """Both kernels at the grid's shapes: the command line's beam (B=200,
    C=8, 4 words, 48 slots) at the reference's 800 and 2000 particles, the
    bench-scaling beam (B=32, C=6, 24 steps) at 10,000; the fused kernel at
    chap3-default.cfg's capacity (K0=500, 48 slots) with 800 particles and
    at the scaling shape (K0=128, 48 slots, 4 merge rounds) with 10,000."""
    default = PHDConfig()
    for p, seed in ((800, 41), (2000, 43)):
        grid_beam(dev, kernels, f"grid-P{p}-B{default.beam_width}-C{default.beam_candidates}-W4-M48", p,
                  default.beam_width, default.beam_candidates, default.estimate_cap, 48, seed)
    scfg = bench_scaling.scaling_config(SCALING_P)
    grid_beam(dev, kernels, f"scaling-P{SCALING_P}-B{scfg.beam_width}-C{scfg.beam_candidates}-W2-M{scfg.beam_meas_cap}",
              SCALING_P, scfg.beam_width, scfg.beam_candidates, scfg.estimate_cap, scfg.beam_meas_cap, 45)
    cfg = Config.from_file(CHAP3_CFG)
    s1 = PHDConfig(num_particles=GRID_S1_PARTICLES, max_components=cfg.max_quantity, max_measurements=48)
    grid_fused(dev, kernels, parent, f"grid-prm3d-P800-K{cfg.max_quantity}-M48", s1,
               cfg.phd_params(torch.float32, dev), 48, 49)
    s2000 = PHDConfig(num_particles=2000, max_components=cfg.max_quantity, max_measurements=48)
    grid_fused(dev, kernels, parent, f"grid-prm3d-P2000-K{cfg.max_quantity}-M48", s2000,
               cfg.phd_params(torch.float32, dev), 48, 50)
    grid_fused(dev, kernels, parent, f"scaling-prm3d-P{SCALING_P}-K128-M48", scfg, model_phd_params("PRM3D", dev),
               scfg.max_measurements, 51)


def grid_phase(dev, kernels, tmp):
    """Phase 10: run_gpu_grid chap3-s1 at 800 particles (launches per leg,
    the JAX TPU row's limits), throughput at 200 and 2000 particles,
    bench_scaling at 10,000, then summarize over the phase's outdir."""
    graph.assert_full_precision()
    t_phase = time.perf_counter()
    out = tmp / "out-h100"
    legs, run_cli_plain = [], run_experiments.run_cli

    def counted(args):
        reset_launches()
        seconds = run_cli_plain(args)
        legs.append(dict(algorithm=args[args.index("-a") + 1], seconds=seconds, launches=read_launches()))
        return seconds

    run_experiments.run_cli = counted
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run_gpu_grid.main(["chap3-s1", "--outdir", str(out)])
    finally:
        run_experiments.run_cli = run_cli_plain
    peak = torch.cuda.max_memory_allocated(dev)
    stats = json.loads((out / "chap3-s1.stats.json").read_text())
    phd, odo = legs
    n = GRID_S1_FRAMES
    if phd["launches"] != dict.fromkeys(KERNEL_NAMES, n) or any(odo["launches"].values()):
        raise AssertionError(f"run_gpu_grid chap3-s1: launches {legs} (phd {n} of each, odometry none)")
    row = stats["phd"]
    if not (row["ate_loc_rmse"] < GRID_S1[0] and row["final_ospa"] < GRID_S1[1]):
        raise AssertionError(f"run_gpu_grid chap3-s1 phd: {row}, limits {GRID_S1}")
    total = dict(phd["launches"])
    say("grid-chap3-s1", particles=GRID_S1_PARTICLES, frames=n, phd=row, odometry=stats["odometry"],
        ate_limit=GRID_S1[0], ospa_limit=GRID_S1[1], run_seconds=phd["seconds"],
        ms_per_frame=phd["seconds"] * 1e3 / n, odometry_seconds=odo["seconds"], legs=legs,
        experiment_wall_s=stats["_wall_s"], peak_device_memory_gb=peak / 2**30, device=stats["_device"])

    reset_launches()
    args = argparse.Namespace(experiment="throughput", outdir=str(out), seeds="0", variant="default")
    with contextlib.redirect_stdout(io.StringIO()):
        run_experiments.run_grid(args, {"throughput": lambda d: run_gpu_grid.throughput(d, GRID_THROUGHPUT)})
    launches = read_launches()
    rows = json.loads((out / "throughput.stats.json").read_text())
    frames = sum(2 * rows[str(p)]["frames"] for p in GRID_THROUGHPUT)  # a warm-up and a timed run each
    if launches != dict.fromkeys(KERNEL_NAMES, frames):
        raise AssertionError(f"throughput: launches {launches} over {frames} frames")
    for p in GRID_THROUGHPUT:
        r = rows[str(p)]
        if not r["ate_rmse_loc"] < ATE_LIMIT:
            raise AssertionError(f"throughput at {p} particles: {r}, ATE limit {ATE_LIMIT}")
        say("grid-throughput", particles=p, **r, ate_limit=ATE_LIMIT)
    for k, v in launches.items():
        total[k] += v

    reset_launches()
    r = bench_scaling.run(SCALING_P, 50, dev)
    launches = read_launches()
    if launches != dict.fromkeys(KERNEL_NAMES, 2 * r["frames"]):
        raise AssertionError(f"bench_scaling at {SCALING_P}: launches {launches} over 2 x {r['frames']} frames")
    if not r["ate_rmse_loc"] < ATE_LIMIT:
        raise AssertionError(f"bench_scaling at {SCALING_P}: {r}, ATE limit {ATE_LIMIT}")
    say("grid-scaling", **r, launches=launches, ate_limit=ATE_LIMIT)
    for k, v in launches.items():
        total[k] += v

    with contextlib.redirect_stdout(io.StringIO()):
        summarize.main(out)
    text = (out / "SUMMARY.md").read_text()
    want = (["| chap3-s1 | phd |", "| chap3-s1 | odometry |"]
            + [f"| throughput | {p} |" for p in GRID_THROUGHPUT] + ["| out-h100 | chap3-s1 | phd |"])
    missing = [w for w in want if w not in text]
    held = next(line for line in text.splitlines() if line.startswith("| out-h100 | chap3-s1 | phd |"))
    if missing or not held.endswith("| pass |"):
        raise AssertionError(f"summarize: rows missing {missing}; chap3-s1 phd held: {held}")
    seconds = time.perf_counter() - t_phase
    say("grid-summary", rows=len([ln for ln in text.splitlines() if ln.startswith("| ")]), held=held,
        phase_seconds=seconds, budget_s=GRID_BUDGET_S, within_budget=seconds <= GRID_BUDGET_S)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + total[k["name"]]
        k.setdefault("launches_by_path", {})["grid"] = total[k["name"]]


# ---- phase 11: the multi-device paths --------------------------------------------

PARALLEL_FRAMES = 300  # the bench path's frames
PARALLEL_NODES = 64  # smoother nodes of the chain sweep
PARALLEL_BUDGET_S = 90.0  # the phase's share of the script's time, printed beside its seconds


def parallel_step(dev, mesh):
    """The sharded step against the single-card step over the bench path's
    frames: the vehicle frames and every draw made once, the single-card run
    first (its launches not counted), then the sharded run with the counts
    set to 0. Returns the sharded run's launches."""
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    runner, carry, cmds = bench_core.setup(assets / "sim3d.world", assets / "mov3d.in", frames=PARALLEL_FRAMES,
                                           phd_cfg=BENCH_CONFIG, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_lm = carry.vstate.landmarks.shape[0]
    frames, vstate = [], carry.vstate
    for i in range(0, PARALLEL_FRAMES, bench_core.CHUNK):
        draws = bench_core.draw_chunk(runner, gen, bench_core.CHUNK, n_lm, torch.float32)
        for f in range(bench_core.CHUNK):
            vstate, noisy = vehicle_mod.update(runner.model, runner.vparams, vstate, cmds[i + f],
                                               draws["odo_normals"][f])
            z, mask, _, _, _ = vehicle_mod.measure(
                runner.model, runner.vparams, vstate, draws["detect_u"][f], draws["meas_normals"][f],
                draws["clutter_draw"][f], draws["clutter_u"][f], runner.max_clutter)
            frames.append((noisy, z, mask, draws["motion_normals"][f], draws["resample_u"][f]))

    def run(step, state):
        out = []
        for noisy, z, mask, normals, u in frames:
            state = step(runner.nparams, state, noisy, z, mask, normals, u)
            out.append((state.pose, state.logweight, state.best, state.ancestor))  # a world of one
        torch.cuda.synchronize()
        return [torch.stack(x) for x in zip(*out)]

    t0 = time.perf_counter()
    want = run(runner.step, carry.nstate)
    single_s = time.perf_counter() - t0
    sharded = make_sharded_step(runner.model, runner.cfg, mesh)
    mesh.comm.clear()
    reset_launches()
    t0 = time.perf_counter()
    got = run(sharded, shard_state(carry.nstate, mesh))
    sharded_s = time.perf_counter() - t0
    launches = read_launches()
    pose_err = (got[0] - want[0]).abs().max().item()
    lw_err = (got[1] - want[1]).abs().max().item()
    same_best = bool(torch.equal(got[2], want[2]))
    same_anc = bool(torch.equal(got[3], want[3]))
    resampled = int((want[3] != torch.arange(BENCH_CONFIG.num_particles, device=dev)).any(dim=1).sum())
    say("parallel-step", frames=PARALLEL_FRAMES, particles=BENCH_CONFIG.num_particles, world=mesh.size,
        backend=torch.distributed.get_backend(), pose_max_abs_err=pose_err, logweight_max_abs_err=lw_err, best_equal=same_best,
        ancestors_equal=same_anc, frames_resampled=resampled, single_card_s=single_s,
        sharded_s=sharded_s, launches=launches, comm={k: list(v) for k, v in mesh.comm.items()})
    if not (pose_err <= 1e-5 and lw_err <= 2e-3 and same_best and same_anc):
        raise AssertionError("the sharded step parts from the single-card step")
    if launches != dict.fromkeys(KERNEL_NAMES, PARALLEL_FRAMES):
        raise AssertionError(f"sharded step: launches {launches} over {PARALLEL_FRAMES} frames")
    return launches


def parallel_chain(dev, mesh):
    """One block-sharded sweep against the sequential sweep (then
    relinearize) on the same state; returns the sharded sweep's launches."""
    nav = loopy_navigator("2d", PARALLEL_NODES, dev)
    cfg, model = nav.lcfg, nav.model
    temperature = torch.tensor(1.0, device=dev)
    args = (nav.odometry, nav.z, nav.z_mask)
    t0 = time.perf_counter()
    want = loopy.make_sweep(model, cfg)(nav.params, nav.state, *args, temperature, nav.grad_clip,
                                        nav.grad_rate, nav.motion_cov)
    if cfg.relinearize:
        want = loopy.relinearize(model, want)
    torch.cuda.synchronize()
    sequential_s = time.perf_counter() - t0
    state, odo, z, zm = chain.shard_loopy_inputs(mesh, nav.state, *args)
    sweep = chain.make_sharded_sweep(model, cfg, mesh)
    mesh.comm.clear()
    reset_launches()
    t0 = time.perf_counter()
    got = sweep(nav.params, state, odo, z, zm, temperature, nav.grad_clip, nav.grad_rate, nav.motion_cov)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    launches = read_launches()
    errs = {f: (getattr(got, f) - getattr(want, f)).abs().max().item()
            for f in ("fused_mean", "fused_cov", "map_mean", "map_logw", "lp")}
    say("parallel-chain", nodes=PARALLEL_NODES, blocks=cfg.blocks, world=mesh.size, max_abs_err=errs,
        sequential_s=sequential_s, sharded_s=sharded_s, launches=launches,
        comm={k: list(v) for k, v in mesh.comm.items()})
    if not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"the sharded sweep parts from the sequential sweep: {errs}")
    if launches["fused_stage"] < PARALLEL_NODES or launches["mixture_ll"] or launches["assoc_options"]:
        raise AssertionError(f"sharded sweep: {launches}, the cavity passes launch the fused kernel a frame "
                             "and weigh no particle")
    return launches


def ba_problem(dev, n_poses=16, n_lms=256, seed=3):
    """A random 3D pixel-range graph in float64 (tests/test_dist_ba.py's
    construction at a larger size): chained poses, landmarks in front of the
    camera seen with probability 0.6, exact measurements, a noisy start."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    gcfg = graph.GraphConfig(max_poses=n_poses, max_landmarks=n_lms, max_factors=n_poses * n_lms,
                             gn_iters=6)
    deltas = np.concatenate([rng.normal(size=(n_poses, 3)) * 0.03, rng.normal(size=(n_poses, 3)) * 0.01], 1)
    deltas[0] = 0.0
    true = [torch.tensor([0, 0, 0, 1, 0, 0, 0.0], **f64)]
    for t in range(1, n_poses):
        true.append(pose3d.add_odometry(true[-1], torch.tensor(deltas[t], **f64)))
    true = torch.stack(true)
    lms = torch.tensor(np.column_stack([rng.uniform(-0.3, 0.3, n_lms), rng.uniform(-0.3, 0.3, n_lms),
                                        rng.uniform(0.8, 1.5, n_lms)]), **f64)
    seen = rng.uniform(size=(n_poses, n_lms)) < 0.6
    f_pose, f_lm = (torch.tensor(x, device=dev) for x in np.nonzero(seen))
    st = graph.empty_state(PRM3D, gcfg, true[0].cpu().numpy(), torch.float64, dev)
    nf = f_pose.shape[0]
    st = st._replace(
        poses=torch.cat([true[:1], pose3d.add(true[1:], torch.tensor(rng.normal(size=(n_poses - 1, 6)) * 0.01,
                                                                     **f64))]),
        n_poses=n_poses, landmarks=lms + torch.tensor(rng.normal(size=(n_lms, 3)) * 0.02, **f64),
        lm_mask=torch.ones(n_lms, dtype=torch.bool, device=dev),
        between=torch.tensor(deltas, **f64), between_mask=torch.arange(n_poses, device=dev) > 0,
        f_pose=torch.cat([f_pose, f_pose.new_zeros(gcfg.max_factors - nf)]),
        f_lm=torch.cat([f_lm, f_lm.new_zeros(gcfg.max_factors - nf)]),
        f_z=torch.cat([PRM3D.measure(PRM3D.params, true[f_pose], lms[f_lm]),
                       torch.zeros((gcfg.max_factors - nf, 3), **f64)]),
        f_mask=torch.arange(gcfg.max_factors, device=dev) < nf,
    )
    minfo = torch.tensor(np.diag(1.0 / np.array([5e-3] * 3 + [2e-4] * 3)), **f64)
    sinfo = torch.tensor(np.diag(1.0 / np.array([2.0, 2.0, 1e-3])), **f64)
    return gcfg, st, minfo, sinfo


def parallel_ba(dev):
    """The landmark-sharded Schur BA against graph.gauss_newton, float64."""
    gcfg, st, minfo, sinfo = ba_problem(dev)
    t0 = time.perf_counter()
    want = graph.gauss_newton(PRM3D, gcfg, st, minfo, sinfo)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    mesh = dist_ba.make_landmark_mesh(device=dev)
    dcfg = dist_ba.DistBAConfig(max_poses=gcfg.max_poses, max_landmarks=gcfg.max_landmarks,
                                max_factors=gcfg.max_factors, gn_iters=gcfg.gn_iters, damping=gcfg.damping)
    host = lambda x: x.cpu().numpy()
    parts = dist_ba.partition_factors(dcfg, mesh.size, host(st.f_pose), host(st.f_lm), host(st.f_z),
                                      host(st.f_mask))
    lms, lmask, fp, fl, fz, fm = dist_ba.shard_ba_inputs(mesh, host(st.landmarks), host(st.lm_mask), *parts)
    t0 = time.perf_counter()
    poses, lms = dist_ba.make_dist_gauss_newton(PRM3D, dcfg, mesh)(
        st.poses, st.n_poses, st.pose_fixed, st.between, st.between_mask, lms, lmask, fp, fl, fz, fm,
        minfo, sinfo)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    errs = dict(poses=(poses - want.poses).abs().max().item(), landmarks=(lms - want.landmarks).abs().max().item())
    moved = (want.landmarks - st.landmarks).abs().max().item()
    say("parallel-ba", poses=gcfg.max_poses, landmarks=gcfg.max_landmarks, factors=int(st.f_mask.sum()),
        gn_iters=gcfg.gn_iters, world=mesh.size, max_abs_err=errs, landmarks_moved=moved,
        dense_s=dense_s, distributed_s=dist_s, comm={k: list(v) for k, v in mesh.comm.items()})
    if not (max(errs.values()) <= 1e-8 and moved > 1e-3):
        raise AssertionError(f"the distributed BA parts from graph.gauss_newton: {errs}")


def parallel_phase(dev, kernels):
    """Phase 11: the multi-device paths over NCCL with a world of one."""
    graph.assert_full_precision()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the flagship needs ~30 GB
    t_phase = time.perf_counter()
    multihost.initialize(f"tcp://localhost:{multihost.free_port()}", 1, 0, device=str(dev))
    try:
        mesh = make_mesh(device=dev)
        assert mesh.size == 1, "one card: a world of one"
        total = parallel_step(dev, mesh)
        for k, v in parallel_chain(dev, mesh).items():
            total[k] += v
        parallel_ba(dev)
        t0 = time.perf_counter()
        particles, landmarks = bench_flagship.PARTICLES, bench_flagship.LANDMARKS
        t_phd, mem_phd = bench_flagship.bench_phd(particles, mesh)
        t_ba, mem_ba = bench_flagship.bench_ba(landmarks, dist_ba.make_landmark_mesh(device=dev))
        say("parallel-flagship", particles=particles, step_s=t_phd, particle_updates_per_s=particles / t_phd,
            peak_memory_bytes=mem_phd, landmarks=landmarks, poses=128, gn_iter_s=t_ba,
            ba_peak_memory_bytes=mem_ba, world=mesh.size, seconds=time.perf_counter() - t0)
    finally:
        multihost.shutdown()
    seconds = time.perf_counter() - t_phase
    say("parallel-summary", phase_seconds=seconds, budget_s=PARALLEL_BUDGET_S,
        within_budget=seconds <= PARALLEL_BUDGET_S, launches=total)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + total[k["name"]]
        k.setdefault("launches_by_path", {})["parallel"] = total[k["name"]]


# ---- phase 12: the viewers -------------------------------------------------------

VIEW_BUDGET_S = 90.0  # the phase's share of the script's time, printed beside its seconds
VIEW_PARTICLES = 200
VIEW_RENDER_EVERY = 10  # live frames rendered with viewer3d.render_3d
VIEW_TIMING_BATCH = 16  # frames of one render call in the batched timing
# The keys sent to the manipulator, by the frame they come before (a key
# held from its press to its release): i over frames 20-40 with shift over
# 30-40, m at 100 and at 120 (mapping, then SLAM again), escape twice at 150
# (paused for one tick), delete once the command file is done.
VIEW_KEYS = {20: [("press", "i")], 30: [("press", "shift")], 40: [("release", "shift"), ("release", "i")],
             100: [("press", "m")], 120: [("press", "m")], 150: [("press", "escape")]}


def drive_manipulator(dev, tmp):
    """ManipulatorLoop over the 3D asset world and its command file at full
    width (200 particles, float32, the default PHDConfig) with the keys of
    VIEW_KEYS, rendering every VIEW_RENDER_EVERY-th frame; returns the
    recording's path and the run's row."""
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    commands = parse_commands((assets / "mov3d.in").read_text())
    sim = Simulation(Config(), World.from_file(str(assets / "sim3d.world")), list(commands), algorithm="phd",
                     particles=VIEW_PARTICLES, dtype=torch.float32, device=dev)
    loop = manipulator.ManipulatorLoop(sim)
    reset_launches()
    t0, slam_frames, renders, render_s, paused_ticks = time.perf_counter(), 0, 0, 0.0, 0
    sent = set()
    while True:
        if loop.frame not in sent:
            sent.add(loop.frame)
            for what, key in VIEW_KEYS.get(loop.frame, []):
                (loop.on_press if what == "press" else loop.on_release)(key)
        if loop.frame == len(commands):
            loop.on_press("delete")
        frame = loop.frame
        if not loop.tick():
            break
        if loop.frame == frame:  # paused: no frame; escape again resumes
            paused_ticks += 1
            loop.on_press("escape")
            continue
        slam_frames += not sim.mode_mapping
        if loop.frame % VIEW_RENDER_EVERY == 0:
            t1 = time.perf_counter()
            viewer3d.render_3d(sim.to_recording(), tmp / f"live_{loop.frame:05d}.png", device=dev)
            render_s += time.perf_counter() - t1
            renders += 1
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = {"fused_stage": loop.frame, "beam_scan": slam_frames, "mixture_ll": slam_frames,
            "assoc_options": slam_frames}
    if launches != want or paused_ticks != 1 or loop.frame != len(commands):
        raise AssertionError(f"manipulator: launches {launches}, expected {want} (frames {loop.frame}, "
                             f"SLAM {slam_frames}, paused ticks {paused_ticks})")
    record = tmp / "manipulator.zip"
    sim.save(str(record))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        postanalysis.main(["-f", str(record), "--device", str(dev)])
    ate, ospa = printed_number(out.getvalue(), "ATE loc RMSE"), printed_number(out.getvalue(), "final OSPA")
    if not (np.isfinite(ate) and np.isfinite(ospa)):
        raise AssertionError(f"manipulator: ATE {ate}, OSPA {ospa}")
    tags = [msg for _, msg in Recording.load(record).tags]
    row = dict(frames=loop.frame, slam_frames=slam_frames, mapping_frames=loop.frame - slam_frames,
               paused_ticks=paused_ticks, launches=launches, ate=ate, ospa=ospa, tags=tags, seconds=seconds,
               live_renders=renders, live_render_s=render_s, particles=VIEW_PARTICLES, dtype="float32")
    say("view-manipulator", **row)
    return record, launches


def view_viewer(dev, tmp, record):
    """viewer.main over the manipulator's recording: the 3D overview, --flat,
    --frames, two --tag, --tag-shots and --avi (read back and decoded); the
    2D overview of a 2D recording."""
    t0 = time.perf_counter()
    n_maps = len(Recording.load(record).maps)
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        viewer.main(["-f", str(record), "-o", str(tmp / "overview3d.png"), "--device", str(dev)])
        viewer.main(["-f", str(record), "--flat", "-o", str(tmp / "flat.png"), "--device", str(dev)])
        viewer.main(["-f", str(record), "--frames", str(tmp / "frames"), "--stride", "30", "--device", str(dev)])
        viewer.main(["-f", str(record), "--tag", "2.0:first look", "--device", str(dev)])
        viewer.main(["-f", str(record), "--tag", "6.5:second look", "--device", str(dev)])
        viewer.main(["-f", str(record), "--tag-shots", str(tmp / "tags"), "--device", str(dev)])
        viewer.main(["-f", str(record), "--avi", str(tmp / "replay.avi"), "--stride", "10", "--device", str(dev)])
    rec = Recording.load(record)
    frames = sorted((tmp / "frames").iterdir())
    shots = sorted((tmp / "tags").iterdir())
    if len(frames) != -(-n_maps // 30) or len(shots) != len(rec.tags) or len(rec.tags) < 2:
        raise AssertionError(f"viewer: {len(frames)} frames of {n_maps} maps at stride 30, "
                             f"{len(shots)} tag shots for tags {rec.tags}")
    for png in [tmp / "overview3d.png", tmp / "flat.png", frames[0], shots[0]]:
        img = read_png(png)
        if img.ndim != 3 or not (img != 255).any():
            raise AssertionError(f"viewer: {png.name} is blank ({img.shape})")
    jpegs = read_mjpeg(str(tmp / "replay.avi"))
    decoded = avi.decode_frames(jpegs, device=dev)
    idx = list(range(0, n_maps, 10))
    rendered = viewer.render_images([viewer.overview_figure(rec, i) for i in idx], dev)
    errors = [float(np.abs(d.astype(np.float64) - r.cpu().numpy()).mean()) for d, r in zip(decoded, rendered)]
    if len(jpegs) != len(idx) or decoded[0].shape != (viewer.SIZE[1], viewer.SIZE[0], 3) or max(errors) >= 3:
        raise AssertionError(f"--avi: {len(jpegs)} frames for {len(idx)}, shape {decoded[0].shape}, "
                             f"mean errors {errors} (limit 3, tests/test_torch_avi.py)")
    # a 2D recording: phase 6's, or a short new one
    rec2d = tmp / "2d-slam.zip"
    if not rec2d.is_file():
        rec2d = tmp / "view-2d.zip"
        assets = pathlib.Path(__file__).resolve().parent / "assets"
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-f", str(assets / "linear2d.world"), "-c", str(assets / "mov2d.in"), "-a", "phd", "-p",
                      "50", "--frames", "60", "-r", str(rec2d), "--device", str(dev)])
    with contextlib.redirect_stdout(io.StringIO()):
        viewer.main(["-f", str(rec2d), "-o", str(tmp / "overview2d.png"), "--device", str(dev)])
    if not (read_png(tmp / "overview2d.png") != 255).any():
        raise AssertionError("viewer: the 2D overview is blank")
    say("view-viewer", frames=len(frames), tag_shots=len(shots), tags=[m for _, m in rec.tags],
        avi_frames=len(jpegs), avi_mean_abs_error_max=max(errors), avi_error_limit=3,
        recording_2d=rec2d.name, seconds=time.perf_counter() - t0)
    return rec


def view_decoder(dev, tmp):
    """The sidebar of the k9 Kinect recording (phase 9) or of a short
    `-i kinect` run, decoded on the card and on the CPU: equal."""
    record = tmp / "k9" / "chap4-k9" / "phd.zip"
    if not record.is_file():
        record = tmp / "view-kinect.zip"
        npz = tmp / "view-seq.npz"
        convert_tum(str(TUM_REAL), str(npz))
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-f", str(npz), "-i", "kinect", "-a", "odometry", "-r", str(record), "--device", str(dev)])
    jpegs = read_mjpeg(io.BytesIO(Recording.load(record).sidebar))
    card, host = avi.decode_frames(jpegs, device=dev), avi.decode_frames(jpegs, device="cpu")
    diff = max(int(np.abs(a.astype(np.int64) - b).max(axis=(0, 1)).max()) for a, b in zip(card, host))
    if diff != 0 or len(card) != len(jpegs):
        raise AssertionError(f"sidebar decode: card against CPU differs by {diff}")
    parsed, t0 = [], time.perf_counter()
    for j in jpegs:
        parsed.append(avi.parse_jpeg(j))
    host_ms = (time.perf_counter() - t0) * 1e3 / len(jpegs)
    device_ms = cuda_ms(lambda: [avi.reconstruct(p, dev) for p in parsed], 5) / len(jpegs)
    say("view-decoder", recording=str(record.relative_to(tmp)), frames=len(jpegs),
        size=list(card[0].shape), card_vs_cpu_max_abs_diff=diff, host_huffman_ms_per_frame=host_ms,
        device_ms_per_frame=device_ms, mean_jpeg_bytes=sum(map(len, jpegs)) / len(jpegs))
    return host_ms, device_ms


def view_phase(dev, kernels, tmp):
    """Phase 12: the manipulator, the viewers, the decoder, determinism."""
    graph.assert_full_precision()
    t_phase = time.perf_counter()
    record, launches = drive_manipulator(dev, tmp)
    rec = view_viewer(dev, tmp, record)
    host_ms, device_ms = view_decoder(dev, tmp)
    # determinism: the same frame twice on the card, then on the CPU
    fig = viewer3d.figure_3d(rec, len(rec.maps) - 1)
    a, b = (axes.render([fig], dev)[0].cpu().numpy() for _ in range(2))
    png_a, png_b = encode_png(a), encode_png(b)
    if png_a != png_b:
        raise AssertionError("two renders of one frame on the card differ")
    host = axes.render([fig], "cpu")[0].numpy()
    differ = np.abs(a.astype(np.int64) - host)
    # timings: a batch of frames in one call, one frame alone, write_png
    figs = [viewer3d.figure_3d(rec, i) for i in np.linspace(0, len(rec.maps) - 1, VIEW_TIMING_BATCH).astype(int)]
    batched_ms = cuda_ms(lambda: axes.render(figs, dev), 3) / len(figs)
    alone_ms = cuda_ms(lambda: axes.render(figs[:1], dev), 5)
    t0 = time.perf_counter()
    for _ in range(5):
        encode_png(a)
    png_ms = (time.perf_counter() - t0) * 1e3 / 5
    seconds = time.perf_counter() - t_phase
    say("view-summary", repeat_png_identical=True, card_vs_cpu_max_abs_diff=int(differ.max()),
        card_vs_cpu_pixels_differ=int((differ.max(-1) > 0).sum()), render_ms_per_frame_batched=batched_ms,
        render_batch=len(figs), render_ms_alone=alone_ms, write_png_ms=png_ms, png_bytes=len(png_a),
        frame_size=list(a.shape), decode_host_ms_per_frame=host_ms, decode_device_ms_per_frame=device_ms,
        phase_seconds=seconds, budget_s=VIEW_BUDGET_S, within_budget=seconds <= VIEW_BUDGET_S,
        launches=launches)
    for k in kernels:
        k["launches"] = k.get("launches", 0) + launches[k["name"]]
        k.setdefault("launches_by_path", {})["view"] = launches[k["name"]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="another checkout whose kernels are timed on the same inputs")
    ap.add_argument("--phases", default="kernels,bench,sync,vehicle,cli,graph,loopy,kinect,grid,parallel,view",
                    help="comma-separated subset of kernels,bench,sync,vehicle,cli,graph,loopy,kinect,grid,"
                         "parallel,view (default: all)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a GPU is required", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib = _build.build_library()
    regs = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln or "Compiling" in ln]
    say("build", seconds=time.perf_counter() - t0, library=lib.name, ptxas=regs,
        device=torch.cuda.get_device_name(0), torch=torch.__version__, cuda=torch.version.cuda)
    parent = None
    if args.parent is not None:
        t0 = time.perf_counter()
        parent = load_parent(args.parent)
        plib = importlib.import_module("parent_port._build")
        plib.build_library()
        say("parent-build", seconds=time.perf_counter() - t0, root=str(args.parent),
            ptxas=[ln.strip() for ln in plib.build_log().splitlines() if "registers" in ln])

    kernels = []
    if "kernels" in phases:
        layout_check()
        kernels.append(beam_phase(dev, parent))
        kernels[-1]["shapes"].append(beam_wide(dev))
        kernels.append(fused_phase(dev, parent))
        kernels.append(mixture_phase(dev))
        kernels.append(assoc_phase(dev))
    if "loopy" in phases:  # the smoother's kernel shapes, beside the others
        loopy_kernels(dev, kernels, parent)
    if "grid" in phases:  # the grid's shapes
        grid_kernels(dev, kernels, parent)
    if "bench" in phases:
        bench_phase(dev, kernels)
    if "sync" in phases:
        syncs = host_syncs(10, dev)
        ours = [s for s in syncs if in_package(s[0])]
        if ours:
            raise AssertionError(f"the main path makes the host wait for the device: {ours}")
        say("sync-check", frames=10, syncs=syncs)
    if "vehicle" in phases:
        vehicle_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if "cli" in phases:
            cli_phase(dev, kernels, tmp)
        if "graph" in phases:
            graph_phase(dev, kernels, tmp)
        if "loopy" in phases:
            loopy_phase(dev, kernels, tmp)
        if "kinect" in phases:
            kinect_phase(dev, kernels, tmp)
        if "grid" in phases:
            grid_phase(dev, kernels, tmp)
        if "view" in phases:
            view_phase(dev, kernels, tmp)
    if "parallel" in phases:
        parallel_phase(dev, kernels)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
