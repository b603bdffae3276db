#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (monorfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR] [--phases kernels,bench,sync,cli,graph]

Phases, one line each; any failure exits non-zero:
  1. device, `nvidia-smi` name and power limit, kernel build (nvcc, sm_90a);
  2. beam kernel vs its plain version, bit-identical: at the bench shape, on
     tie-heavy inputs, at B=64 C=8 n_words=3, at the default PHDConfig's
     B=200 C=8 n_words=4, and at the command line's 48 steps of that shape;
  3. fused kernel vs its plain version on warm random states at the bench
     shape, a cap-binds state, a merge-ties state and a second shape:
     predicted rtol/atol 2e-5, corrected component sets to the tolerances
     of tests/test_fused_pallas.py; its per-phase clock split; then, to the
     same tolerances and each with its device time, Linear2D and Linear1D
     states at the bench shape and the command line's capacity (K0=600, the
     pair table in device memory): PRM3D M=48 with the cap loose and
     binding, Linear2D M=33, Linear1D M=20;
  4. the bench path: run_benchmark at the bench.py config (200 particles,
     K=128, 48 -> 24 measurement slots, beam 32 x 6, 300 frames), with both
     kernels launched once per frame and ATE below 0.03;
  5. no host synchronisation: 10 frames of the bench path after warm-up under
     torch.cuda.set_sync_debug_mode("warn"), none from the port's code;
  6. the command-line path at full width, through cli.main and then
     postanalysis.main on each recording: the 3D, 2D and 1D asset worlds with
     200 particles and the default PHDConfig (K=600, beam 200 x 8) over their
     whole command files, mapping-only on the 3D world, float64 on the 2D
     world (30 frames), and the 3D recording replayed through dead
     reckoning. The fused kernel must launch once per float32 frame, the
     beam kernel once per float32 SLAM frame (none in mapping-only, float64
     and odometry), every ATE / OSPA must be finite and under its limit, and
     the replayed trajectory must equal the recorded odometry integrated.
  7. `graph`: the graph backend at full width (3D asset world, 40
     landmarks, 300 frames: 302 poses, 160 landmark slots, 48 measurement
     slots, 14,496 factor slots in the host navigator). `cli.main -a isam2`
     then postanalysis, twice, with identical ATE, OSPA and landmark count
     and both under their limits; `-i record -a isam2` over phase 6's PHD
     recording (its own recording when phase 6 did not run); one Linear2D
     `-a isam2` run; a 60-frame mapping-only run (ATE exactly 0);
     `bench_isam2 --scan` and `--scan-da` over 300 frames (ATE, landmarks
     against the world's 40, OSPA); and the host synchronisations per frame
     of the navigator and of each scan runner, counted under
     torch.cuda.set_sync_debug_mode("warn") with the lines that waited,
     beside the reads the code counts itself, printed and not limited. This path runs no hand-written kernel: both launch counts
     must stay 0 over it, and TF32 must be off.
Nothing of the earlier phases was cut: phase 4 still runs all 300 frames.

A kernel's time is its device time: torch.profiler's CUDA kernel events
selected by the kernel's name, their mean over the launches. The wrapper's wall
time per call is printed beside it. --parent DIR also loads the port from
another checkout (DIR/monorfs_tpu_torch, built by its own _build), times
its kernels on the same inputs, in turns with this checkout's
(parent, this, this, parent), and holds the fused kernel's PRM3D results
to the parent's bit for bit. --phases runs a subset (kernels = 2 and 3).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import collections
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
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from monorfs_tpu_torch import _build, bench_isam2, cli, postanalysis
from monorfs_tpu_torch.bench import BENCH_CONFIG, run as run_bench
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm.mixture import DEAD, SGM
from monorfs_tpu_torch.io import Recording, World, parse_commands
from monorfs_tpu_torch.kernel_cases import beam_ties, fused_state
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.models import get as get_model
from monorfs_tpu_torch.profile_step import host_syncs, in_package
from monorfs_tpu_torch.sim.simulation import Simulation
from monorfs_tpu_torch.slam import association, beam_kernel, fused_kernel, graph
from monorfs_tpu_torch.slam.isam2_scan import build_isam2_scan_runner, scan_draws
from monorfs_tpu_torch.slam.isam2_scan_da import build_mahalanobis_scan
from monorfs_tpu_torch.slam.phd import PHDConfig

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_S = 67e12  # H100 SXM fp32 outside the tensor cores
ATE_LIMIT = 0.03  # ~3x the JAX package's 0.0108 on this config
BENCH_FRAMES = 300  # the whole of mov3d.in
BEAM_KERNEL = "beam_scan"  # substring of every beam kernel's name
FUSED_KERNEL = "fused_stage_kernel"


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    mean duration (as profile_step reads them)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
    # the tracer now and then loses one event of a run; more than that is a fault
    if not reps - 1 <= len(events) <= reps:
        raise AssertionError(f"{len(events)} {kernel} kernel events for {reps} calls")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(events)


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


def beam_bound(inputs, b):
    """(bound ms, bound by) of one beam launch on these inputs."""
    base, od, wk, bk = inputs
    p, m, c1 = od.shape
    c = c1 - 1
    nbytes = 4 * (base.numel() + od.numel() + wk.numel() + bk.numel() + p * b)
    nc = b * c1
    # per step, what a top-B selection needs: nc candidate sums, B*C used-set
    # ANDs, and nc + B*log2(nc) compares to pick the best B in order
    ops = p * m * (nc + b * c + nc + b * int(np.ceil(np.log2(nc))))
    return bound(nbytes, ops)


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

    def run():
        return beam_kernel.beam_scan_batch(*inputs, b, n_words)

    parent_run = None if parent is None else (lambda: parent[0].beam_scan_batch(*inputs, b, n_words))
    ms, parent_ms = in_turns(run, parent_run, 50, BEAM_KERNEL)
    w_ms = wall_ms(run, 50)
    # the default PHDConfig's shape runs the block-per-particle design
    wide_ms, wide_parent_ms = in_turns(
        lambda: beam_kernel.beam_scan_batch(*wide, wide_b, wide_w),
        None if parent is None else (lambda: parent[0].beam_scan_batch(*wide, wide_b, wide_w)),
        10, BEAM_KERNEL)
    plain_ms = cuda_ms(lambda: beam_kernel.beam_scan_plain(*inputs, b, n_words), 5)
    bms, by = beam_bound(inputs, b)
    wide_bms, wide_by = beam_bound(wide, wide_b)
    wide_shape = dict(case="default-B200-C8-W4-M24", shape=dict(P=p, M=m, C=default.beam_candidates,
                                                                B=wide_b, n_words=wide_w),
                      max_abs_err=0.0, ms=float(np.mean(wide_ms)),
                      plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*wide, wide_b, wide_w), 2),
                      bound_ms=wide_bms, bound_by=wide_by)
    say("beam-shape", **wide_shape)
    # the command line's shape: the default PHDConfig over all 48 measurement
    # slots of the 3D world (no beam_meas_cap)
    cli_in = beam_random(dev, 13, p, default.estimate_cap, 48, default.beam_candidates)[0]
    beam_check("cli-B200-C8-W4-M48", cli_in, wide_b, wide_w)
    cli_bms, cli_by = beam_bound(cli_in, wide_b)
    cli_shape = dict(case="cli-B200-C8-W4-M48", shape=dict(P=p, M=48, C=default.beam_candidates,
                                                            B=wide_b, n_words=wide_w),
                     max_abs_err=0.0,
                     ms=kernel_ms(lambda: beam_kernel.beam_scan_batch(*cli_in, wide_b, wide_w), 10, BEAM_KERNEL),
                     plain_ms=cuda_ms(lambda: beam_kernel.beam_scan_plain(*cli_in, wide_b, wide_w), 2),
                     bound_ms=cli_bms, bound_by=cli_by)
    say("beam-shape", **cli_shape)
    say("beam", ms=ms, parent_ms=parent_ms, wrapper_ms=w_ms, plain_ms=plain_ms,
        shape=dict(P=p, M=m, C=c, B=b, n_words=n_words),
        default_shape_ms=wide_ms, default_shape_parent_ms=wide_parent_ms)
    row = dict(name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
               replaces="monorfs_tpu/slam/beam_pallas.py:178", max_abs_err=0.0, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               shapes=[wide_shape, cli_shape])
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


# ---- phase 3: fused --------------------------------------------------------------

def warm_state(seed, p, k0, m, n_lm, dev, merge_ties=False, model="PRM3D"):
    """kernel_cases.fused_state as float32 tensors on the device."""
    pose, leaves, z, z_mask = fused_state(seed, p, k0, m, n_lm, merge_ties, model)
    maps = SGM(*[torch.tensor(x, dtype=torch.float32, device=dev) for x in leaves])
    return (torch.tensor(pose, dtype=torch.float32, device=dev), maps,
            torch.tensor(z, dtype=torch.float32, device=dev), torch.tensor(z_mask, device=dev))


def compare_fused(pred, cor, pred_ref, cor_ref):
    """Raises unless the kernel's output matches the plain version's within
    the stated tolerances; returns the largest absolute difference seen."""
    err = 0.0
    live = pred_ref.logw > DEAD / 4
    for name, a, b in zip(SGM._fields, pred, pred_ref):
        a, b = (a[live], b[live]) if name == "logw" else (a, b)
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=f"predicted {name}")
        err = max(err, (a - b).abs().max().item())
    got, ref = [torch.stack(list(s), -1).cpu().numpy() for s in (cor, cor_ref)]
    for i in range(got.shape[0]):
        gk, rk = got[i][got[i][:, 9] > DEAD / 4], ref[i][ref[i][:, 9] > DEAD / 4]
        if len(gk) != len(rk):
            raise AssertionError(f"particle {i}: {len(gk)} components vs plain {len(rk)}")
        gk, rk = gk[np.argsort(-gk[:, 9], kind="stable")], rk[np.argsort(-rk[:, 9], kind="stable")]
        np.testing.assert_allclose(gk[:, 9], rk[:, 9], rtol=1e-4, atol=1e-4)
        used = np.zeros(len(rk), bool)
        for j in range(len(gk)):
            jj = int(np.argmin(np.linalg.norm(rk[:, :3] - gk[j, :3], axis=-1) + np.where(used, 1e9, 0)))
            used[jj] = True
            np.testing.assert_allclose(gk[j, :3], rk[jj, :3], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(gk[j, 3:9], rk[jj, 3:9], rtol=1e-3, atol=1e-5)
            err = max(err, float(np.abs(gk[j] - rk[jj]).max()))
    return err


def fused_ops(maps, pred, z_mask, cor, params, m):
    """fp32 operations this data needs (a lower count): density terms of the
    live map components, the EKF of live predicted components, every gate
    test and the likelihood of in-gate pairs, the cut's counts (one, or 31
    when the cap may bind), the merge relation over surviving pairs."""
    k0 = maps.logw.shape[1]
    kp = k0 + m
    alive0 = (maps.logw > DEAD / 2).sum(1)
    alive = pred.logw > DEAD / 2
    bp = [leaf[:, k0:] for leaf in pred[:3]]
    d2 = sum((b[:, :, None] - mm[:, None, :]) ** 2 for b, mm in zip(bp, pred[:3]))
    in_gate = (d2 <= params.density_radius ** 2) & alive[:, None, :] & z_mask[None, :, None]
    n_gate = in_gate.sum((1, 2))
    counts = torch.where(alive.sum(1) + n_gate > k0, 31, 1)
    n_out = (cor.logw > DEAD / 2).sum(1)
    ops = (alive0 * m * 30 + alive.sum(1) * 250 + m * kp * 8 + n_gate * 35
           + counts * (kp + m * kp) + n_out * (n_out - 1) // 2 * 25)
    return int(ops.sum().item())


def phase_split(args):
    """Cycles of each fused-kernel phase across blocks (median, max), from
    one launch with the phase clock probe."""
    p = args[4].logw.shape[0]
    clk = torch.zeros((p, len(fused_kernel.PHASES) + 1), dtype=torch.int64, device=args[3].device)
    fused_kernel.fused_stage(*args, phase_clock=clk)
    d = torch.diff(clk, dim=1).cpu().numpy()
    split = {name: [float(np.median(d[:, i])), int(d[:, i].max())]
             for i, name in enumerate(fused_kernel.PHASES)}
    total = d.sum(1)
    split["total"] = [float(np.median(total)), int(total.max())]
    return split


def fused_bound(p, k0, m, d, s_dim, maps, pred, z_mask, cor, params):
    """(bound ms, bound by) of one fused launch: every input read once and
    every output written once against this data's operation count."""
    kp = k0 + m
    nbytes = 4 * (10 * p * k0 + s_dim * p + d * m + m + 16 + d + d * d + 10 * p * kp + 10 * p * k0)
    return bound(nbytes, fused_ops(maps, pred, z_mask, cor, params, m))


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
    say("fused-phases", cycles_median_max=split)

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

    # the other families, and the command-line capacity (K0 = 600: the pair
    # table in the device-memory workspace); each state vs the plain version,
    # then device ms, plain ms and bound at that shape
    cli = PHDConfig(num_particles=p)  # the command line's default: K=600, gate_top 16, 8 rounds
    bind = PHDConfig(num_particles=32)
    shapes = [
        # name, model, config, P, M, seed, landmarks, timed
        ("lin2d-K128-M24", "Linear2D", BENCH_CONFIG, p, m, 21, 20, True),
        ("lin1d-K128-M24", "Linear1D", BENCH_CONFIG, p, m, 22, 10, True),
        ("prm3d-K600-M48", "PRM3D", cli, p, 48, 23, 40, True),
        ("prm3d-K600-M48-cap-binds", "PRM3D", bind, 32, 48, 24, 580, True),
        ("lin2d-K600-M33", "Linear2D", cli, p, 33, 25, 25, True),
        ("lin1d-K600-M20", "Linear1D", cli, p, 20, 26, 12, True),
    ]
    extra = []
    for name, mname, pcfg, pp, mm, seed, n_lm, timed in shapes:
        model, mparams = get_model(mname), model_phd_params(mname, dev)
        kk = pcfg.max_components
        pose, maps, z, z_mask = warm_state(seed, pp, kk, mm, n_lm, dev, model=mname)
        sargs = (model, pcfg, mparams, pose, maps, z, z_mask)
        pred, cor = fused_kernel.fused_stage(*sargs)
        pred_ref, cor_ref = fused_kernel.fused_stage_plain(*sargs)
        torch.cuda.synchronize()
        e = compare_fused(pred, cor, pred_ref, cor_ref)
        err = max(err, e)
        n_in = int((maps.logw > DEAD / 2).sum(1).max().item())
        row = dict(case=name, model=mname, shape=dict(P=pp, K0=kk, M=mm, KP=kk + mm), max_abs_err=e,
                   alive_out=int((cor.logw > DEAD / 2).sum().item()), alive_in_max=n_in,
                   pairs_in_device_memory=fused_kernel.pairs_global(kk, mm),
                   smem_bytes=fused_kernel.smem_bytes(kk, mm, fused_kernel.pairs_global(kk, mm)))
        if timed:
            row["ms"] = kernel_ms(lambda: fused_kernel.fused_stage(*sargs), 10, FUSED_KERNEL)
            row["plain_ms"] = cuda_ms(lambda: fused_kernel.fused_stage_plain(*sargs), 2)
            row["bound_ms"], row["bound_by"] = fused_bound(
                pp, kk, mm, model.meas_dim, model.pose.state_dim, maps, pred, z_mask, cor, mparams)
        say("fused-shape", **row, cycles_median_max=phase_split(sargs))
        extra.append(row)
    row = dict(name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
               replaces="monorfs_tpu/slam/fused_pallas.py:621", max_abs_err=err, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               shapes=extra)
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


def reset_launches():
    beam_kernel.beam_scan_batch.launches = 0
    fused_kernel.fused_stage.launches = 0


def read_launches():
    return {"beam_scan": beam_kernel.beam_scan_batch.launches,
            "fused_stage": fused_kernel.fused_stage.launches}


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
    want = {"fused_stage": per_frame[0] * frames, "beam_scan": per_frame[1] * frames}
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
                                "fused only: mapping-only weighs no particle" if per_frame == (1, 0)
                                else "fused and beam"))
    say("cli-run", **row)
    return row, rec, launches


def cli_phase(dev, kernels, tmp):
    """Phase 6: the command line's own entry on every asset family, then
    postanalysis on each recording (written under `tmp`); launch counts,
    error limits and the odometry replay against the recorded odometry
    integrated."""
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    total = {"beam_scan": 0, "fused_stage": 0}
    for name, files, flags, frames, per_frame, ate_limit, ospa_limit in CLI_RUNS:
        argv = ["-f", str(assets / files[0]), "-c", str(assets / files[1])] + flags
        _, _, launches = run_cli(name, argv, frames, per_frame, ate_limit, ospa_limit,
                                 tmp / f"{name}.zip")
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
ISAM2_2D = (0.6, 0.6)
# Mapping-only pins every pose: ATE exactly 0. With all poses pinned the
# navigator of both packages stops minting landmarks early on this world (a
# 60-frame CPU run of the port maps 18 of the 40, OSPA 0.561757, and the JAX
# package's replay of that recording gives the same 18 and 0.561757), so the
# map is only required to be non-empty and under the OSPA cutoff of 1.
ISAM2_MAPPING = (1e-6, 0.9)
SCAN_ATE, SCAN_DA_ATE, SCAN_DA_OSPA, SCAN_DA_EXTRA = 0.03, 0.08, 0.25, 6
SYNC_FRAMES = 20


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
    total = {"beam_scan": 0, "fused_stage": 0}

    def run(name, argv, frames, limits):
        row, rec, launches = run_cli(name, argv, frames, (0, 0), limits[0], limits[1], tmp / f"{name}.zip")
        for k, n in launches.items():
            total[k] += n
        return row["ate"], row["ospa"], len(rec.maps[-1][1])

    first = run("3d-isam2", world3d + ["-a", "isam2"], 300, ISAM2_3D)
    second = run("3d-isam2-again", world3d + ["-a", "isam2"], 300, ISAM2_3D)
    if first != second:
        raise AssertionError(f"two runs of the same -a isam2 command differ: {first} and {second}")
    if abs(first[2] - 40) > SCAN_DA_EXTRA:
        raise AssertionError(f"-a isam2 mapped {first[2]} landmarks of the world's 40")
    say("graph-deterministic", ate=first[0], ospa=first[1], landmarks=first[2], identical=True)

    source = tmp / "3d-slam.zip"  # phase 6's PHD recording
    if not source.exists():
        source = tmp / "3d-isam2.zip"
    replay = run("3d-replay-isam2", ["-f", str(source), "-i", "record", "-a", "isam2"], 300, ISAM2_3D)
    say("graph-replay", source=source.name, ate=replay[0], ospa=replay[1], landmarks=replay[2])
    run("2d-isam2", ["-f", str(assets / "linear2d.world"), "-c", str(assets / "mov2d.in"), "-a", "isam2"],
        270, ISAM2_2D)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="another checkout whose kernels are timed on the same inputs")
    ap.add_argument("--phases", default="kernels,bench,sync,cli,graph",
                    help="comma-separated subset of kernels,bench,sync,cli,graph (default: all)")
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

    kernels = [beam_phase(dev, parent), fused_phase(dev, parent)] if "kernels" in phases else []
    if "bench" in phases:
        bench_phase(dev, kernels)
    if "sync" in phases:
        syncs = host_syncs(10, dev)
        ours = [s for s in syncs if in_package(s[0])]
        if ours:
            raise AssertionError(f"the main path makes the host wait for the device: {ours}")
        say("sync-check", frames=10, syncs=syncs)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if "cli" in phases:
            cli_phase(dev, kernels, tmp)
        if "graph" in phases:
            graph_phase(dev, kernels, tmp)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
