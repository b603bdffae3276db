#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (monorfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one line each; any failure exits non-zero:
  1. device, `nvidia-smi` name and power limit, kernel build (nvcc, sm_90a);
  2. beam kernel vs its plain version, bit-identical: at the bench shape, on
     tie-heavy inputs, at B=64 C=8 n_words=3 and at the default PHDConfig's
     B=200 C=8 n_words=4;
  3. fused kernel vs its plain version on warm random states at the bench
     shape, a cap-binds state, a merge-ties state and a second shape:
     predicted rtol/atol 2e-5, corrected component sets to the tolerances
     of tests/test_fused_pallas.py; then its per-phase clock split;
  4. the main path: run_benchmark at the bench.py config (200 particles,
     K=128, 48 -> 24 measurement slots, beam 32 x 6, 300 frames), with both
     kernels launched once per frame and ATE below 0.03.
  5. no host synchronisation: 10 frames of the main path after warm-up under
     torch.cuda.set_sync_debug_mode("warn"), none from the port's code.

A kernel's time is its device time: torch.profiler's CUDA kernel events
selected by the kernel's name, summed over the launches. The wrapper's wall
time per call is printed beside it. --parent DIR also loads the port from
another checkout (DIR/monorfs_tpu_torch, built by its own _build) and times
its kernels on the same inputs, in turns with this checkout's
(parent, this, this, parent).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from monorfs_tpu_torch import _build
from monorfs_tpu_torch.bench import BENCH_CONFIG, run as run_bench
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm.mixture import DEAD, SGM
from monorfs_tpu_torch.kernel_cases import beam_ties, fused_state
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.profile_step import host_syncs, in_package
from monorfs_tpu_torch.slam import association, beam_kernel, fused_kernel
from monorfs_tpu_torch.slam.phd import PHDConfig

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_S = 67e12  # H100 SXM fp32 outside the tensor cores
ATE_LIMIT = 0.03  # ~3x the JAX package's 0.0108 on this config
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
    durations summed over their count (as profile_step reads them)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(events) != reps:
        raise AssertionError(f"{len(events)} {kernel} kernel events for {reps} calls")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


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
    base, od, wk, bk = inputs
    nbytes = 4 * (base.numel() + od.numel() + wk.numel() + bk.numel() + p * b)
    nc = b * (c + 1)
    # per step, what a top-B selection needs: nc candidate sums, B*C used-set
    # ANDs, and nc + B*log2(nc) compares to pick the best B in order
    ops = p * od.shape[1] * (nc + b * c + nc + b * int(np.ceil(np.log2(nc))))
    bms, by = bound(nbytes, ops)
    say("beam", ms=ms, parent_ms=parent_ms, wrapper_ms=w_ms, plain_ms=plain_ms,
        shape=dict(P=p, M=m, C=c, B=b, n_words=n_words),
        default_shape_ms=wide_ms, default_shape_parent_ms=wide_parent_ms)
    row = dict(name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
               replaces="monorfs_tpu/slam/beam_pallas.py:178", max_abs_err=0.0, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


# ---- phase 3: fused --------------------------------------------------------------

def warm_state(seed, p, k0, m, n_lm, dev, merge_ties=False):
    """kernel_cases.fused_state as float32 tensors on the device."""
    pose, leaves, z, z_mask = fused_state(seed, p, k0, m, n_lm, merge_ties)
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


def fused_phase(dev, parent):
    cfg = Config()
    params = cfg.phd_params(torch.float32, dev)
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
        say("fused-check", case=name, ok=True, alive_out=int((cor.logw > DEAD / 2).sum().item()))
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
    nbytes = 4 * (10 * p * k0 + 7 * p + 3 * m + m + 28 + 10 * p * kp + 10 * p * k0)
    bms, by = bound(nbytes, fused_ops(maps, pred, z_mask, cor, params, m))
    say("fused", ms=ms, parent_ms=parent_ms, wrapper_ms=w_ms, plain_ms=plain_ms, max_abs_err=err,
        smem_bytes=fused_kernel.smem_bytes(k0, m), shape=dict(P=p, K0=k0, M=m, KP=kp))
    row = dict(name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
               replaces="monorfs_tpu/slam/fused_pallas.py:621", max_abs_err=err, ms=float(np.mean(ms)),
               wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    if parent_ms is not None:
        row["parent_ms"] = float(np.mean(parent_ms))
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="another checkout whose kernels are timed on the same inputs")
    args = ap.parse_args()
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

    kernels = [beam_phase(dev, parent), fused_phase(dev, parent)]

    beam_kernel.beam_scan_batch.launches = 0
    fused_kernel.fused_stage.launches = 0
    result = run_bench(frames=300, device=dev)
    launches = {"beam_scan": beam_kernel.beam_scan_batch.launches,
                "fused_stage": fused_kernel.fused_stage.launches}
    frames_run = 2 * result["frames"]  # warm-up run + timed run
    for name, n in launches.items():
        if n != frames_run:
            raise AssertionError(f"{name} launched {n} times over {frames_run} frames")
    if not np.isfinite(result["ate_rmse_loc"]) or result["ate_rmse_loc"] >= ATE_LIMIT:
        raise AssertionError(f"ATE {result['ate_rmse_loc']} not below {ATE_LIMIT}")
    say("main-path", **result, launches=launches)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    syncs = host_syncs(10, dev)
    ours = [s for s in syncs if in_package(s[0])]
    if ours:
        raise AssertionError(f"the main path makes the host wait for the device: {ours}")
    say("sync-check", frames=10, syncs=syncs)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
