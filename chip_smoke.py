#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (monorfs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device, `nvidia-smi` name and power limit, kernel build (nvcc, sm_90a);
  2. beam kernel vs its plain version at the bench shape: bit-identical;
  3. fused kernel vs its plain version on warm random states at the bench
     shape (and a cap-binds state): predicted rtol/atol 2e-5, corrected
     component sets to the tolerances of tests/test_fused_pallas.py;
  4. the main path: run_benchmark at the bench.py config (200 particles,
     K=128, 48 -> 24 measurement slots, beam 32 x 6, 300 frames), with both
     kernels launched once per frame and ATE below 0.03.
  5. no host synchronisation: 10 frames of the main path after warm-up under
     torch.cuda.set_sync_debug_mode("warn"), none from the port's code.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from monorfs_tpu_torch import _build
from monorfs_tpu_torch.bench import BENCH_CONFIG, run as run_bench
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm.mixture import DEAD, SGM
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.profile_step import host_syncs, in_package
from monorfs_tpu_torch.slam import association, beam_kernel, fused_kernel

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_S = 67e12  # H100 SXM fp32 outside the tensor cores
ATE_LIMIT = 0.03  # ~3x the JAX package's 0.0108 on this config


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, timed with CUDA events
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---- phase 2: beam ---------------------------------------------------------------

def beam_phase(dev):
    p, n, m, c, b = 200, BENCH_CONFIG.estimate_cap, BENCH_CONFIG.beam_meas_cap, \
        BENCH_CONFIG.beam_candidates, BENCH_CONFIG.beam_width
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ll = torch.randn((p, n, m), generator=g, device=dev) * 3
    ll = torch.where(torch.rand((p, n, m), generator=g, device=dev) < 0.7,
                     torch.full_like(ll, association.NEG), ll)
    log_miss = torch.randn((p, n), generator=g, device=dev) * 0.5 - 1
    n_mask = torch.rand((p, n), generator=g, device=dev) < 0.8
    m_mask = torch.rand((p, m), generator=g, device=dev) < 0.8
    base, od, wk, bk, n_words = association.prepare_options(ll, log_miss, -2.5, n_mask, m_mask, c)
    out = beam_kernel.beam_scan_batch(base, od, wk, bk, b, n_words)
    ref = beam_kernel.beam_scan_plain(base, od, wk, bk, b, n_words)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not torch.equal(out, ref):
        raise AssertionError(f"beam kernel differs from plain: max |d| {err}")
    ms = cuda_ms(lambda: beam_kernel.beam_scan_batch(base, od, wk, bk, b, n_words), 50)
    plain_ms = cuda_ms(lambda: beam_kernel.beam_scan_plain(base, od, wk, bk, b, n_words), 5)
    nbytes = 4 * (base.numel() + od.numel() + wk.numel() + bk.numel() + p * b)
    n = b * (c + 1)
    # per step, what a top-B selection needs: n candidate sums, B*C used-set
    # ANDs, and n + B*log2(n) compares to pick the best B in order
    ops = p * od.shape[1] * (n + b * c + n + b * int(np.ceil(np.log2(n))))
    bms, by = bound(nbytes, ops)
    say("beam", equal=True, ms=ms, plain_ms=plain_ms, launches=beam_kernel.beam_scan_batch.launches,
        shape=dict(P=p, M=m, C=c, B=b, n_words=n_words))
    return dict(name="beam_scan", route="cuda", source="monorfs_tpu_torch/csrc/beam_scan.cu",
                replaces="monorfs_tpu/slam/beam_pallas.py:178", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


# ---- phase 3: fused --------------------------------------------------------------

def warm_state(seed, p, k0, m, n_lm, dev):
    """A warm random filter state: landmark-like components + noise (the
    construction of tests/test_fused_pallas.py, on the torch model)."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-0.8, 0.8, (n_lm, 3))
    lm[:, 2] = rng.uniform(0.4, 1.6, n_lm)
    mean = np.zeros((p, k0, 3))
    logw = np.full((p, k0), DEAD)
    for i in range(p):
        idx = rng.permutation(k0)[:n_lm]
        mean[i, idx] = lm + rng.normal(0, 0.03, lm.shape)
        logw[i, idx] = rng.uniform(-1.2, 0.4, n_lm)
    cov = np.full((p, k0), 0.02)
    zero = np.zeros((p, k0))
    leaves = [mean[..., 0], mean[..., 1], mean[..., 2], cov, zero, zero, cov, zero, cov, logw]
    maps = SGM(*[torch.tensor(x, dtype=torch.float32, device=dev) for x in leaves])
    pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0.0]), (p, 1))
    pose[:, :3] += rng.normal(0, 0.02, (p, 3))
    z = np.zeros((m, 3))
    n_live = min(n_lm, m - 2)
    zs = PRM3D.measure(PRM3D.params, torch.tensor(pose[0]), torch.tensor(lm)).numpy()
    z[:n_live] = zs[:n_live] + rng.normal(0, 1.0, (n_live, 3)) * np.array([2.0, 2.0, 0.01])
    z[n_live] = [5.0, -10.0, 1.2]  # clutter
    return (torch.tensor(pose, dtype=torch.float32, device=dev), maps,
            torch.tensor(z, dtype=torch.float32, device=dev),
            torch.tensor(np.arange(m) < n_live + 1, device=dev))


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


def fused_phase(dev):
    cfg = Config()
    params = cfg.phd_params(torch.float32, dev)
    p, k0 = 200, BENCH_CONFIG.max_components
    m = BENCH_CONFIG.meas_compact
    cases = [("bench", BENCH_CONFIG, 0, 40), ("bench-seed3", BENCH_CONFIG, 3, 40)]
    cap_cfg = type(BENCH_CONFIG)(num_particles=p, max_components=16, max_measurements=m,
                                 gate_top=4, merge_rounds=4)
    cases.append(("cap-binds", cap_cfg, 7, 14))
    err = 0.0
    for name, pcfg, seed, n_lm in cases:
        pose, maps, z, z_mask = warm_state(seed, p, pcfg.max_components, m, n_lm, dev)
        pred, cor = fused_kernel.fused_stage(PRM3D, pcfg, params, pose, maps, z, z_mask)
        pred_ref, cor_ref = fused_kernel.fused_stage_plain(PRM3D, pcfg, params, pose, maps, z, z_mask)
        torch.cuda.synchronize()
        err = max(err, compare_fused(pred, cor, pred_ref, cor_ref))
        say("fused-check", case=name, ok=True, alive_out=int((cor.logw > DEAD / 2).sum().item()))
    pose, maps, z, z_mask = warm_state(0, p, k0, m, 40, dev)
    args = (PRM3D, BENCH_CONFIG, params, pose, maps, z, z_mask)
    ms = cuda_ms(lambda: fused_kernel.fused_stage(*args), 20)
    plain_ms = cuda_ms(lambda: fused_kernel.fused_stage_plain(*args), 3)
    pred, cor = fused_kernel.fused_stage(*args)
    kp = k0 + m
    nbytes = 4 * (10 * p * k0 + 7 * p + 3 * m + m + 28 + 10 * p * kp + 10 * p * k0)
    bms, by = bound(nbytes, fused_ops(maps, pred, z_mask, cor, params, m))
    say("fused", ms=ms, plain_ms=plain_ms, max_abs_err=err,
        launches=fused_kernel.fused_stage.launches,
        smem_bytes=fused_kernel.smem_bytes(k0, m), shape=dict(P=p, K0=k0, M=m, KP=kp))
    return dict(name="fused_stage", route="cuda", source="monorfs_tpu_torch/csrc/fused_stage.cu",
                replaces="monorfs_tpu/slam/fused_pallas.py:621", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


def main():
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
    regs = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln]
    say("build", seconds=time.perf_counter() - t0, library=lib.name, ptxas=regs,
        device=torch.cuda.get_device_name(0), torch=torch.__version__, cuda=torch.version.cuda)

    kernels = [beam_phase(dev), fused_phase(dev)]

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
