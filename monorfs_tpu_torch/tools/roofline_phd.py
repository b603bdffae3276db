"""Per-stage times of the PHD SLAM step against the card's ceilings (the
counterpart of the stage-timing half of tools/roofline_phd.py).

    python -m monorfs_tpu_torch.tools.roofline_phd [--particles 200,800,2000] [--reps 100]
        [--json out.json] [--device cpu]

For each particle count, over a state warmed by 100 frames of the 3D asset
world at the bench PHDConfig (K=128, 48 slots compacted to 24, gate_top 8,
beam 32 x 6, merge_rounds 4), times the stages births, correct + prune,
the fused kernel, the weight inputs, the beam kernel and the full step by
CUDA events around `--reps` calls.

The ceilings are measured on the card: a large float32 matmul with TF32 off
(the package turns it off) and a large elementwise stream (one read and one
write a float). XLA's cost model has no counterpart here: the two kernels'
work (the bytes each launch must move and the fp32 operations its data
needs) comes from kernel_bounds, the functions chip_smoke.py counts with,
and their rows give the bound against both the measured ceilings and the
published peaks and the share of it reached. Every other stage reports its
time only, and says so."""

import argparse
import json

import torch

from .. import kernel_bounds, resolve_device
from ..bench_isam2 import card
from ..gm import mixture
from ..slam import beam_kernel, fused_kernel, phd
from .profile_phd import call_ms, random_measurements, step_inputs, warm_state

TIME_ONLY = "time only: no work count for this stage"


def roofline_config(particles):
    """tools/roofline_phd.py:205-209: the bench PHDConfig."""
    return phd.PHDConfig(
        num_particles=particles, max_components=128, max_measurements=48, gate_top=8,
        estimate_cap=48, beam_width=32, beam_meas_cap=24, beam_candidates=6, merge_rounds=4,
        meas_compact=24,
    )


def measure_ceilings(device, n=8192, stream_mb=1024, reps=20):
    """(fp32 matmul FLOP/s, stream bytes/s) achieved on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.rand((n, n), generator=gen, device=device)
    b = torch.rand((n, n), generator=gen, device=device)
    out = torch.empty_like(a)
    ms, _ = call_ms(lambda: torch.mm(a, b, out=out), reps, device)
    flops = 2 * n ** 3 / (ms * 1e-3)
    m = stream_mb * 2 ** 20 // 4
    x = torch.ones((m,), device=device)
    y = torch.empty_like(x)
    ms, _ = call_ms(lambda: torch.add(x, 1.0, out=y), reps, device)
    return flops, 2 * 4 * m / (ms * 1e-3)


def kernel_row(name, ms, work, flops, bytes_s):
    """A kernel stage's bound against the measured ceilings and the
    published peaks."""
    nbytes, ops = work
    sol, by = kernel_bounds.bound(nbytes, ops, bytes_s, flops)
    pub, pub_by = kernel_bounds.bound(nbytes, ops)
    return dict(stage=name, ms=ms, mbytes=nbytes / 1e6, mflop=ops / 1e6, bound_ms=sol, bound_by=by,
                share_of_bound=sol / ms, published_bound_ms=pub, published_bound_by=pub_by)


def profile_count(p, reps, dev, flops, bytes_s, warm=100):
    pcfg = roofline_config(p)
    runner, carry = warm_state(pcfg, warm, dev)
    model, params, state = runner.model, runner.nparams, carry.nstate
    z, z_mask = random_measurements(pcfg.max_measurements, 12, torch.float32, dev)
    mcap = pcfg.meas_compact or pcfg.max_measurements
    zc, zc_mask = z[:mcap], z_mask[:mcap]
    zl = [zc[:, i] for i in range(model.meas_dim)]
    pose, maps = state.pose, state.maps
    predicted = mixture.concat_soa(maps, phd._births_soa(model, params, pose, maps, zl, zc_mask))
    corrected = phd._correct_prune_soa(model, pcfg, params, pose, predicted, zl, zc_mask)
    rest, base, od, wk, bk = phd.weight_inputs(model, pcfg, params, pose, predicted, corrected, zc, zc_mask)
    n_words = (pcfg.estimate_cap + 31) // 32
    step = phd.make_slam_step(model, pcfg, slam=True)
    odo, normals, u = step_inputs(runner, torch.float32)
    kpred, kcor = fused_kernel.fused_stage(model, pcfg, params, pose, maps, zc, zc_mask)
    k0 = pcfg.max_components
    fused_work = kernel_bounds.fused_work(p, k0, mcap, model.meas_dim, model.pose.state_dim, maps, kpred,
                                          zc_mask, kcor, params)
    beam_work = kernel_bounds.beam_work((base, od, wk, bk), pcfg.beam_width)

    rows = []
    for name, fn, work in (
        ("births", lambda: phd._births_soa(model, params, pose, maps, zl, zc_mask), None),
        ("correct+prune",
         lambda: phd._correct_prune_soa(model, pcfg, params, pose, predicted, zl, zc_mask), None),
        ("fused kernel", lambda: fused_kernel.fused_stage(model, pcfg, params, pose, maps, zc, zc_mask),
         fused_work),
        ("weight inputs",
         lambda: phd.weight_inputs(model, pcfg, params, pose, predicted, corrected, zc, zc_mask), None),
        ("beam kernel", lambda: beam_kernel.beam_scan_batch(base, od, wk, bk, pcfg.beam_width, n_words),
         beam_work),
        ("full step", lambda: step(params, state, odo, z, z_mask, normals, u), None),
    ):
        ms, timer = call_ms(fn, reps, dev)
        row = kernel_row(name, ms, work, flops, bytes_s) if work else dict(stage=name, ms=ms, note=TIME_ONLY)
        row.update(particles=p, timer=timer,
                   alive_components=float(mixture.count(maps).float().mean()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-roofline-phd")
    ap.add_argument("--particles", default="200,800,2000")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--warm", type=int, default=100, help="frames run before the stages are timed")
    ap.add_argument("--ceiling-n", type=int, default=8192, help="the ceiling matmul's size")
    ap.add_argument("--stream-mb", type=int, default=1024, help="the ceiling stream's size in MiB")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    flops, bytes_s = measure_ceilings(dev, args.ceiling_n, args.stream_mb, min(args.reps, 20))
    head = {"tool": "roofline_phd", "device": str(dev), "card": card(dev),
            "tf32": torch.backends.cuda.matmul.allow_tf32, "fp32_matmul_tflops": flops / 1e12,
            "stream_gbs": bytes_s / 1e9,
            "published_peaks": {"fp32_tflops": kernel_bounds.FP32_OPS_S / 1e12,
                                "hbm_gbs": kernel_bounds.HBM_BYTES_S / 1e9}}
    print(json.dumps(head), flush=True)
    rows = []
    for p in [int(x) for x in args.particles.split(",")]:
        rows += profile_count(p, args.reps, dev, flops, bytes_s, args.warm)
    result = dict(head, rows=rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
