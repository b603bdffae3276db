"""One run of one cell: set-up, the measured window, the check, one line.

    python3 rfsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up starts CUDA, builds the cell's inputs from the seed, and runs a throwaway
sequence at the cell's shapes, which loads the port's kernel library (built
into build/kernels/ in the checkout at a checkout's first run) and every
kernel the window takes. The window starts a fresh sequence at its first
frame; a sequence that ends is followed by the next one, built inside the
window as a user's next run would be. With --trace 1 a steady slice of the
window runs under torch.profiler and the line carries the per-layer
metrics; otherwise the end-to-end ones. After the window the sampled frames
are worked out again by the reference (check.py) and `correct` says whether
every number is within its limit; the numbers and limits are printed last on
standard error and under `checks`, last in the line."""

import argparse
import importlib.util
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "monorfs_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="rfsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def forbidden_modules(names=None):
    """The top-level names among `names` (the loaded modules by default)
    that are one of FORBIDDEN, compared whole (monorfs_tpu_torch is not
    monorfs_tpu)."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def cache_dirs(root):
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


class Run:
    """What the metric readers read (metrics/__init__.py)."""

    def __init__(self):
        self.frames = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.traced = False
        self.trace = None
        self.work = []
        self.shapes = {}
        self.peaks = {}


def read_metric(bench_dir, name, run):
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "rfsbench.metrics." + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def cell_metrics(bench, cell_name, traced):
    """The names of the metrics this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return [m["name"] for m in e2e], {m["name"]: m["unit"] for m in e2e}
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return [m["name"] for m in per], {m["name"]: m["unit"] for m in per}


def main(argv=None, t_start=None, device_name="cuda", window_hook=None, cell=None):
    """Runs the cell; returns the process's exit code. device_name "cpu"
    (the tests' rehearsal only) skips the look for a card and reports no
    device metric. window_hook(sim) may replace the port's step (the
    tests' planted faults); cell: (BENCHMARK.json, cell, configuration,
    traffic) in place of the files (the tests' small cells)."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    from . import harness

    root = harness.ROOT
    cache_dirs(root)
    bench, cell, config, traffic = cell or harness.load_cell(args.workload)

    import torch

    on_card = device_name != "cpu"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"rfsbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    try:
        import monorfs_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as err:
        print(f"rfsbench: the port is not importable here: {err}", file=sys.stderr)
        return 4
    from torch.profiler import ProfilerActivity, profile

    from . import check, trace as trace_mod
    from .work import frame as work_frame
    from .work.kernels import fused_work, least_ms

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])

    device = torch.device("cuda:0" if on_card else "cpu")
    marks = [("imports", time.time() - t_start)]
    inputs = harness.Inputs(config, traffic, args.seed, device)
    program = harness.Program(inputs, device)
    marks.append(("inputs", time.time() - t_start))

    # warm-up: a throwaway sequence at the cell's shapes (its own seed)
    warm = traffic["warmup_frames"]
    warm_inputs = harness.Inputs(config, traffic, harness.seq_seed(args.seed, 0, 9), device)
    sim, commands = program.simulation(warm_inputs.draws(0, warm), frames=warm)
    if window_hook:
        window_hook(sim)
    for cmd in commands:
        sim.step(cmd)
    del sim
    if on_card:
        torch.cuda.synchronize()

    sample = check.sample(inputs, traffic, args.seed)
    sample_set = set(sample)
    capture = harness.Capture()
    kept_draws = {}
    tr = traffic["trace"]
    traced = bool(args.trace)
    prof, trace_obj, trace_from, tries = None, None, tr["skip_frames"], 0

    run = Run()
    run.traced = traced
    seq, frames = 0, 0
    t0 = time.time()
    run.setup_s = t0 - t_start
    marks.append(("warm-up", run.setup_s))
    deadline = t0 + args.seconds
    while True:
        draws = inputs.draws(seq)
        if any(s == seq for s, _ in sample):
            kept_draws[seq] = draws
        sim, commands = program.simulation(draws)
        if window_hook:
            window_hook(sim)
        capture.attach(sim)
        for t, cmd in enumerate(commands):
            if traced and trace_obj is None and prof is None and frames == trace_from:
                if on_card:
                    torch.cuda.synchronize()
                prof = profile(activities=activities)
                prof.__enter__()
                trace_t0, trace_n = time.perf_counter(), 0
            keys = [(seq, t)] if (seq, t) in sample_set else []
            if prof is not None and trace_n in tr["work_frames"]:
                keys.append(("work", trace_n))
            if keys:
                capture.before(keys, sim)
            sim.step(cmd)
            capture.after(sim)
            frames += 1
            if prof is not None:
                trace_n += 1
                if trace_n == tr["frames"]:
                    if on_card:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - trace_t0
                    t_reduce = time.time()
                    prof.__exit__(None, None, None)
                    got = trace_mod.Trace(prof, trace_n, wall)
                    prof, tries = None, tries + 1
                    # the trace's reduction on the host is no part of the window
                    t_reduce = time.time() - t_reduce
                    t0, deadline = t0 + t_reduce, deadline + t_reduce
                    if len(got.kernels("beam")) >= trace_n or tries >= 3:
                        trace_obj = got
                    else:  # the tracer lost leading events: take the next slice
                        print(f"rfsbench: traced slice {tries} has {len(got.kernels('beam'))} beam "
                              f"launches for {trace_n} frames; tracing again", file=sys.stderr)
                        for key in [k for k in capture.frames if k[0] == "work"]:
                            del capture.frames[key]
                        trace_from = frames
            if time.time() >= deadline and prof is None:
                break
        else:
            del sim
            seq += 1
            continue
        del sim
        break
    if on_card:
        torch.cuda.synchronize()
    run.window_s = time.time() - t0
    run.frames = frames
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    found = forbidden_modules()
    if found:
        print(f"rfsbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 5

    # ---- the check ------------------------------------------------------------
    t_check = time.time()
    judge = check.Judge(inputs, traffic["limits"], device)
    for key in sorted(k for k in capture.frames if k[0] != "work"):
        s, t = key
        cap = capture.frames[key]
        if "post" not in cap:
            continue
        draws_t = {k: v[t] for k, v in kept_draws[s].items()}
        judge.frame(s, t, draws_t, cap)
        capture.frames[key] = None
    numbers = judge.numbers()
    correct = judge.correct()

    # ---- per-layer readings --------------------------------------------------
    run.peaks = json.loads((harness.BENCH / "peaks.json").read_text())
    cfg = judge.cfg
    m = config["phd"]["max_measurements"]
    run.shapes = dict(P=inputs.particles, K0=cfg.max_components, M=cfg.beam_meas_cap or m,
                      B=cfg.beam_width, C=min(cfg.beam_candidates, cfg.estimate_cap),
                      n_words=(cfg.estimate_cap + 31) // 32)
    if trace_obj is not None:
        run.trace = trace_obj
        caps = {k[1]: v for k, v in capture.frames.items() if k[0] == "work" and v and "post" in v}
        run.work = frame_work(judge, caps, run.peaks, work_frame, fused_work, least_ms)

    names, units = cell_metrics(bench, cell["name"], traced)
    metrics = {}
    for name in names:
        value = read_metric(harness.BENCH, name, run)
        if value is not None and on_card:  # a CPU rehearsal reports no metric
            metrics[name] = {"value": float(value), "unit": units[name]}

    line = {
        "correct": bool(correct),
        "attempted": frames,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if traced and run.trace is not None and on_card:
        line["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        line["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    for row in judge.frames:
        keys = ("seq", "t") + check.NUMBERS + check.DIAGNOSTICS
        print("rfsbench: frame " + json.dumps({k: row[k] for k in keys}), file=sys.stderr)
    print(f"rfsbench: frames {frames} in {run.window_s:.3f} s, set-up {run.setup_s:.3f} s "
          f"({', '.join(f'{k} by {v:.3f}' for k, v in marks)}), {len(judge.frames)} frames checked "
          f"in {time.time() - t_check:.3f} s", file=sys.stderr)
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def frame_work(judge, caps, peaks, work_frame, fused_work, least_ms):
    """Work counts of the traced frames in `caps` ({index in the slice:
    capture}): the reference's predicted and corrected maps of each (the
    port's semantics, in the port's precision, from the port's state and the
    measurement set its step received), counted by work/."""
    import torch

    from .reference import frame as ref
    from .reference import phd as ref_phd
    from .reference.mixture import SGM

    config, model, cfg, dev = judge.config, judge.model, judge.cfg, judge.device
    dt = torch.float32
    params = ref.phd_params(config, dt, dev)
    rows = []
    for idx, cap in sorted(caps.items()):
        pre = cap["pre"]
        _, z, z_mask = cap["vehicle"]
        z, z_mask = z.to(dev, dt), z_mask.to(dev)
        p = pre.pose.shape[0]
        preds, cors = [], []
        for lo in range(0, p, 250):
            r = slice(lo, min(p, lo + 250))
            pose = pre.pose[r].to(dev, dt)
            maps = SGM(*[leaf[r].to(dev, dt) for leaf in pre.maps])
            pred, cor = ref_phd.fused_stage_plain(model, cfg, params, pose, maps, z, z_mask)
            preds.append(pred)
            cors.append(cor)
        pred = [torch.cat([x[i] for x in preds]) for i in range(len(SGM._fields))]
        cor = [torch.cat([x[i] for x in cors]) for i in range(len(SGM._fields))]
        maps = [leaf.to(dev, dt) for leaf in pre.maps]
        m = z.shape[0]
        radius = float(params.density_radius)
        ops = work_frame.stage_ops(p, model.pose.odo_dim, maps, pred, z_mask, cor, radius, m,
                                   cfg.estimate_cap, cfg.beam_width, cfg.beam_candidates,
                                   (cfg.estimate_cap + 31) // 32)
        work = fused_work(p, cfg.max_components, m, model.meas_dim, pre.pose.shape[1], maps, pred,
                          z_mask, cor, radius)
        rows.append({"index": idx, "ops": ops, "fused_ms": least_ms(*work, peaks)[0]})
    return rows
