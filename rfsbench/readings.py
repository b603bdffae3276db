"""The readings the limits of `correct` are set from: for each seed, the
numbers of the port's sampled frames (the lower readings) and of the
control in the port's place at the same frames (the upper readings), in one
process. Not part of a benchmark run.

    python3 rfsbench/readings.py --workload <cell> --seeds 1,2,3 [--control bf16,tf32]
        [--fault collapse] [--out readings-<cell>.json]

Each seed runs the cell's sequences from their first frame as a run's
window does, far enough to reach every sampled frame (the run's own sample,
check.sample), then judges them; a frame's control starts from the same
state and inputs. With --fault the port runs with that fault planted
(faults.py) and its readings are the fault's."""

import argparse
import json
import pathlib
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from rfsbench import bench, check, faults, harness  # noqa: E402

CONTROLS = {"bf16": dict(dtype=torch.bfloat16), "tf32": dict(dtype=torch.float32, tf32=True)}


def seed_readings(name, seed, controls, device, cell=None, window_hook=None):
    _, _, config, traffic = cell or harness.load_cell(name)
    inputs = harness.Inputs(config, traffic, seed, device)
    program = harness.Program(inputs, device)
    sample = check.sample(inputs, traffic, seed)
    judges = {"port": check.Judge(inputs, traffic["limits"], device)}
    judges.update({c: check.Judge(inputs, traffic["limits"], device) for c in controls})
    for seq in sorted({s for s, _ in sample}):
        want = {t for s, t in sample if s == seq}
        draws = inputs.draws(seq)
        sim, commands = program.simulation(draws)
        capture = harness.Capture()
        if window_hook:
            window_hook(sim)
        capture.attach(sim)
        for t, cmd in enumerate(commands[: max(want) + 1]):
            if t in want:
                capture.before([t], sim)
            sim.step(cmd)
            capture.after(sim)
        del sim
        for t in sorted(want):
            cap = capture.frames[t]
            draws_t = {k: v[t] for k, v in draws.items()}
            judges["port"].frame(seq, t, draws_t, cap)
            for c in controls:
                cand = check.control_candidate(judges[c], seq, t, draws_t, cap, **CONTROLS[c])
                judges[c].frame(seq, t, draws_t, cap, candidate=cand)
    out = {}
    for who, judge in judges.items():
        out[who] = {k: v for k, (v, _) in judge.numbers().items()}
        out[who + "_frames"] = [{k: row[k] for k in ("seq", "t") + check.NUMBERS + check.DIAGNOSTICS + ("map_q",)}
                                for row in judge.frames]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rfsbench-readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="bf16")
    ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench.cache_dirs(harness.ROOT)
    device = torch.device(args.device)
    controls = [c for c in args.control.split(",") if c]
    hook = faults.FAULTS[args.fault] if args.fault else None
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        row = dict(seed=seed, **seed_readings(args.workload, seed, controls, device, window_hook=hook))
        row["seconds"] = time.time() - t0
        rows.append(row)
        print(json.dumps({k: row[k] for k in ["seed", "seconds", "port"] + controls}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    for who in ["port"] + controls:
        agg = {k: (min(r[who][k] for r in rows), max(r[who][k] for r in rows)) for k in rows[0][who]}
        print(who, json.dumps(agg), flush=True)


if __name__ == "__main__":
    main()
