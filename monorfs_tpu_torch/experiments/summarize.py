"""Collect a grid's *.stats.json into one markdown summary table (the
counterpart of experiments/summarize.py: the same stats files give the same
text).

    python -m monorfs_tpu_torch.experiments.summarize [DIR]   (default experiments/out-h100)

For a grid run on a card (its rows carry `_device`, written by
run_gpu_grid.py) the header names the card and its power limit, the thesis
grid of run_experiments.py (DIR's sibling `out-h100-grid`) gets a table of
its own, and every row is held against the JAX package's row for the same
experiment and algorithm: the TPU float32 row (experiments/out-tpu) where
there is one, else the CPU row (experiments/out), and for the thesis
grid's rows the CPU row first (the same particle counts). A row passes with ATE
below twice the reference's and OSPA below the reference's + 0.1; the
dead-reckoning rows over the same numpy-seeded recording (chap4-k9) must
equal the reference to its printed digits. Only ATE and OSPA of the JAX rows
are shown, never their times."""

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "experiments"
NOTES_FILE = HERE / "NOTES.md"
JAX_TPU = HERE / "out-tpu"
JAX_CPU = HERE / "out"
THESIS_GRID = "out-h100-grid"  # run_experiments.py's default beside run_gpu_grid.py's out-h100
EXACT_ROWS = {("chap4-k9", "odometry")}  # dead reckoning over numpy-seeded commands


def fmt(v, nd=4):
    if v is None:
        return "—"
    if isinstance(v, str):
        return v
    return f"{float(v):.{nd}g}"


def load(outdir):
    """[(experiment, stats)] of a directory's *.stats.json, by name."""
    return [(f.name.replace(".stats.json", ""), json.load(open(f)))
            for f in sorted(pathlib.Path(outdir).glob("*.stats.json"))]


def table_lines(grid):
    """The table rows of the JAX summarize's first table."""
    lines = []
    for exp, stats in grid:
        for alg, s in stats.items():
            if not isinstance(s, dict):
                continue
            loc, rot = s.get("ate_loc_rmse"), s.get("ate_rot_rmse")
            ospa, el = s.get("final_ospa", s.get("ospa_vs_refmap")), s.get("elapsed_s")
            frames, mm = s.get("frames"), s.get("mean_measurements")
            fps, step_ms, s_ate = s.get("fps"), s.get("step_ms"), s.get("ate_rmse_loc")
            if fps is not None:
                lines.append(
                    f"| {exp} | {alg} | fps={fmt(fps, 4)} "
                    f"step={fmt(step_ms, 4)} ms | {fmt(s_ate)} | — | — |"
                )
                continue
            if loc is None and frames is not None:
                lines.append(
                    f"| {exp} | {alg} | frames={frames} "
                    f"mean_meas={fmt(mm, 3)} | — | — | — |"
                )
            else:
                lines.append(
                    f"| {exp} | {alg} | {fmt(loc)} | {fmt(rot)} | {fmt(ospa)} "
                    f"| {fmt(el, 4)} |"
                )
    return lines


def tpu_lines(tpu_dir):
    """The JAX summarize's section for a sibling out-tpu directory."""
    lines = [
        "",
        "## TPU float32 grid (experiments/out-tpu, run_tpu_grid.py)",
        "",
        "Reference-scale particle counts through the jitted float32 hot "
        "path on the real chip (chap3/S1-phd-odometry.sh:13 uses 800; "
        "chap3/S4-particles.sh:14 sweeps 20/100/800/2000).",
        "",
        "| experiment | algorithm/particles | ATE loc RMSE | "
        "ATE rot RMSE | final OSPA | elapsed s |",
        "|---|---|---|---|---|---|",
    ]
    for exp, stats in load(tpu_dir):
        for alg, s in stats.items():
            if not isinstance(s, dict):
                continue
            if s.get("fps") is not None:
                # throughput sweep rows (compile-free scan fps)
                lines.append(
                    f"| {exp} | {alg} | fps={fmt(s.get('fps'), 4)} "
                    f"step={fmt(s.get('step_ms'), 4)} ms "
                    f"| {fmt(s.get('ate_rmse_loc'))} | — | — |"
                )
                continue
            lines.append(
                f"| {exp} | {alg} | {fmt(s.get('ate_loc_rmse'))} "
                f"| {fmt(s.get('ate_rot_rmse'))} "
                f"| {fmt(s.get('final_ospa', s.get('ospa_vs_refmap')))} "
                f"| {fmt(s.get('elapsed_s'), 4)} |"
            )
    return lines


def _ate(s):
    return s.get("ate_loc_rmse", s.get("ate_rmse_loc"))


def _ospa(s):
    return s.get("final_ospa", s.get("ospa_vs_refmap"))


def reference_row(exp, alg, thesis=False):
    """(source, the JAX package's row) for one experiment and algorithm:
    the TPU float32 grid's where it has one, else the CPU grid's; for a row
    of the thesis grid the CPU grid's first (the same experiment at the
    same particle counts)."""
    order = (("TPU f32", JAX_TPU), ("CPU", JAX_CPU))
    for name, d in (order[::-1] if thesis else order):
        f = d / f"{exp}.stats.json"
        if f.is_file():
            row = json.load(open(f)).get(str(alg))
            if isinstance(row, dict) and _ate(row) is not None:
                return name, row
    return None, None


def held(exp, alg, s, thesis=False):
    """(reference source, reference row, verdict, limits) of one row."""
    src, ref = reference_row(exp, alg, thesis)
    ate, ospa = _ate(s), _ospa(s)
    if ref is None or ate is None:
        return src, ref, "no reference", None
    r_ate, r_ospa = _ate(ref), _ospa(ref)
    if (exp, str(alg)) in EXACT_ROWS:
        ok = fmt(ate) == fmt(r_ate) and (r_ospa is None or fmt(ospa) == fmt(r_ospa))
        return src, ref, "pass" if ok else "MISS", "equal to its digits"
    # a mapping-only row pins every pose: ATE exactly 0 on both sides
    ok = (ate < 2 * r_ate if r_ate else ate == 0) and (r_ospa is None or ospa is None or ospa < r_ospa + 0.1)
    limits = (f"ATE < {fmt(2 * r_ate)}" if r_ate else "ATE = 0") + (
        "" if r_ospa is None else f", OSPA < {fmt(r_ospa + 0.1)}")
    return src, ref, "pass" if ok else "MISS", limits


def held_lines(grids):
    lines = [
        "",
        "## Held against the JAX package",
        "",
        "Each row against the JAX package's row for the same experiment and "
        "algorithm: run_gpu_grid's against its TPU float32 grid where there "
        "is one, else its CPU grid; run_experiments' against its CPU grid "
        "(the same experiment at the same particle counts). ATE < 2x and "
        "OSPA < OSPA + 0.1; dead reckoning over the same numpy-seeded "
        "commands (chap4-k9) equal to its digits.",
        "",
        "| grid | experiment | algorithm | ATE | OSPA | JAX row | JAX ATE | JAX OSPA | limits | verdict |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for label, grid in grids:
        for exp, stats in grid:
            for alg, s in stats.items():
                if not isinstance(s, dict) or _ate(s) is None:
                    continue
                src, ref, verdict, limits = held(exp, alg, s, label == THESIS_GRID)
                lines.append(
                    f"| {label} | {exp} | {alg} | {fmt(_ate(s))} | {fmt(_ospa(s))} | {src or '—'} "
                    f"| {fmt(_ate(ref) if ref else None)} | {fmt(_ospa(ref) if ref else None)} "
                    f"| {limits or '—'} | {verdict} |"
                )
    return lines


def main(outdir=None):
    outdir = pathlib.Path(outdir or HERE / "out-h100")
    grid = load(outdir)
    devices = sorted({stats["_device"] for _, stats in grid if isinstance(stats.get("_device"), str)})
    lines = [
        "# Experiment grid results",
        "",
        "Reference grids: mono-rfs/plots/scripts/chap{3,4,5}/*.sh "
        "(see experiments/run_experiments.py).",
    ]
    if devices:
        lines += ["", "Run by the PyTorch/CUDA port (monorfs_tpu_torch/experiments/, float32 with both "
                  "hand-written kernels on every PHD leg, the graph legs float64) on: "
                  + "; ".join(devices) + "."]
    lines += [
        "",
        "| experiment | algorithm | ATE loc RMSE | ATE rot RMSE | "
        "final OSPA | elapsed s |",
        "|---|---|---|---|---|---|",
    ]
    lines += table_lines(grid)
    if devices:
        grids = [(outdir.name, grid)]
        thesis = load(outdir.parent / THESIS_GRID) if outdir.name != THESIS_GRID else []
        if thesis:
            lines += [
                "",
                f"## The thesis grid on the same card (experiments/{THESIS_GRID}, run_experiments.py)",
                "",
                "The JAX package's CPU grid rerun by the port on the card, float32 (the graph "
                "legs float64), at the CPU grid's particle counts.",
                "",
                "| experiment | algorithm | ATE loc RMSE | ATE rot RMSE | final OSPA | elapsed s |",
                "|---|---|---|---|---|---|",
            ]
            lines += table_lines(thesis)
            grids.append((THESIS_GRID, thesis))
        lines += held_lines(grids)
    else:
        tpu_dir = outdir.parent / "out-tpu"
        if tpu_dir.is_dir() and list(tpu_dir.glob("*.stats.json")):
            lines += tpu_lines(tpu_dir)

    notes = NOTES_FILE
    if notes.is_file():
        if devices:
            lines += ["", "## Notes of the JAX package's grids (experiments/NOTES.md)"]
        lines += ["", notes.read_text().rstrip()]

    out = outdir / "SUMMARY.md"
    out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwritten to {out}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
