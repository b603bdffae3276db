"""The port's seeds of a grid row against the JAX package's seeds of the
same row, and whether the row closes.

    python -m monorfs_tpu_torch.experiments.seed_spread

Reads the port's seeds (experiments/out-h100/<exp>.seeds.json, written by
run_gpu_grid --seeds, and for chap3-s4 by run_experiments --seeds) and the
JAX package's seeds of the same experiment on its CPU (seeds 0-2 of the
chap5 rows in experiments/out/<exp>.seeds.json, the others in
experiments/out-jax-cpu/<exp>.seeds.json, written by
experiments/run_experiments.py --seeds; chap3-s4's seed 0 there is the
20-particle row of experiments/out/chap3-s4.stats.json and seeds 1-19 ran
the 20-particle leg alone, chap3_s4(outdir, sweep=(20,)) with SEED set, as
the port's seeds 10-19 did). chap3-s4 and chap5-s2 have seeds 0-19 of both
packages, the other rows 0-9. For each row below, on the metric
the row missed at seed 0, it prints both samples' mean, median, min-max,
quartiles and the seeds under the row's limits (summarize.held, the rule
every grid row is held to), a two-sided Mann-Whitney U test, and the
verdict of the rule fixed before the JAX seeds 3-9 were run: a row closes
when p >= 0.05 and the port's median lies within the JAX package's
interquartile range (numpy percentiles 25 and 75, linear); otherwise it
stays open. The last line is the same as JSON.
"""

import json

import numpy as np

from .summarize import HERE, JAX_CPU, THESIS_GRID, held

PORT = HERE / "out-h100"
JAX_MORE = HERE / "out-jax-cpu"
# (experiment, algorithm, metric the row missed at seed 0, grid): the rows
# the grids missed at seed 0 whose seeds both packages have run;
# run_experiments' (THESIS_GRID) chap5 rows are the run_gpu_grid runs, and
# chap3-s4's stats are keyed by particle count
ROWS = [
    ("chap3-s4", "20", "ate_loc_rmse", THESIS_GRID),
    ("chap5-s2", "phd", "final_ospa", "out-h100"),
    ("chap5-k3", "loopy", "final_ospa", "out-h100"),
    ("chap5-k3", "loopy", "final_ospa", THESIS_GRID),
    ("chap5-k4", "phd", "final_ospa", "out-h100"),
    ("chap5-k4", "loopy", "ate_loc_rmse", "out-h100"),
    ("chap5-k4", "loopy", "ate_loc_rmse", THESIS_GRID),
]


def seeds(*files):
    """{seed: stats} of the *.seeds.json among files that exist."""
    out = {}
    for f in files:
        if f.is_file():
            out.update({int(k): v for k, v in json.load(open(f)).items()})
    return dict(sorted(out.items()))


def spread(values):
    v = np.asarray(values, float)
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    return dict(n=len(v), mean=float(v.mean()), median=float(med), min=float(v.min()),
                max=float(v.max()), q1=float(q1), q3=float(q3))


def compare(exp, alg, metric, grid):
    from scipy.stats import mannwhitneyu

    port = seeds(PORT / f"{exp}.seeds.json")
    jax = seeds(JAX_CPU / f"{exp}.seeds.json", JAX_MORE / f"{exp}.seeds.json")
    thesis = grid == THESIS_GRID
    under = lambda runs: sum(held(exp, alg, s[alg], thesis)[2] == "pass" for s in runs.values())
    p_vals, j_vals = [s[alg][metric] for s in port.values()], [s[alg][metric] for s in jax.values()]
    p_stat, j_stat = spread(p_vals), spread(j_vals)
    test = mannwhitneyu(p_vals, j_vals, alternative="two-sided")
    closes = test.pvalue >= 0.05 and j_stat["q1"] <= p_stat["median"] <= j_stat["q3"]
    return dict(experiment=exp, algorithm=alg, metric=metric, grid=grid,
                limits=held(exp, alg, port[0][alg], thesis)[3],
                port_seeds=sorted(port), jax_seeds=sorted(jax), port=p_stat, jax=j_stat,
                port_under_limits=under(port), jax_under_limits=under(jax),
                u=float(test.statistic), p=float(test.pvalue), closes=bool(closes))


def main():
    rows = [compare(*r) for r in ROWS]
    print("| grid | row (metric) | limits | port: mean, median, min-max, under | "
          "JAX CPU: mean, median, IQR, min-max, under | U, p | verdict |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        p, j = r["port"], r["jax"]
        print(f"| {r['grid']} | {r['experiment']} {r['algorithm']} ({r['metric']}) | {r['limits']} "
              f"| {p['mean']:.4f}, {p['median']:.4f}, {p['min']:.4f}-{p['max']:.4f}, "
              f"{r['port_under_limits']} of {p['n']} "
              f"| {j['mean']:.4f}, {j['median']:.4f}, {j['q1']:.4f}-{j['q3']:.4f}, "
              f"{j['min']:.4f}-{j['max']:.4f}, {r['jax_under_limits']} of {j['n']} "
              f"| {r['u']:g}, {r['p']:.3f} | {'closes' if r['closes'] else 'open'} |")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
