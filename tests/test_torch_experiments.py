"""The port's experiment grids (monorfs_tpu_torch/experiments/) against the
JAX package's (experiments/run_experiments.py, run_tpu_grid.py,
summarize.py, imported by path), on the CPU:

- every non-Kinect experiment of both JAX grids issues the same command
  lines as its port (cli.main stubbed in both packages, analyze and
  plot_series stubbed in both modules), once --device is dropped;
- analyze gives the JAX analyze's stats over the JAX package's own chap5 s2
  recording in all three history modes, to 1e-9;
- summarize writes the JAX summarize's text over the JAX package's stats
  files, and holds a device grid's rows against the JAX rows;
- run_grid lays out seeds as the JAX run_grid does;
- two small end-to-end runs (20 frames): chap3-s2 mapping and chap4-s1 at 5
  particles, with the JAX function's keys and, over the same recordings,
  the JAX analyze's values."""

import argparse
import importlib.util
import json
import math
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

import monorfs_tpu.cli as jcli
import monorfs_tpu_torch.cli as tcli
from monorfs_tpu_torch.experiments import run_experiments as T
from monorfs_tpu_torch.experiments import run_gpu_grid as TG
from monorfs_tpu_torch.experiments import summarize as TS

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXP = ROOT / "experiments"
RECORDING = ROOT / "tests" / "data" / "chap5_s2_odometry_jax.zip"


def _by_path(name, path):
    """A JAX experiments script as the module `name` (run_tpu_grid.py
    imports run_experiments by that name)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


J = _by_path("run_experiments", EXP / "run_experiments.py")
JG = _by_path("run_tpu_grid", EXP / "run_tpu_grid.py")
JS = _by_path("summarize", EXP / "summarize.py")

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these runs are thousands of tiny eager ops,
    which threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINECT = {"chap3-k6", "chap3-k6real", "chap4-k9"}
CASES = ([("run_experiments", n) for n in J.EXPERIMENTS if n not in KINECT]
         + [("run_tpu_grid", n) for n in JG.EXPERIMENTS if n != "throughput"])


def _drop_device(argv):
    i = argv.index("--device")
    return argv[:i] + argv[i + 2 :]


def test_the_grids_have_the_jax_experiments():
    assert len(CASES) == 21
    assert list(T.EXPERIMENTS) == list(J.EXPERIMENTS)
    assert list(TG.EXPERIMENTS) == list(JG.EXPERIMENTS)


@pytest.mark.parametrize("grid,name", CASES)
def test_argv_parity(grid, name, tmp_path, monkeypatch):
    jfn = (J if grid == "run_experiments" else JG).EXPERIMENTS[name]
    tfn = (T if grid == "run_experiments" else TG).EXPERIMENTS[name]
    issued = {"jax": [], "port": []}
    monkeypatch.setattr(jcli, "main", lambda argv: issued["jax"].append(list(argv)))
    monkeypatch.setattr(tcli, "main", lambda argv: issued["port"].append(list(argv)))
    for mod in (J, T):
        monkeypatch.setattr(mod, "analyze", lambda *a, **k: {})
        monkeypatch.setattr(mod, "plot_series", lambda *a, **k: None)
    monkeypatch.setattr(T, "DEVICE", "cpu")
    jfn(tmp_path / "out")
    tfn(tmp_path / "out")
    assert issued["jax"]
    assert all(argv[argv.index("--device") + 1] == "cpu" for argv in issued["port"])
    assert [_drop_device(a) for a in issued["port"]] == issued["jax"]


@pytest.mark.parametrize("mode", ["timed", "filter", "smooth"])
def test_analyze_parity(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(T, "DEVICE", "cpu")
    stats = {}
    for who, mod in (("jax", J), ("port", T)):
        d = tmp_path / who
        d.mkdir()
        rec = d / "odometry.zip"
        shutil.copy(RECORDING, rec)
        stats[who] = mod.analyze(str(rec), d, mode=mode)
    assert stats["port"].keys() == stats["jax"].keys()
    for k, v in stats["jax"].items():
        np.testing.assert_allclose(stats["port"][k], v, rtol=0, atol=1e-9, err_msg=k)
    assert 0.5 < stats["jax"]["ate_loc_rmse"] < 2.0  # dead reckoning drifts (ATE 0.63 timed, JAX grid)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.data"))
    assert names and names == sorted(p.name for p in (tmp_path / "port").glob("*.data"))
    for name in names:
        a, b = (np.loadtxt(tmp_path / who / name, ndmin=2) for who in ("jax", "port"))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9, err_msg=name)


def _copy_stats(src, dst):
    dst.mkdir(parents=True)
    for f in src.glob("*.stats.json"):
        shutil.copy(f, dst)


@pytest.mark.parametrize("with_tpu", [False, True])
def test_summarize_text(with_tpu, tmp_path, capsys):
    for who in ("jax", "port"):
        _copy_stats(EXP / "out", tmp_path / who / "out")
        if with_tpu:
            _copy_stats(EXP / "out-tpu", tmp_path / who / "out-tpu")
    JS.main(str(tmp_path / "jax" / "out"))
    TS.main(tmp_path / "port" / "out")
    capsys.readouterr()
    jtext = (tmp_path / "jax" / "out" / "SUMMARY.md").read_text()
    assert (tmp_path / "port" / "out" / "SUMMARY.md").read_text() == jtext
    assert ("## TPU float32 grid" in jtext) == with_tpu
    assert "| chap3-s1 | phd |" in jtext


def test_summarize_holds_device_rows_against_jax(tmp_path, capsys):
    out = tmp_path / "out-h100"
    out.mkdir()
    card = "NVIDIA H100 80GB HBM3 (NVIDIA H100 80GB HBM3, 700.00 W); torch 2.x, CUDA 12.x"
    rows = {
        # the JAX TPU row: ATE 0.02023, OSPA 0.08123
        "chap3-s1": {"phd": {"ate_loc_rmse": 0.03, "ate_rot_rmse": 0.01, "final_ospa": 0.2},
                     "odometry": {"ate_loc_rmse": 0.1, "ate_rot_rmse": 0.02, "final_ospa": 1.0},
                     "_device": card, "_wall_s": 1.0},
        # the JAX CPU row: odometry ATE 0.007188 (numpy-seeded commands)
        "chap4-k9": {"odometry": {"frames": 24, "ate_loc_rmse": 0.0071884, "final_err_m": 0.01}},
    }
    for exp, stats in rows.items():
        (out / f"{exp}.stats.json").write_text(json.dumps(stats))
    thesis = tmp_path / TS.THESIS_GRID
    thesis.mkdir()
    (thesis / "chap3-s2.stats.json").write_text(json.dumps(
        {"phd-mapping": {"ate_loc_rmse": 0.0, "ate_rot_rmse": 0.0, "final_ospa": 0.05}}))
    # at 100 particles: the JAX CPU row (ATE 0.0445, OSPA 0.1085), not the TPU one at 800
    (thesis / "chap3-s1.stats.json").write_text(json.dumps(
        {"phd": {"ate_loc_rmse": 0.05, "ate_rot_rmse": 0.01, "final_ospa": 0.1}}))
    TS.main(out)
    capsys.readouterr()
    text = (out / "SUMMARY.md").read_text()
    assert card in text and "700.00 W" in text
    held = {tuple(c.strip() for c in line.split("|")[1:4]): line for line in text.splitlines()
            if line.startswith(("| out-h100 |", f"| {TS.THESIS_GRID} |"))}
    assert held[("out-h100", "chap3-s1", "phd")].endswith("| MISS |")  # OSPA 0.2 over 0.18123
    assert held[("out-h100", "chap3-s1", "odometry")].endswith("| pass |")
    assert held[("out-h100", "chap4-k9", "odometry")].endswith("| pass |")  # equal to its digits
    assert held[(TS.THESIS_GRID, "chap3-s2", "phd-mapping")].endswith("| pass |")
    assert "| CPU | 0.0445 |" in held[(TS.THESIS_GRID, "chap3-s1", "phd")]
    assert held[(TS.THESIS_GRID, "chap3-s1", "phd")].endswith("| pass |")
    assert "## TPU float32 grid" not in text  # no TPU time in a device grid's summary


def test_run_grid_seed_layout(tmp_path, capsys):
    def experiments(mod):
        def chap4_s1(outdir, variant="default"):
            (outdir / f"chap4-{variant}").mkdir(exist_ok=True)
            return {"phd": {"ate_loc_rmse": 0.1 * (1 + mod.SEED), "variant": variant}}

        def other(outdir):
            return {"odometry": {"final_ospa": 1.0, "seed": mod.SEED}}

        return {"chap4-s1": chap4_s1, "other": other}

    layouts = {}
    for who, mod in (("jax", J), ("port", T)):
        args = argparse.Namespace(experiment="all", outdir=str(tmp_path / who), seeds="0,2", variant="noisy")
        mod.run_grid(args, experiments(mod))
        assert mod.SEED == 0
        files = sorted(str(p.relative_to(tmp_path / who)) for p in (tmp_path / who).rglob("*"))
        contents = {}
        for f in files:
            p = tmp_path / who / f
            if p.is_file():
                data = json.loads(p.read_text())
                for row in data.values() if f.endswith(".seeds.json") else [data]:
                    row.pop("_wall_s")
                contents[f] = data
        layouts[who] = (files, contents)
    capsys.readouterr()
    assert layouts["port"] == layouts["jax"]
    files = layouts["jax"][0]
    assert {"chap4-noisy.stats.json", "chap4-noisy.seeds.json", "other.seeds.json", "seed2"} <= set(files)


@pytest.fixture
def cpu_grid(monkeypatch):
    """The port's grid on the CPU, every solve cut to 20 frames."""
    monkeypatch.setattr(T, "DEVICE", "cpu")
    plain = T.run_cli
    monkeypatch.setattr(T, "run_cli", lambda args: plain(list(args) + ["--frames", "20"]))
    monkeypatch.setattr(J, "run_cli", lambda args: 0.0)  # the JAX side reads the port's recordings


def _held_to_jax(tstats, jstats):
    assert tstats.keys() == jstats.keys()
    for alg, row in jstats.items():
        assert tstats[alg].keys() == row.keys(), alg
        for k, v in row.items():
            assert math.isfinite(tstats[alg][k]), (alg, k)
            np.testing.assert_allclose(tstats[alg][k], v, rtol=0, atol=1e-9, err_msg=f"{alg} {k}")


def test_chap3_s2_mapping_end_to_end(cpu_grid, tmp_path, capsys):
    stats = T.chap3_s2(tmp_path)
    _held_to_jax(stats, J.chap3_s2(tmp_path))
    capsys.readouterr()
    row = stats["phd-mapping"]
    # PERF.md section 2: mapping pins every pose (ATE 0); 3D maps OSPA < 0.25
    assert row["ate_loc_rmse"] == 0.0 and row["final_ospa"] < 0.25


def test_chap4_s1_end_to_end(cpu_grid, tmp_path, capsys):
    stats = T.chap4_s1(tmp_path, particles=5)
    _held_to_jax(stats, J.chap4_s1(tmp_path, particles=5))
    capsys.readouterr()
    # PERF.md section 2, the grid's CPU check (20 frames): ATE < 0.1; a map
    # under the linear worlds' OSPA 0.6; dead reckoning maps nothing (OSPA 1)
    for alg in ("phd", "isam2", "odometry"):
        assert stats[alg]["ate_loc_rmse"] < 0.1, alg
    assert stats["phd"]["final_ospa"] < 0.6 and stats["isam2"]["final_ospa"] < 0.6
    assert stats["odometry"]["final_ospa"] == 1.0
    assert (tmp_path / "chap4-default" / "isam2.zip.loc.data").is_file()
