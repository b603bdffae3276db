"""The port's single-card tools (monorfs_tpu_torch/tools/, bench_scaling) on
the CPU:

- smoother_lab against the JAX tools/smoother_lab.py over the first 10
  nodes of the JAX package's own chap5 s2 recording, 1 sweep, float64:
  every ATE it reports and the final OSPA to 1e-6 (the JAX values read at
  full precision where its metrics return them);
- isam2_lab against the JAX tools/isam2_lab.py over a 30-frame float64
  recording: the same promotions, the same final landmark count, ATE to
  1e-6;
- every other tool's main at a tiny size with --device cpu prints its JSON;
- every new entry point raises without a GPU unless given --device cpu."""

import importlib.util
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import monorfs_tpu.metrics as jmetrics
import monorfs_tpu.metrics.errors as jerrors
from monorfs_tpu_torch import bench_scaling
from monorfs_tpu_torch import cli as tcli
from monorfs_tpu_torch.experiments import run_experiments, run_gpu_grid
from monorfs_tpu_torch.io import Recording
from monorfs_tpu_torch.tools import (ablate, debug_loopy, isam2_lab, profile_phd, roofline_phd,
                                     scanda_profile, smoother_lab)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXP = ROOT / "experiments"
RECORDING = ROOT / "tests" / "data" / "chap5_s2_odometry_jax.zip"
CFG_2D = EXP / "configs" / "chap5-default2d.cfg"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these runs are thousands of tiny eager ops,
    which threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(monkeypatch):
    """Wrap the JAX metrics the tools call so their values are kept at full
    precision: ({"rmse": [...], "ospa": [...]})."""
    seen = {"rmse": [], "ospa": []}
    rmse, ospa = jmetrics.rmse, jerrors.ospa

    def rmse_kept(*a, **k):
        seen["rmse"].append(float(rmse(*a, **k)))
        return seen["rmse"][-1]

    def ospa_kept(*a, **k):
        out = ospa(*a, **k)
        seen["ospa"].append(float(out[0]))
        return out

    monkeypatch.setattr(jmetrics, "rmse", rmse_kept)
    monkeypatch.setattr(jerrors, "ospa", ospa_kept)
    return seen


def test_smoother_lab_against_jax(monkeypatch, capsys):
    argv = [str(RECORDING), "--frames", "10", "--sweeps", "1", "-g", str(CFG_2D)]
    seen = _recorded(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["smoother_lab.py"] + argv)
    _jax_tool("smoother_lab").main()
    jtext = capsys.readouterr().out
    port = smoother_lab.main(argv + ["--device", "cpu"])
    ptext = capsys.readouterr().out
    # the JAX tool's rmse calls: init, then each sweep's best and current, then final
    sweep = port["sweeps"][0]
    np.testing.assert_allclose([port["init_ate"], sweep["ate_best"], sweep["ate_cur"], port["final_ate"]],
                               seen["rmse"], rtol=0, atol=1e-6)
    np.testing.assert_allclose([port["final_ospa"]], seen["ospa"], rtol=0, atol=1e-6)
    assert port["frames"] == 10 and port["final_ate"] < port["init_ate"]
    # the same report, line for line, but for the sweep's wall seconds
    def strip(text):
        return [re.sub(r"\[[0-9.]+s\]", "", ln) for ln in text.splitlines() if not ln.startswith("{")]

    assert strip(ptext) == strip(jtext)


@pytest.fixture(scope="module")
def float64_recording(tmp_path_factory):
    """30 frames of the 2D asset world, dead reckoning in float64."""
    rec = tmp_path_factory.mktemp("rec") / "odometry.zip"
    tcli.main(["-f", str(ROOT / "assets" / "linear2d.world"), "-c", str(ROOT / "assets" / "mov2d.in"),
               "-a", "odometry", "--dtype", "float64", "--frames", "30", "-r", str(rec), "--device", "cpu"])
    return rec


def test_isam2_lab_against_jax(float64_recording, monkeypatch, capsys):
    argv = [str(float64_recording), "-g", str(CFG_2D)]
    capsys.readouterr()
    seen = _recorded(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["isam2_lab.py"] + argv)
    _jax_tool("isam2_lab").main()
    jtext = capsys.readouterr().out
    port = isam2_lab.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jlandmarks = int(re.search(r"final: (\d+) landmarks", jtext).group(1))
    jpromos = int(re.search(r"promotions: (\d+),", jtext).group(1))
    jevents = [[int(f), int(lab)] for f, lab in re.findall(r"  frame (\d+): label (\d+)", jtext)]
    assert port["frames"] == 30 and port["landmarks"] == jlandmarks > 0
    assert len(port["promotions"]) == jpromos and port["promotion_events"] == jevents
    np.testing.assert_allclose([port["ate"]], seen["rmse"], rtol=0, atol=1e-6)
    np.testing.assert_allclose([port["ospa"]], seen["ospa"], rtol=0, atol=1e-6)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_profile_phd_main(capsys):
    out = profile_phd.main(["--particles", "4", "--warm", "3", "--reps", "1", "--device", "cpu"])
    (printed,) = _json_lines(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert printed["device"] == "cpu" and printed["card"] is None and printed["timer"] == "host clock (cpu)"
    assert set(printed["stages_ms"]) == {"births", "correct+prune", "fused kernel", "weight", "full"}
    assert all(v > 0 for v in printed["stages_ms"].values())
    assert printed["shape"]["P"] == 4 and printed["alive_components"] > 0


def test_roofline_phd_main(tmp_path, capsys):
    path = tmp_path / "roofline.json"
    roofline_phd.main(["--particles", "3,4", "--reps", "1", "--warm", "2", "--ceiling-n", "32",
                       "--stream-mb", "1", "--json", str(path), "--device", "cpu"])
    head, *rows = _json_lines(capsys.readouterr().out)
    assert head["fp32_matmul_tflops"] > 0 and head["stream_gbs"] > 0 and head["tf32"] is False
    assert json.loads(path.read_text())["rows"] == rows and len(rows) == 12
    for row in rows:
        if row["stage"] in ("fused kernel", "beam kernel"):
            assert row["bound_by"] in ("bytes", "operations") and row["mflop"] > 0 and row["mbytes"] > 0
            assert 0 < row["share_of_bound"] and row["published_bound_ms"] > 0
        else:
            assert row["note"] == roofline_phd.TIME_ONLY and "bound_ms" not in row


@pytest.mark.parametrize("round4", [False, True])
def test_ablate_main(round4, capsys):
    ablate.main(["--particles", "3", "--warm", "2", "--reps", "1", "--device", "cpu"]
                + (["--round4"] if round4 else []))
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == (4 if round4 else 7)
    assert rows[0]["variant"].startswith("full")
    assert all(r["ms"] > 0 and r["fps"] > 0 and r["device"] == "cpu" for r in rows)


def test_scanda_profile_main(capsys):
    scanda_profile.main(["--frames", "3", "--device", "cpu"])
    rows = _json_lines(capsys.readouterr().out)
    assert [r["config"] for r in rows] == [v[0] for v in scanda_profile.VARIANTS]
    for r in rows:
        assert r["frames"] == 3 and r["fps"] > 0 and np.isfinite(r["ate"]) and 0 <= r["ospa"] <= 1


def test_debug_loopy_main(tmp_path, capsys):
    """The JAX tool takes no node count: a copy of the recording cut to its
    first 10 frames."""
    rec = Recording.load(RECORDING)
    n = 10
    rec.odometry, rec.trajectory, rec.measurements = rec.odometry[:n], rec.trajectory[:n], rec.measurements[:n]
    rec.estimate = [(t, traj[:n]) for t, traj in rec.estimate[:n]]
    rec.save(str(tmp_path / "cut.zip"))
    out = debug_loopy.main([str(tmp_path / "cut.zip"), "1", "--device", "cpu"])
    (printed,) = _json_lines(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out)) and printed["frames"] == n
    (sweep,) = printed["sweeps"]
    assert sweep["ate_best"] < printed["init_ate"] and sweep["objective"] > printed["init_objective"]


def test_bench_scaling_main(capsys):
    bench_scaling.main(["--particles", "4,6", "--frames", "3", "--device", "cpu"])
    rows = _json_lines(capsys.readouterr().out)
    assert [r["particles"] for r in rows] == [4, 6]
    for r in rows:
        assert r["frames"] == 3 and r["fps"] > 0 and r["peak_memory_bytes"] is None
        assert r["particle_updates_per_s"] == pytest.approx(r["fps"] * r["particles"])
        assert np.isfinite(r["ate_rmse_loc"]) and r["device"] == "cpu"


def test_bench_scaling_counts():
    assert bench_scaling.COUNTS == (200, 1000, 5000, 10000) and bench_scaling.LARGE == (20000, 50000)
    cfg = bench_scaling.scaling_config(10000)
    assert (cfg.num_particles, cfg.max_components, cfg.merge_rounds, cfg.meas_compact) == (10000, 128, 4, 0)


ENTRY_POINTS = [
    ("run_experiments", run_experiments.main, ["chap3-s1"]),
    ("run_gpu_grid", run_gpu_grid.main, ["chap3-s1"]),
    ("bench_scaling", bench_scaling.main, []),
    ("profile_phd", profile_phd.main, []),
    ("roofline_phd", roofline_phd.main, []),
    ("ablate", ablate.main, []),
    ("scanda_profile", scanda_profile.main, []),
    ("smoother_lab", smoother_lab.main, [str(RECORDING)]),
    ("debug_loopy", debug_loopy.main, [str(RECORDING)]),
    ("isam2_lab", isam2_lab.main, [str(RECORDING), "-g", str(CFG_2D)]),
]


@pytest.mark.parametrize("name,main,argv", ENTRY_POINTS, ids=[e[0] for e in ENTRY_POINTS])
def test_entry_points_default_to_the_card(name, main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        main(argv)
