"""The benchmark's cell of the flagship deployment (rfsbench cell
`flagship-p100k`, configuration `flagship-prm3d`) cut to the CPU: its
configuration states the PHD budget the port builds from its descriptor,
as experiments/configs/flagship.cfg states it; at 64 particles the cell's
run reads `correct` with the K0 cap binding in a judged frame; and a
resample collapsed onto one particle fails the cell's weight limit (1,000
particles, so that a collapse moves more offspring than the limit, which
is set for 100,000)."""

import json

import pytest

from rfsbench import bench, faults, harness, readings
from rfsbench.tests import small

from monorfs_tpu_torch.bench_flagship import FLAGSHIP_CFG
from monorfs_tpu_torch.config import Config

CELL = "flagship-p100k"


def test_the_configuration_is_what_the_port_builds():
    _, cell, config, traffic = harness.load_cell(CELL)
    assert cell["config"] == "flagship-prm3d" and cell["chips"] == 1 and traffic["particles"] == 100_000
    inputs = harness.Inputs(config, dict(traffic, particles=8), 2147483999, small.cpu())
    program = harness.Program(inputs, small.cpu())
    sim, _ = program.simulation(inputs.draws(0, 1), frames=1)
    assert {f: getattr(sim.phd_cfg, f) for f in config["phd"]} == config["phd"]
    want = Config.from_file(FLAGSHIP_CFG)
    assert program.cfg.phd_budget() == want.phd_budget() and program.cfg.max_quantity == want.max_quantity
    assert program.cfg.to_descriptor() == want.to_descriptor()


@pytest.mark.parametrize("seed", [2147483999, 3000000701])
def test_the_cell_is_correct_with_its_cap_binding(seed, tmp_path, monkeypatch):
    # this suite's conftest loads JAX for the other tests; a run's own imports
    # are held to bench.FORBIDDEN by rfsbench/tests/test_rfsbench_imports.py
    monkeypatch.setattr(bench, "forbidden_modules", lambda names=None: [])
    # the window runs whole 3-frame sequences for 15 s, so that the first, which the sample is drawn from, ends
    rc, line, err = small.run(CELL, seconds=15, seed=seed, particles=64, frames=2, length=3, tmp=tmp_path)
    assert rc == 0, err[-2000:]
    rows = [json.loads(x.split("rfsbench: frame ", 1)[1]) for x in err.splitlines()
            if x.startswith("rfsbench: frame ")]
    assert len(rows) == 3, err[-2000:]  # (0, 0) and both sampled frames
    assert line["correct"] is True, line["checks"]
    k0 = harness.load_cell(CELL)[2]["phd"]["max_components"]
    assert max(r["live"] for r in rows) == k0
    assert any(r["resampled"] for r in rows)


def test_a_collapsed_resample_fails_the_cells_weight_limit(tmp_path):
    cell = small.cell(CELL, particles=1000, frames=2, length=3, tmp=tmp_path)
    limits = cell[3]["limits"]
    sound = readings.seed_readings(CELL, 2147483999, [], small.cpu(), cell=cell)
    broken = readings.seed_readings(CELL, 2147483999, [], small.cpu(), cell=cell, window_hook=faults.collapse)
    assert [f["t"] for f in broken["port_frames"]] == [0, 1, 2]
    assert any(f["resampled"] for f in broken["port_frames"])
    assert all(v <= limits[k]["limit"] for k, v in sound["port"].items()), sound["port"]
    assert limits["weight"]["limit"] < broken["port"]["weight"], broken["port"]
    assert all(v <= limits[k]["limit"] for k, v in broken["port"].items() if k != "weight")
