"""The PHD step's budget in a cfg file (Config.PHD_BUDGET: GateTop,
EstimateCap, BeamWidth, BeamCandidates, BeamMeasCap, MergeRounds): the keys
round-trip through the descriptor, a cfg without them serialises as the
JAX package's, Simulation builds its PHDConfig from them (an explicit
phd_config still wins), and the command line runs the flagship cfg
(experiments/configs/flagship.cfg) on the CPU with its recording carrying
the budget."""

import dataclasses
import pathlib

import numpy as np
import pytest

from monorfs_tpu.config import Config as JConfig

from monorfs_tpu_torch import bench_flagship, cli, postanalysis
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording, World, parse_commands
from monorfs_tpu_torch.sim import Simulation
from monorfs_tpu_torch.slam import phd

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLAGSHIP_CFG = ROOT / "experiments" / "configs" / "flagship.cfg"
KEYS = {"GateTop": "gate_top", "EstimateCap": "estimate_cap", "BeamWidth": "beam_width",
        "BeamCandidates": "beam_candidates", "BeamMeasCap": "beam_meas_cap", "MergeRounds": "merge_rounds"}
BUDGET = dict(gate_top=8, estimate_cap=48, beam_width=32, beam_candidates=6, beam_meas_cap=24, merge_rounds=4)


def _simulation(cfg, particles=16, **kw):
    world = World.from_file(ROOT / "assets" / "sim3d.world")
    commands = parse_commands((ROOT / "assets" / "mov3d.in").read_text())[:3]
    return Simulation(cfg, world, commands, particles=particles, dtype=np.float32, device="cpu", **kw)


def test_the_budget_keys_are_phdconfig_fields():
    assert set(KEYS.values()) == set(Config.PHD_BUDGET)
    assert {Config._FIELD_MAP[k] for k in KEYS} == {(f, int) for f in KEYS.values()}
    assert set(Config.PHD_BUDGET) <= {f.name for f in dataclasses.fields(phd.PHDConfig)}


@pytest.mark.parametrize("key", sorted(KEYS))
def test_each_budget_key_round_trips(key):
    field = KEYS[key]
    cfg = Config()
    setattr(cfg, field, BUDGET[field] + 1)
    text = cfg.to_descriptor()
    assert f"\n{key}: {BUDGET[field] + 1}" in text
    back = Config().apply_descriptor(text.splitlines())
    assert back.phd_budget() == {field: BUDGET[field] + 1}
    assert back.to_descriptor() == text


def test_the_whole_budget_round_trips():
    cfg = Config(max_quantity=128, **BUDGET)
    back = Config().apply_descriptor(cfg.to_descriptor().splitlines())
    assert back.phd_budget() == BUDGET and back.max_quantity == 128


def test_a_default_config_emits_no_budget_key():
    text = Config().to_descriptor()
    assert Config().phd_budget() == {}
    assert not any(line.split(":")[0] in KEYS for line in text.splitlines())
    assert text == JConfig().to_descriptor()


def test_the_reference_package_reads_a_budget_cfg_as_without_it():
    cfg = Config.from_file(FLAGSHIP_CFG)
    plain = Config(max_quantity=128)
    assert JConfig().apply_descriptor(cfg.to_descriptor().splitlines()).to_descriptor() \
        == plain.to_descriptor()


def test_the_flagship_cfg_states_the_flagship_budget():
    cfg = Config.from_file(FLAGSHIP_CFG)
    assert cfg.phd_budget() == BUDGET and cfg.max_quantity == 128
    assert bench_flagship.FLAGSHIP_CFG.resolve() == FLAGSHIP_CFG.resolve()


def test_simulation_builds_bench_flagships_phdconfig():
    sim = _simulation(Config.from_file(FLAGSHIP_CFG))
    assert sim.phd_cfg == bench_flagship.flagship_config(16)


def test_a_default_cfg_builds_the_default_phdconfig():
    sim = _simulation(Config())
    assert sim.phd_cfg == phd.PHDConfig(num_particles=16, max_components=600, max_measurements=48)


def test_an_explicit_phd_config_wins():
    given = phd.PHDConfig(num_particles=16, max_components=64, max_measurements=48, gate_top=4)
    sim = _simulation(Config.from_file(FLAGSHIP_CFG), phd_config=given)
    assert sim.phd_cfg is given


def test_the_command_line_runs_the_flagship_cfg(tmp_path, capsys):
    rec_file = tmp_path / "flagship.zip"
    assert cli.main(["-f", str(ROOT / "assets" / "sim3d.world"), "-c", str(ROOT / "assets" / "mov3d.in"),
                     "-p", "16", "-g", str(FLAGSHIP_CFG), "--frames", "3", "--device", "cpu",
                     "-r", str(rec_file)]) == 0
    rec = Recording.load(rec_file)
    assert len(rec.trajectory) == 3 and len(rec.estimate) == 3
    assert Config().apply_descriptor(rec.config_text.splitlines()).phd_budget() == BUDGET
    postanalysis.main(["-f", str(rec_file), "--device", "cpu"])
    assert "ATE" in capsys.readouterr().out
