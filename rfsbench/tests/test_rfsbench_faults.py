"""The port with its timed path broken underneath (faults.py) comes out as
not correct: a run with a step that hands its state on unchanged, with half
of the particles left out of the step, or with a measurement altered where
the vehicle produces it; and the frames of a step whose resample copies one
particle into every slot. For the last, 64 particles keep more than one
particle's line through the first resample (a resample onto one particle is
what the systematic draw does where one particle holds all the weight), and
the sequence is cut to its first 3 commands, whose frames are all judged
(readings.py steps to them whatever the host's speed)."""

import pytest

from rfsbench import check, faults, readings

from . import small


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["chap3-p800", "chap3-p2000"])
def test_a_broken_step_is_not_correct(name, fault):
    rc, line, err = small.run(name, seconds=3, hook=faults.FAULTS[fault], particles=16)
    assert rc == 0, err[-2000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", ["chap3-p800", "chap3-p2000"])
def test_a_collapsed_resample_is_not_correct(name, tmp_path):
    cell = small.cell(name, particles=64, frames=2, length=3, tmp=tmp_path)
    limit = cell[3]["limits"]["weight"]["limit"]
    sound = readings.seed_readings(name, 2147483999, [], small.cpu(), cell=cell)
    broken = readings.seed_readings(name, 2147483999, [], small.cpu(), cell=cell, window_hook=faults.collapse)
    assert [f["t"] for f in broken["port_frames"]] == [0, 1, 2]
    assert any(f["resampled"] for f in broken["port_frames"])
    assert sound["port"]["weight"] <= limit < broken["port"]["weight"], (sound["port"], broken["port"])
    assert all(v <= cell[3]["limits"][k]["limit"] for k, v in broken["port"].items() if k != "weight")
    assert check.BRANCH > limit
