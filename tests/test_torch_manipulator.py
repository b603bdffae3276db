"""The port's headless manipulator core (manipulator.py): the key ->
odometry mapping against the JAX package's on every key set tried, and the
frame stepper driving a live Simulation (phd and isam2) on the CPU."""

import itertools

import numpy as np
import pytest

from monorfs_tpu import manipulator as jmanip

from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io.world import World
from monorfs_tpu_torch.manipulator import ManipulatorLoop, keyboard_command
from monorfs_tpu_torch.sim.simulation import Simulation
from monorfs_tpu_torch.slam import phd

KEYS = ["i", "k", "j", "l", "w", "s", "a", "d", "shift", "x"]


@pytest.mark.parametrize("odo_dim", [6, 2, 1])
def test_keyboard_command_matches_jax(odo_dim):
    for r in (0, 1, 2, 3):
        for keys in itertools.combinations(KEYS, r):
            for mult in (1.0, 2.0, 0.25):
                np.testing.assert_array_equal(
                    keyboard_command(set(keys), odo_dim, mult),
                    jmanip.keyboard_command(set(keys), odo_dim, mult),
                )
    np.testing.assert_allclose(keyboard_command({"i"}, 6), [0, 0, 0.02, 0, 0, 0])
    np.testing.assert_allclose(keyboard_command({"j"}, 6), [0, 0, 0, 0, 0.1, 0])
    np.testing.assert_allclose(keyboard_command({"i"}, 2), [0, 0.01])


def _sim(algorithm="phd", commands=(), onlymapping=False):
    world = World(
        pose=np.array([0.0, 0.0]),
        landmarks=np.array([[0.5, 0.5, 0.0], [1.0, -0.5, 0.0], [-0.8, 0.3, 0.0]]),
        measurer_params=None,
    )
    cfg = Config()
    cfg.set_linear2d_defaults()
    small = phd.PHDConfig(num_particles=4, max_components=32, max_measurements=11, gate_top=8,
                          estimate_cap=16, beam_width=16, beam_candidates=4, merge_rounds=4)
    return Simulation(cfg, world, list(commands), algorithm=algorithm, particles=4,
                      onlymapping=onlymapping, phd_config=small, device="cpu")


@pytest.mark.parametrize("algorithm", ["phd", "isam2"])
def test_loop_drives_vehicle(algorithm):
    # the graph navigator sizes its pose capacity from the script
    script = [np.zeros(2)] * 10 if algorithm == "isam2" else []
    loop = ManipulatorLoop(_sim(algorithm, commands=script))
    loop.on_press("i")
    for _ in range(10):
        assert loop.tick()
    loop.on_release("i")
    assert loop.frame == 10
    # the true pose moved in +y (Linear2D forward)
    pose = loop.sim.vstate.pose.numpy()
    np.testing.assert_allclose(pose, [0.0, 0.1], atol=1e-6)
    assert len(loop.sim.waypoints) == 10
    # nothing held and no script left: the loop ends
    assert not loop.tick() and loop.finished
    if algorithm == "isam2":
        assert loop.sim.isam2.n_poses == 11


def test_loop_script_modifiers_pause_and_delete():
    script = [np.array([0.05, 0.0])] * 3
    loop = ManipulatorLoop(_sim(commands=script))
    assert loop.multiplier() == 1.0
    loop.on_press("shift")
    assert loop.multiplier() == 2.0
    loop.on_press("control")
    assert loop.multiplier() == 0.5
    loop.on_release("shift")
    loop.on_release("control")
    loop.on_press("escape")
    assert loop.paused and loop.tick() and loop.frame == 0  # paused: no frame
    loop.on_press("escape")
    loop.on_press("j")  # +x on top of the script
    assert loop.tick()
    np.testing.assert_allclose(loop.sim.vstate.pose.numpy(), [0.06, 0.0], atol=1e-6)
    loop.on_release("j")
    loop.on_press(None)
    assert loop.tick() and loop.tick() and not loop.tick()
    loop = ManipulatorLoop(_sim(commands=script))
    loop.on_press("delete")
    assert loop.finished and not loop.tick()


def test_mode_toggle_goes_in_band():
    loop = ManipulatorLoop(_sim(commands=[np.array([0.05, 0.0])] * 4, onlymapping=True))
    assert loop.tick()
    loop.on_press("m")
    assert loop.tick()
    assert [msg for _, msg in loop.sim.tags] == ["SLAM mode on"] and not loop.sim.mode_mapping
    loop.on_press("m")
    assert loop.tick()
    assert [msg for _, msg in loop.sim.tags] == ["SLAM mode on", "Mapping mode on"]
