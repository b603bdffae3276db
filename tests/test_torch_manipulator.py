"""The port's headless manipulator core (manipulator.py): the key ->
odometry mapping against the JAX package's on every key set tried, and the
frame stepper driving a live Simulation (phd and isam2) on the CPU."""

import itertools
import pathlib

import numpy as np
import pytest

from monorfs_tpu import manipulator as jmanip

from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io.world import World
from monorfs_tpu_torch.manipulator import ManipulatorLoop, keyboard_command
from monorfs_tpu_torch.sim.simulation import Simulation
from monorfs_tpu_torch.slam import phd

ROOT = pathlib.Path(__file__).resolve().parent.parent
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


class FakeTimer:
    """A matplotlib timer that fires only when the test says so."""

    def __init__(self):
        self.callbacks, self.running = [], False

    def add_callback(self, fn, *args, **kwargs):
        self.callbacks.append(lambda: fn(*args, **kwargs))

    def start(self):
        self.running = True

    def stop(self):
        self.running = False


@pytest.mark.parametrize("world", ["2d", "3d"])
def test_drive_window_under_agg(world, tmp_path, monkeypatch):
    """drive() under Agg with a fake timer: five ticks, each redrawn by the
    port's renderer into the window's image; key events reach the loop
    (i held, z screenshots manipulator_shot_000.png through render/png.py,
    delete ends the run), a left-button drag over the 3D view turns the
    camera and redraws (the 2D view takes no mouse), and the recording is
    saved at the end."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import FigureCanvasBase, KeyEvent, MouseEvent

    from monorfs_tpu_torch import manipulator, viewer3d
    from monorfs_tpu_torch.render.png import read_png

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(matplotlib, "use", lambda *a, **k: None)
    timer = FakeTimer()
    monkeypatch.setattr(FigureCanvasBase, "new_timer", lambda self, *a, **k: timer)
    images, dragged = [], []

    def show():
        fig = plt.gcf()
        send = lambda name, key: fig.canvas.callbacks.process(name, KeyEvent(name, fig.canvas, key))
        send("key_press_event", "i")
        for tick in range(5):
            assert timer.running
            for cb in timer.callbacks:
                cb()
            images.append(fig.axes[0].images[0].get_array().copy())
        send("key_release_event", "i")
        send("key_press_event", "z")
        aff = viewer3d.axes._layout3d(viewer3d.figure_3d(sim.to_recording()))[2] if world == "3d" else None
        for name, (u, v) in (("button_press_event", (0.0, 0.0)), ("motion_notify_event", (0.02, 0.01))):
            px, py = viewer3d.axes.transform.apply_affine(aff, u, v) if aff is not None else (400, 300)
            x, y = fig.axes[0].transData.transform((px - 0.5, py - 0.5))
            fig.canvas.callbacks.process(name, MouseEvent(name, fig.canvas, x, y, button=1))
        dragged.append(fig.axes[0].images[0].get_array().copy())
        send("key_press_event", "delete")
        for cb in timer.callbacks:
            cb()
        assert not timer.running

    monkeypatch.setattr(plt, "show", show)
    if world == "2d":
        sim = _sim()
    else:
        cfg = Config()
        sim = Simulation(cfg, World.from_file(str(ROOT / "assets" / "sim3d.world")), [], algorithm="phd",
                         particles=2, phd_config=phd.PHDConfig(num_particles=2, max_components=32, max_measurements=8,
                                                              gate_top=4, estimate_cap=8, beam_width=8,
                                                              beam_candidates=4, merge_rounds=2), device="cpu")
    manipulator.drive(sim, record_file=str(tmp_path / "drive.zip"))
    assert len(sim.waypoints) == 5 and len(images) == 5
    assert not np.array_equal(images[0], images[-1])  # the scene moved
    shot = read_png(tmp_path / "manipulator_shot_000.png")
    np.testing.assert_array_equal(shot, images[-1])
    assert np.array_equal(dragged[0], images[-1]) == (world == "2d")
    assert (tmp_path / "drive.zip").is_file()


def test_drive_needs_matplotlib(monkeypatch):
    import sys

    from monorfs_tpu_torch import manipulator

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        manipulator.drive(_sim())
