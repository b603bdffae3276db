"""Interactive control of a simulation in the port: keyboard-controlled vehicle +
live scene (the counterpart of monorfs_tpu.manipulator).

The reference Manipulator couples a MonoGame input loop to the running
Simulation: held keys add odometry on top of the scripted commands
(Simulation.cs:498-575 key map, Pose3D.AddKeyboardInput:432-440 scaling),
M toggles mapping<->SLAM, Escape pauses, Z screenshots, Delete exits and
saves the recording. `keyboard_command` is the pure key->odometry mapping,
`ManipulatorLoop` advances a live Simulation one frame per tick with the
held-key odometry injected (and holds the set of held keys), and `drive()`
wires both to a matplotlib window: key press / release events, a timer,
and an image of the port's own frame (viewer3d.scene_3d for 3D worlds, the
top-down view for the others), drawn on the simulation's device; the
mouse turns, pans and zooms the 3D camera as matplotlib's 3D axes does
(viewer3d.OrbitCamera). matplotlib is needed for that window only.

Run: python -m monorfs_tpu_torch.manipulator -f assets/sim3d.world \
         [-c assets/mov3d.in] [-a phd] [-p 50] [-r out.zip] [--device cuda]
Keys (Simulation.cs:529-566): I/K forward/back, J/L yaw, W/S pitch, A/D
roll, shift = fast, ctrl = slow, M toggles mapping/SLAM, escape pauses,
z screenshot (manipulator_shot_%03d.png), delete = save + exit.
"""

import argparse
import sys

import numpy as np


# Pose3D.AddKeyboardInput (Pose3D.cs:432-440): [dx, dy, dz, pitch, yaw,
# roll] with 0.02 translation / 0.1 rotation scaling and the reference's
# sign flips on pitch/yaw.
_SCALE_6DOF = np.array([0.02, 0.02, 0.02, -0.1, -0.1, 0.1])
# LinearPose2D.AddKeyboardInput (LinearPose2D.cs:291-294):
# x <- 0.01 * yaw-keys, y <- 0.01 * z-keys.
_KEY_AXES = {
    "i": (2, +1.0), "k": (2, -1.0),   # dlocz (forward/back)
    "j": (4, -1.0), "l": (4, +1.0),   # yaw
    "w": (3, +1.0), "s": (3, -1.0),   # pitch
    "a": (5, -1.0), "d": (5, +1.0),   # roll
}


def keyboard_command(keys, odo_dim, multiplier=1.0):
    """Held-key set -> odometry increment (the AddKeyboardInput math).

    keys: iterable of lowercase key names; odo_dim: 6 (Pose3D), 2
    (Linear2D) or 1 (Linear1D)."""
    key6 = np.zeros(6)
    for k in keys:
        ax = _KEY_AXES.get(k)
        if ax is not None:
            key6[ax[0]] += ax[1] * multiplier
    if odo_dim >= 6:
        return key6 * _SCALE_6DOF
    if odo_dim == 2:
        return np.array([0.01 * (-key6[4]), 0.01 * key6[2]])
    return np.array([0.01 * key6[2]])


class ManipulatorLoop:
    """Frame-stepper around a live Simulation: scripted command (if any)
    plus the held-key odometry, with the reference's pause / mode-toggle
    semantics."""

    def __init__(self, sim):
        self.sim = sim
        self.keys = set()
        self.paused = False
        self.finished = False
        self.frame = 0
        self.odo_dim = sim.model.pose.odo_dim
        self._mode_toggle = False  # M pressed: in-band switch next frame

    def multiplier(self):
        m = 1.0
        if "shift" in self.keys:
            m *= 2.0
        if "control" in self.keys or "ctrl" in self.keys:
            m /= 4.0
        return m

    def tick(self):
        """Advance one frame; returns False once the command script is
        depleted AND no keys are held (the reference keeps running while
        the user drives)."""
        if self.paused or self.finished:
            return not self.finished
        keycmd = keyboard_command(
            self.keys, self.odo_dim, self.multiplier()
        )
        if self.frame < len(self.sim.commands):
            cmd = np.asarray(
                self.sim.commands[self.frame], float
            )[: self.odo_dim] + keycmd
        elif self.keys or self.frame == 0:
            cmd = keycmd
        else:
            self.finished = True
            return False
        if self._mode_toggle:
            # in-band switch flag, the recording's command-file semantics
            # (Simulation.cs:575-634: +1 -> SLAM, -1 -> mapping)
            flag = 1.0 if getattr(self.sim, "mode_mapping", False) else -1.0
            cmd = np.concatenate([cmd, [flag]])
            self._mode_toggle = False
        self.sim.step(cmd)
        self.frame += 1
        return True

    def on_press(self, key):
        if key == "m":
            # mapping <-> SLAM toggle (Simulation.cs:561-566)
            self._mode_toggle = True
        elif key == "escape":
            self.paused = not self.paused
        elif key == "delete":
            self.finished = True
        elif key is not None:
            self.keys.add(key)

    def on_release(self, key):
        self.keys.discard(key)


def frame_figure(sim, loop, camera=None):
    """The window's figure of the simulation as it stands: the 3D scene of
    the last frame seen by camera (a viewer3d.OrbitCamera, default the
    viewer's start), or the top-down trajectory and landmarks."""
    from . import viewer3d
    from .render import axes

    rec = sim.to_recording()
    mode = "mapping" if getattr(sim, "mode_mapping", False) else "SLAM"
    title = (f"frame {loop.frame} [{mode}]{' PAUSED' if loop.paused else ''} - IKJL/WSAD drive, "
             "M mode, esc pause, del save+exit")
    if sim.model.pose.state_dim >= 7:
        if not rec.trajectory:  # before the first tick: the starting pose
            rec.trajectory = [(0.0, np.asarray(sim.world.pose, float))]
        camera = camera or viewer3d.OrbitCamera()
        fig = viewer3d.figure_3d(rec, loop.frame - 1, camera.elev, camera.azim, roll=camera.roll,
                                 limits=camera.limits)
        fig.title = title
        return fig
    calls = []
    truth = np.array([s[:2] for _, s in rec.trajectory]) if rec.trajectory else np.zeros((0, 2))
    if truth.size:
        calls.append(axes.Call("plot", (truth[:, 0], truth[:, 1]), "k-"))
    if rec.world.landmarks.size:
        lm = rec.world.landmarks
        calls.append(axes.Call("plot", (lm[:, 0], lm[:, 1]), "k*"))
    return axes.Figure(calls, title=title, size=(880, 770), dpi=110.0, equal=True)


def drive(sim, record_file=None, fps=15):
    """Interactive window around ManipulatorLoop (requires matplotlib and a
    display); the frames are drawn on the simulation's device."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the manipulator's window needs matplotlib, which is not installed") from e
    try:
        matplotlib.use("TkAgg")
    except ImportError:
        pass
    import matplotlib.pyplot as plt

    from .render import axes
    from .render.png import write_png
    from .viewer3d import OrbitCamera, window_view_coords

    loop, camera = ManipulatorLoop(sim), OrbitCamera()
    is3d = sim.model.pose.state_dim >= 7
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_axes([0.01, 0.01, 0.98, 0.98])
    ax.set_axis_off()
    shots, shown, current, image = [0], [None], [None], []

    def redraw():
        shown[0] = frame_figure(sim, loop, camera)
        current[0] = axes.render(shown, sim.device)[0].cpu().numpy()
        if image:
            image[0].set_data(current[0])
        else:
            image.append(ax.imshow(current[0]))
        fig.canvas.draw_idle()

    def on_key(ev):
        loop.on_press(ev.key)
        if ev.key == "z":
            out = f"manipulator_shot_{shots[0]:03d}.png"
            write_png(out, current[0])
            shots[0] += 1
            print(f"screenshot -> {out}")

    def on_press(ev):
        xy = window_view_coords(ev, ax, shown[0]) if is3d else None
        if xy is not None:
            camera.press(*xy, ev.button)

    def on_move(ev):  # the 3D axes' mouse camera (the JAX window's matplotlib Axes3D)
        xy = window_view_coords(ev, ax, shown[0]) if is3d else None
        if camera.button is not None and xy is not None:
            camera.drag(*xy, shown[0].view3d[:3])
            redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("key_release_event", lambda ev: loop.on_release(ev.key))
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("button_release_event", lambda ev: camera.release())

    timer = fig.canvas.new_timer(interval=int(1000 / fps))

    def on_tick():
        alive = loop.tick()
        camera.reset()  # the JAX redraw: ax.clear() + view_init(elev=, azim=)
        redraw()
        if not alive:
            timer.stop()
            plt.close(fig)

    timer.add_callback(on_tick)
    timer.start()
    redraw()
    plt.show()

    if record_file:
        sim.save(record_file)
        print(f"recording written to {record_file}")
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(prog="monorfs-tpu-torch-manipulator")
    ap.add_argument("-f", "--file", required=True, help="world file")
    ap.add_argument("-c", "--commands", default=None, help="optional scripted command file to drive on top of")
    ap.add_argument("-a", "--algorithm", default="phd")
    ap.add_argument("-p", "--particles", type=int, default=50)
    ap.add_argument("-y", "--onlymapping", action="store_true")
    ap.add_argument("-r", "--record", default=None)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from . import resolve_device
    from .config import Config
    from .io.world import World, parse_commands
    from .sim.simulation import Simulation

    device = resolve_device(args.device)
    world = World.from_file(args.file)
    commands = []
    if args.commands:
        with open(args.commands) as f:
            commands = parse_commands(f.read())
    sim = Simulation(Config(), world, list(commands), algorithm=args.algorithm, particles=args.particles,
                     onlymapping=args.onlymapping, device=device)
    drive(sim, record_file=args.record, fps=args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
