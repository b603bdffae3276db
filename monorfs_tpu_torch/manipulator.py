"""Keyboard control of a running simulation, headless core (the torch twin of
monorfs_tpu.manipulator up to its matplotlib window).

The reference Manipulator couples a MonoGame input loop to the running
Simulation: held keys add odometry on top of the scripted commands
(Simulation.cs:498-575 key map, Pose3D.AddKeyboardInput:432-440 scaling),
M toggles mapping<->SLAM, Escape pauses, Delete exits and saves the
recording. `keyboard_command` is the pure key->odometry mapping and
`ManipulatorLoop` advances a live Simulation one frame per tick with the
held-key odometry injected. The interactive window that feeds it key events
is not ported yet (ROADMAP.md, modules still to port: viewers).

Keys (Simulation.cs:529-566): I/K forward/back, J/L yaw, W/S pitch, A/D
roll, shift = fast, ctrl = slow, M toggles mapping/SLAM, escape pauses,
delete = finish.
"""

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
