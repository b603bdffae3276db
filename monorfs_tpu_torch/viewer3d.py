"""3D recording viewer of the port: the Manipulator-layer scene, drawn on
the device by the port's rasterizer (the counterpart of
monorfs_tpu/viewer3d.py).

The reference renders recordings as live 3D scenes: orbit/zoom camera
(Manipulator.cs:488-543), map ellipsoids from the covariance
eigendecomposition (Navigator.cs:313-390), the camera FOV frustum
(PRM3DMeasurer.cs:400-485), trajectories and measurement rays
(DrawUtils.cs:45-71, Vehicle.cs:377-492). `scene_3d` is the draw list the
JAX `_scene_3d` hands to matplotlib's 3D axes, call for call, with the
scene cube's limits; `render_3d` projects it with matplotlib's own
projection (render.transform.proj_matrix) and draws it; the screenshot
modes draw a batch of frames in one pass; `interactive_3d` shows the
port's frame in a matplotlib window with a timeline slider and the mouse
camera of matplotlib's own 3D axes (OrbitCamera: arcball turn, pan, zoom).

2D worlds keep the top-down viewer (viewer.py), which routes 3D recordings
here.
"""

import os
import re

import numpy as np

from . import resolve_device
from .io.recording import Recording
from .render import axes
from .render.png import write_png
from .render.transform import BOX_ASPECT, DIST, VIEW_LIM, view_axes
from .viewer import Scrubber, render_images, tag_frame

SIZE, DPI = (880, 770), 110.0  # the JAX figure: figsize (8, 7) at dpi 110
ELEV, AZIM = 25.0, -60.0
WINDOW_ELEV = 30.0  # a new Axes3D's elev, where the JAX windows start
TRACKBALL_SIZE, TRACKBALL_BORDER = 0.667, 0.2  # matplotlib's rcParams axes3d.trackball*


def _ellipsoid_wires(mean, cov, nsigma=5.0, points=24):
    """Three principal 5-sigma ellipse rings of a 3D covariance
    (the wireframe equivalent of Navigator.cs:313-390's shaded ellipsoid)."""
    c = np.asarray(cov, float)
    if c.shape[0] < 3:
        c3 = np.eye(3) * 1e-12
        c3[: c.shape[0], : c.shape[1]] = c
        c = c3
    m = np.zeros(3)
    m[: len(mean)] = np.asarray(mean, float)[:3]
    w, v = np.linalg.eigh((c + c.T) / 2)
    w = np.sqrt(np.maximum(w, 0.0)) * nsigma
    t = np.linspace(0, 2 * np.pi, points)
    cs, sn = np.cos(t), np.sin(t)
    rings = []
    for a, b in ((0, 1), (0, 2), (1, 2)):
        rings.append(m[:, None] + v[:, a:a + 1] * (w[a] * cs)[None, :] + v[:, b:b + 1] * (w[b] * sn)[None, :])
    return rings


def _quat_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _frustum_lines(pose, mparams):
    """Camera FOV frustum edges at `pose` (PRM3DMeasurer.cs:400-485):
    near/far rectangles through the film corners plus connecting edges.

    mparams: the world's linear measurer descriptor
    [focal, range_min, range_max, film_left, film_top, film_w, film_h]
    (PRM3DMeasurer.cs:92-96)."""
    if mparams is None or len(mparams) < 7:
        return []
    f, rmin, rmax, left, top, fw, fh = [float(v) for v in mparams[:7]]
    right, bottom = left + fw, top + fh
    loc = np.asarray(pose[:3], float)
    rot = _quat_matrix(np.asarray(pose[3:7], float))
    corners = [(left, top), (right, top), (right, bottom), (left, bottom)]
    lines, rects = [], []
    for depth in (rmin, rmax):
        ring = [loc + rot @ (np.array([px / f, py / f, 1.0]) * depth) for px, py in corners]
        rects.append(ring)
        ring_c = ring + [ring[0]]
        lines.extend(np.stack([a, b], axis=1) for a, b in zip(ring_c, ring_c[1:]))
    for a, b in zip(rects[0], rects[1]):
        lines.append(np.stack([a, b], axis=1))
    return lines


def scene_3d(rec: Recording, fi, show_measurements=True, frustum=True):
    """(draw list, (xlim, ylim, zlim)) of frame fi's scene: what the JAX
    _scene_3d plots and scatters, in its order, and the scene cube it sets."""
    calls = []
    truth = np.array([s[:3] for _, s in rec.trajectory])
    calls.append(axes.Call("plot", (truth[:, 0], truth[:, 1], truth[:, 2]), "k-",
                           dict(lw=1.2, label="groundtruth")))
    if rec.estimate:
        j = min(fi, len(rec.estimate) - 1)
        est = np.array([v[:3] for _, v in rec.estimate[j][1]])
        if est.size:
            calls.append(axes.Call("plot", (est[:, 0], est[:, 1], est[:, 2]), "b-", dict(lw=1.0, label="estimate")))
    lm = rec.world.landmarks
    if lm.size:
        calls.append(axes.Call("scatter", (lm[:, 0], lm[:, 1], lm[:, 2]), "",
                               dict(marker="*", s=40, c="k", label="landmarks")))
    if rec.maps and 0 <= fi < len(rec.maps):
        for w, mean, cov in rec.maps[fi][1]:
            if w < 0.5:
                continue
            for ring in _ellipsoid_wires(mean, cov):
                calls.append(axes.Call("plot", (ring[0], ring[1], ring[2]), "g-", dict(lw=0.5, alpha=0.7)))
    pose = rec.trajectory[min(fi, len(rec.trajectory) - 1)][1] if rec.trajectory else None
    if pose is not None and len(pose) >= 7:
        if frustum:
            for seg in _frustum_lines(pose, rec.world.measurer_params):
                calls.append(axes.Call("plot", (seg[0], seg[1], seg[2]), "-",
                                       dict(color="orange", lw=0.6, alpha=0.8)))
        if show_measurements and rec.measurements and fi < len(rec.measurements):
            mp = rec.world.measurer_params
            if mp is not None and len(mp) >= 7:
                f = float(mp[0])
                loc = np.asarray(pose[:3], float)
                rot = _quat_matrix(np.asarray(pose[3:7], float))
                for z in rec.measurements[fi][1]:
                    if len(z) < 3:
                        continue
                    px, py, rng = float(z[0]), float(z[1]), float(z[2])
                    d = np.array([px / f, py / f, 1.0])
                    d = d / np.linalg.norm(d) * abs(rng)
                    tip = loc + rot @ d
                    calls.append(axes.Call("plot", ([loc[0], tip[0]], [loc[1], tip[1]], [loc[2], tip[2]]),
                                           "r-", dict(lw=0.4, alpha=0.5)))
    # equal aspect: bound the scene cube
    allp = np.concatenate([truth, lm] if lm.size else [truth], axis=0)
    ctr = (allp.max(axis=0) + allp.min(axis=0)) / 2
    rad = max(float((allp.max(axis=0) - allp.min(axis=0)).max()) / 2, 1e-3)
    return calls, tuple((ctr[i] - rad, ctr[i] + rad) for i in range(3))


def figure_3d(rec: Recording, frame=None, elev=ELEV, azim=AZIM, show_measurements=True, roll=0.0,
              limits=None):
    """The Figure of frame `frame` (default the last) seen from (elev,
    azim, roll); `limits` (xlim, ylim, zlim) replaces the scene cube's, as a
    mouse pan or zoom of the window does."""
    fi = len(rec.maps) - 1 if frame is None else frame
    calls, cube = scene_3d(rec, fi, show_measurements=show_measurements)
    xlim, ylim, zlim = cube if limits is None else limits
    return axes.Figure(calls, title=f"frame {fi}", size=SIZE, dpi=DPI, view3d=(xlim, ylim, zlim, elev, azim, roll),
                       xlabel="x", ylabel="y", zlabel="z", legend="upper left")


def render_3d(rec: Recording, output, frame=None, elev=ELEV, azim=AZIM, show_measurements=True,
              device="cuda"):
    """Render one 3D scene frame to `output` (png path or file-like)."""
    dev = resolve_device(device)
    write_png(output, render_images([figure_3d(rec, frame, elev, azim, show_measurements)], dev)[0])
    return output


def render_frames_3d(rec: Recording, outdir, stride=10, device="cuda"):
    """Screenshot batch mode (Viewer.cs:214): every stride-th frame."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    idx = list(range(0, max(len(rec.maps), 1), stride))
    outs = [f"{outdir}/frame_{i:05d}.png" for i in idx]
    for out, img in zip(outs, render_images([figure_3d(rec, i) for i in idx], dev)):
        write_png(out, img)
    return outs


def render_tagged_3d(rec: Recording, outdir, device="cuda"):
    """Screenshot-TAG mode: one render per tag, at the tag's frame
    (the reference's scripted `screenshot` command tags,
    Simulation.cs:575-617 + Viewer.cs:214)."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    outs = []
    for t, msg in rec.tags:
        slug = re.sub(r"[^A-Za-z0-9_-]+", "_", msg)[:40] or "tag"
        outs.append(f"{outdir}/tag_{t:08.3f}_{slug}.png")
    images = render_images([figure_3d(rec, tag_frame(rec, t)) for t, _ in rec.tags], dev)
    for out, img in zip(outs, images):
        write_png(out, img)
    return outs


def _quat_mul(p, q):
    """The product of quaternions (w, x, y, z) (axes3d._Quaternion.__mul__)."""
    return np.concatenate([[p[0] * q[0] - np.dot(p[1:], q[1:])],
                           p[0] * q[1:] + p[1:] * q[0] + np.cross(p[1:], q[1:])])


def _quat_from_cardan(elev, azim, roll):
    """axes3d._Quaternion.from_cardan_angles (radians)."""
    ca, sa = np.cos(azim / 2), np.sin(azim / 2)
    ce, se = np.cos(elev / 2), np.sin(elev / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    return np.array([ca * ce * cr + sa * se * sr, ca * ce * sr - sa * se * cr,
                     ca * se * cr + sa * ce * sr, ca * se * sr - sa * ce * cr])


def _quat_to_cardan(q):
    """axes3d._Quaternion.as_cardan_angles: (elev, azim, roll) in radians."""
    qw, qx, qy, qz = q
    azim = np.arctan2(2 * (-qw * qz + qx * qy), qw * qw + qx * qx - qy * qy - qz * qz)
    elev = np.arcsin(np.clip(2 * (qw * qy + qz * qx) / (qw * qw + qx * qx + qy * qy + qz * qz), -1, 1))
    roll = np.arctan2(2 * (qw * qx - qy * qz), qw * qw - qx * qx - qy * qy + qz * qz)
    return elev, azim, roll


def _arcball(x, y):
    """Axes3D._arcball: the point of the virtual trackball under (x, y) in
    units of the view size (rcParams axes3d.trackballsize 0.667,
    axes3d.trackballborder 0.2)."""
    s = TRACKBALL_SIZE / 2
    b = TRACKBALL_BORDER / s
    x, y = x / s, y / s
    r2 = x * x + y * y
    r = np.sqrt(r2)
    ra = 1 + b
    a = b * (1 + b / 2)
    ri = 2 / (ra + 1 / ra)
    if r < ri:
        return np.array([np.sqrt(1 - r2), x, y])
    if r < ra:
        dr = ra - r
        p = np.array([a - np.sqrt((a + dr) * (a - dr)), x, y])
        return p / np.linalg.norm(p)
    return np.array([0, x / r, y / r])


class OrbitCamera:
    """The mouse camera of matplotlib 3.10.8's 3D axes (Axes3D._button_press,
    _on_move, _button_release) under its default settings, with no
    matplotlib: button 1 turns the view in the 'arcball' rotation style
    (rcParams axes3d.mouserotationstyle), which changes elev, azim and roll;
    button 2 pans and button 3 zooms, both by moving the axis limits.
    Coordinates are the 3D axes' 2D view coordinates (what an Axes3D's mouse
    events carry as xdata, ydata; render.axes.view_coords gives them for a
    pixel of the port's figure). `reset` is what the JAX windows' redraw
    does to the view (ax.clear() and view_init(elev=, azim=)): it keeps
    elev and azim, and puts roll back to 0 and the limits to the scene's.
    matplotlib's 3D axes takes no scroll event: its zoom is the drag with
    button 3. A window starts where the JAX windows start: at the view of a
    new Axes3D (elev 30, azim -60), which their redraw keeps."""

    def __init__(self, elev=WINDOW_ELEV, azim=AZIM):
        self.elev, self.azim, self.roll = float(elev), float(azim), 0.0
        self.limits = None  # (xlim, ylim, zlim) after a pan or zoom; None: the scene's
        self.button, self._start = None, None

    def reset(self):
        self.roll, self.limits = 0.0, None

    def press(self, x, y, button=1):
        self.button, self._start = button, (x, y)

    def release(self):
        self.button = None

    def drag(self, x, y, limits):
        """The move of the held button to (x, y); limits (xlim, ylim, zlim)
        are the view's as drawn, which a pan or zoom moves."""
        if self.button is None or x is None or y is None:
            return
        (sx, sy), view = self._start, VIEW_LIM[1] - VIEW_LIM[0]
        dx, dy = x - sx, y - sy
        if self.button == 1:
            if dx == 0 and dy == 0:
                return
            q = _quat_from_cardan(*np.deg2rad((self.elev, self.azim, self.roll)))
            current, new = _arcball(sx / view, sy / view), _arcball(x / view, y / view)
            q = _quat_mul(_quat_mul(np.concatenate([[0.0], new]), np.concatenate([[0.0], -current])), q)
            self.elev, self.azim, self.roll = (float(v) for v in np.rad2deg(_quat_to_cardan(q)))
        elif self.button == 2:  # Axes3D.drag_pan
            lims = np.array(limits, np.float64)
            u, v, w, _ = view_axes(self.elev, self.azim, self.roll)
            rot = -np.array([u, v, w]) / BOX_ASPECT * DIST
            shift = (lims[:, 1] - lims[:, 0]) * (rot.T @ np.array([dx, dy, 0.0]))
            self.limits = tuple(tuple(lim) for lim in lims + shift[:, None])
        elif self.button == 3:  # Axes3D._scale_axis_limits: dragging down zooms in
            lims = np.array(limits, np.float64)
            scale = view / (view - dy)
            ctr, rng = (lims[:, 1] + lims[:, 0]) / 2, lims[:, 1] - lims[:, 0]
            self.limits = tuple(zip(ctr - rng * scale / 2, ctr + rng * scale / 2))
        self._start = (x, y)


def window_view_coords(event, ax, figure):
    """The 3D axes' view coordinates of a mouse event over the window's
    image (ax shows figure with imshow, whose data coordinates put pixel
    centres at integers), or None where the event is off the square that
    an Axes3D would cover there (its event.inaxes would not be the 3D axes)."""
    if event.inaxes is not ax or event.xdata is None:
        return None
    x, y = axes.view_coords(figure, event.xdata + 0.5, event.ydata + 0.5)
    lo, hi = VIEW_LIM
    return (x, y) if lo <= x <= hi and lo <= y <= hi else None


def interactive_3d(rec: Recording, device="cuda"):
    """Timeline-scrub 3D viewer: a matplotlib window that shows the port's
    frame; the mouse turns (button 1), pans (2) and zooms (3) the camera as
    matplotlib's own 3D axes does (OrbitCamera; Manipulator.cs:488-543); the
    slider + arrow keys scrub frames, and a new frame keeps elev and azim,
    as the JAX window's redraw does. Requires matplotlib and a display."""
    dev = resolve_device(device)
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the 3D viewer's window needs matplotlib, which is not installed") from e
    try:
        matplotlib.use("TkAgg")
    except ImportError:
        pass
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    scrub, camera = Scrubber(len(rec.maps)), OrbitCamera()
    n = scrub.n
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_axes([0.02, 0.1, 0.96, 0.88])
    ax.set_axis_off()
    sax = fig.add_axes([0.12, 0.03, 0.76, 0.03])
    slider = Slider(sax, "frame", 0, n - 1, valinit=n - 1, valstep=1)
    shown = []

    def frame_figure():
        return figure_3d(rec, scrub.frame, camera.elev, camera.azim, roll=camera.roll, limits=camera.limits)

    def show():
        shown[:] = [frame_figure()]
        image.set_data(render_images(shown, dev)[0].cpu().numpy())
        fig.canvas.draw_idle()

    def draw(val):
        scrub.frame = int(val)
        camera.reset()
        show()

    def on_press(event):
        xy = window_view_coords(event, ax, shown[0])
        if xy is not None:
            camera.press(*xy, event.button)

    def on_move(event):
        xy = window_view_coords(event, ax, shown[0])
        if camera.button is not None and xy is not None:
            camera.drag(*xy, shown[0].view3d[:3])
            show()

    shown.append(frame_figure())
    image = ax.imshow(render_images(shown, dev)[0].cpu().numpy())
    slider.on_changed(draw)
    fig.canvas.mpl_connect("key_press_event", lambda event: slider.set_val(scrub.key(event.key)))
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("motion_notify_event", on_move)
    fig.canvas.mpl_connect("button_release_event", lambda event: camera.release())
    plt.show()
    return scrub, camera
