"""The port's 3D viewer (monorfs_tpu_torch.viewer3d) against the JAX
package's (monorfs_tpu.viewer3d) on the CPU.

- _ellipsoid_wires, _quat_matrix and _frustum_lines equal the JAX functions
  to 1e-12 (float64) on 50 seeded covariances and poses, rank-deficient
  covariances and 2x2 covariances fed to the 3D rings among them;
- scene_3d's draw list equals the calls the JAX _scene_3d makes on its axes
  (recorded by a stand-in axes), call by call, data to 1e-12, and its
  limits equal the JAX set_xlim / set_ylim / set_zlim arguments, on the JAX
  tests' recording (tests/test_viewer3d.py) and on a 10-frame CPU
  recording of the 3D asset world, at every frame;
- the projection of each frame is matplotlib's for those limits at elev
  25, azim -60 (render.transform, held to matplotlib in
  test_torch_render.py);
- the window: the port's slider and Scrubber give the JAX interactive_3d's
  frame index after every event of one key sequence; under one sequence of
  mouse and key events, sent to the JAX window (matplotlib 3.10.8's own
  Axes3D: arcball turn, pan, zoom) and to the port's at the same view
  coordinates, OrbitCamera and the port's window give the Axes3D's elev,
  azim and roll to 1e-9 degrees and its limits to 1e-9 relative after
  every event;
- render_3d, render_frames_3d and render_tagged_3d write PNGs with the JAX
  package's names.
"""

import sys

import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from monorfs_tpu import viewer3d as jviewer3d  # noqa: E402
from monorfs_tpu.io.recording import Recording as JRecording  # noqa: E402
from monorfs_tpu_torch import viewer3d  # noqa: E402
from monorfs_tpu_torch.io.recording import Recording  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_viewer3d import _rec  # noqa: E402
from torch_parity import (CallRecorder, KEY_SEQUENCE, asset_recording_3d, assert_draw_lists_equal,  # noqa: E402
                          drive_window)


def _cases(n=50, seed=1):
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = 2 if i % 7 == 3 else 3  # 2x2 covariances into the 3D rings
        a = rng.normal(0, 1, (d, d)) * 10.0 ** rng.uniform(-3, 0)
        cov = a @ a.T
        if i % 5 == 0:
            v = rng.normal(0, 1, (d, 1))
            cov = v @ v.T  # rank one
        q = rng.normal(0, 1, 4)
        pose = np.concatenate([rng.normal(0, 2, 3), q / np.linalg.norm(q)])
        mp = np.array([rng.uniform(100, 600), 0.1, rng.uniform(1, 5), -320, -240, 640, 480])
        yield rng.normal(0, 2, d), cov, pose, mp


def test_geometry_matches_jax():
    for mean, cov, pose, mp in _cases():
        for g, w in zip(viewer3d._ellipsoid_wires(mean, cov), jviewer3d._ellipsoid_wires(mean, cov)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        np.testing.assert_allclose(viewer3d._quat_matrix(pose[3:]), jviewer3d._quat_matrix(pose[3:]),
                                   rtol=0, atol=1e-12)
        got, want = viewer3d._frustum_lines(pose, mp), jviewer3d._frustum_lines(pose, mp)
        assert len(got) == len(want) == 12
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert viewer3d._frustum_lines(np.zeros(7), None) == [] == jviewer3d._frustum_lines(np.zeros(7), None)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    d = tmp_path_factory.mktemp("recs3d")
    _rec().save(d / "tiny3d.zip")
    asset_recording_3d(d / "sim3d.zip")
    return {"tiny3d": d / "tiny3d.zip", "sim3d": d / "sim3d.zip"}


@pytest.mark.parametrize("name", ["tiny3d", "sim3d"])
def test_scene_draw_list_matches_jax(name, recordings):
    jrec, rec = JRecording.load(recordings[name]), Recording.load(recordings[name])
    for fi in range(len(rec.maps)):
        ax = CallRecorder()
        jviewer3d._scene_3d(ax, jrec, fi)
        calls, limits = viewer3d.scene_3d(rec, fi)
        assert_draw_lists_equal(ax.draws(), calls)
        want = {c[0]: c[1] for c in ax.calls if c[0] in ("set_xlim", "set_ylim", "set_zlim")}
        for key, lim in zip(("set_xlim", "set_ylim", "set_zlim"), limits):
            np.testing.assert_allclose(lim, want[key], rtol=0, atol=1e-12)
    assert any(c.kind == "scatter" for c in calls) and any(c.kw.get("color") == "orange" for c in calls)


def test_window_frames_match_jax(recordings, monkeypatch):
    jrec, rec = JRecording.load(recordings["tiny3d"]), Recording.load(recordings["tiny3d"])
    with monkeypatch.context() as m:
        want, _ = drive_window(m, lambda: jviewer3d.interactive_3d(jrec))
    with monkeypatch.context() as m:
        got, (scrub, camera) = drive_window(m, lambda: viewer3d.interactive_3d(rec, device="cpu"))
    assert got == want and scrub.frame == want[-1]
    plain = viewer3d.Scrubber(len(rec.maps))
    assert [plain.key(k) for k in KEY_SEQUENCE] == want


# mouse events in the 3D axes' view coordinates: moves with no button, an
# arcball turn through the ball, its border and beyond, a zoom, a pan, a turn
# of the zoomed and panned view, a new frame (the redraw keeps elev / azim,
# sets roll to 0 and the limits back), and a turn after it
MOUSE = ([("move", 0.01, 0.01, None), ("press", 0.0, 0.0, 1), ("move", 0.02, 0.005, None),
          ("move", 0.05, -0.03, None), ("move", 0.085, 0.08, None), ("release", 0.085, 0.08, 1),
          ("move", 0.0, 0.02, None), ("press", 0.0, 0.0, 3), ("move", 0.0, -0.02, None),
          ("move", 0.0, 0.01, None), ("release", 0.0, 0.01, 3), ("press", -0.02, 0.01, 2),
          ("move", 0.01, 0.03, None), ("move", 0.03, 0.0, None), ("release", 0.03, 0.0, 2),
          ("press", 0.03, -0.02, 1), ("move", -0.04, 0.05, None), ("release", -0.04, 0.05, 1),
          "left", ("press", 0.0, 0.0, 1), ("move", 0.01, 0.012, None), ("release", 0.01, 0.012, 1), "right"])


def _jax_window(monkeypatch, jrec):
    """The JAX interactive_3d (matplotlib's own Axes3D) driven by MOUSE at
    whole display pixels; returns the view coordinates the events carried
    and (frame, elev, azim, roll, limits) after each event."""
    seen = []

    def axes3d(fig):
        return next(a for a in fig.axes if a.name == "3d")

    def where(fig, x, y):
        px = np.round(axes3d(fig).transData.transform((x, y)))
        seen.append(axes3d(fig).transData.inverted().transform(px))
        return px

    def probe(fig):
        ax = axes3d(fig)
        return (ax.elev, ax.azim, ax.roll, ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d())

    states, _ = drive_window(monkeypatch, lambda: jviewer3d.interactive_3d(jrec), MOUSE, probe, where)
    return seen, states


def test_orbit_camera_drag(recordings, monkeypatch):
    """OrbitCamera, fed the view coordinates that matplotlib's Axes3D saw,
    gives its elev, azim, roll and limits after every event (1e-9)."""
    jrec, rec = JRecording.load(recordings["tiny3d"]), Recording.load(recordings["tiny3d"])
    with monkeypatch.context() as m:
        seen, want = _jax_window(m, jrec)
    assert len({round(w[1], 6) for w in want}) > 5 and any(abs(w[2]) > 1 for w in want)  # it turned, and rolled
    assert any(w[3] != want[0][3] for w in want)  # zoom and pan moved the limits
    cam, scrub, xy = viewer3d.OrbitCamera(), viewer3d.Scrubber(len(rec.maps)), iter(seen)
    for ev, w in zip(MOUSE, want):
        if isinstance(ev, str):
            scrub.key(ev)
            cam.reset()
        else:
            kind, _, _, button = ev
            x, y = next(xy)
            if kind == "press":
                cam.press(x, y, button)
            elif kind == "move":
                cam.drag(x, y, viewer3d.figure_3d(rec, scrub.frame, limits=cam.limits).view3d[:3])
            else:
                cam.release()
        np.testing.assert_allclose((cam.elev, cam.azim, cam.roll), w[:3], rtol=0, atol=1e-9)
        lims = cam.limits or viewer3d.scene_3d(rec, scrub.frame)[1]
        np.testing.assert_allclose(np.array(lims), np.array(w[3:]), rtol=1e-9, atol=1e-12)


def test_window_camera_matches_jax(recordings, monkeypatch):
    """The port's window, sent the same mouse events at the pixels of its
    own image that show the same view coordinates, turns, pans and zooms
    its camera as the JAX window's Axes3D does (1e-9), and the figure it
    shows carries that camera."""
    jrec, rec = JRecording.load(recordings["tiny3d"]), Recording.load(recordings["tiny3d"])
    with monkeypatch.context() as m:
        seen, want = _jax_window(m, jrec)
    cams, xy = [], iter(seen)
    aff = viewer3d.axes._layout3d(viewer3d.figure_3d(rec))[2]

    class Spy(viewer3d.OrbitCamera):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            cams.append(self)

    def where(fig, x, y):  # the view point (x, y) as the JAX event carried it, on the port's image
        u, v = next(xy)
        px, py = viewer3d.axes.transform.apply_affine(aff, u, v)
        return fig.axes[0].transData.transform((px - 0.5, py - 0.5))

    def probe(fig):
        cam = cams[-1]
        return (cam.elev, cam.azim, cam.roll) + tuple(cam.limits or viewer3d.scene_3d(rec, 0)[1])

    with monkeypatch.context() as m:
        m.setattr(viewer3d, "OrbitCamera", Spy)
        got, (scrub, camera) = drive_window(m, lambda: viewer3d.interactive_3d(rec, device="cpu"), MOUSE, probe,
                                            where)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:3], w[:3], rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.array(g[3:]), np.array(w[3:]), rtol=1e-9, atol=1e-12)
    fig = viewer3d.figure_3d(rec, scrub.frame, camera.elev, camera.azim, roll=camera.roll, limits=camera.limits)
    assert fig.view3d[3:] == (camera.elev, camera.azim, camera.roll)


def test_render_outputs(recordings, tmp_path):
    rec = Recording.load(recordings["tiny3d"])
    viewer3d.render_3d(rec, tmp_path / "one.png", device="cpu")
    img = np.asarray(Image.open(tmp_path / "one.png").convert("RGB"))
    assert img.shape == (viewer3d.SIZE[1], viewer3d.SIZE[0], 3) and (img != 255).sum() > 2000
    outs = viewer3d.render_frames_3d(rec, str(tmp_path / "frames"), stride=2, device="cpu")
    assert [o.rsplit("/", 1)[1] for o in outs] == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]
    outs = viewer3d.render_tagged_3d(rec, str(tmp_path / "tags"), device="cpu")
    assert len(outs) == 1 and "screenshot_test" in outs[0]
    # the port's file names are the JAX package's
    jouts = jviewer3d.render_tagged_3d(JRecording.load(recordings["tiny3d"]), str(tmp_path / "jtags"))
    assert [o.rsplit("/", 1)[1] for o in outs] == [o.rsplit("/", 1)[1] for o in jouts]
