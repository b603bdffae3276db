"""The port's top-down viewer (monorfs_tpu_torch.viewer) against the JAX
package's (monorfs_tpu.viewer) on the CPU.

- _ellipse equals the JAX function to 1e-12 (float64) on 50 seeded
  covariances, rank-deficient and 3x3 ones among them;
- the draw list (overview_calls) equals the calls the JAX render_overview
  makes on its axes, call by call (data to 1e-12, format strings and keyword
  arguments equal), recorded by replacing plt.subplots in the test only, on
  the JAX tests' tiny recording (tests/test_viewer.py) and on a 10-frame CPU
  recording of the 3D asset world, at every frame;
- the window: under Agg with plt.show driven by synthetic key events, the
  port's Scrubber and slider give the JAX slider's frame index after every
  event of one key sequence;
- the command line writes the JAX package's output names; the AVI it writes
  reads back (read_mjpeg) and decodes (decode_frames) to frames of the
  canvas's size; a PNG written on the CPU reads back with PIL.
"""

import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from monorfs_tpu import viewer as jviewer  # noqa: E402
from monorfs_tpu.io.recording import Recording as JRecording  # noqa: E402
from monorfs_tpu_torch import viewer  # noqa: E402
from monorfs_tpu_torch.io import avi  # noqa: E402
from monorfs_tpu_torch.io.recording import Recording  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_viewer import tiny_recording  # noqa: E402
from torch_parity import (CallRecorder, KEY_SEQUENCE, asset_recording_3d, assert_draw_lists_equal,  # noqa: E402
                          drive_window)


def _covariances(n=50, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = 3 if i % 2 else 2
        a = rng.normal(0, 1, (d, d)) * 10.0 ** rng.uniform(-3, 1)
        c = a @ a.T
        if i % 5 == 0:  # rank-deficient
            v = rng.normal(0, 1, (d, 1))
            c = v @ v.T
        out.append((rng.normal(0, 3, d), c))
    out.append((np.zeros(2), np.zeros((2, 2))))
    return out


def test_ellipse_matches_jax():
    for mean, cov in _covariances():
        got, want = viewer._ellipse(mean, cov), jviewer._ellipse(mean, cov)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    d = tmp_path_factory.mktemp("recs")
    tiny_recording().save(d / "tiny.zip")
    asset_recording_3d(d / "sim3d.zip")
    return {"tiny": d / "tiny.zip", "sim3d": d / "sim3d.zip"}


def _jax_overview_calls(monkeypatch, jrec, frame):
    ax = CallRecorder()
    fig = CallRecorder()
    monkeypatch.setattr(plt, "subplots", lambda *a, **k: (fig, ax))
    monkeypatch.setattr(plt, "close", lambda *a, **k: None)
    jviewer.render_overview(jrec, "unused.png", frame=frame)
    return ax


@pytest.mark.parametrize("name", ["tiny", "sim3d"])
def test_overview_draw_list_matches_jax(name, recordings, monkeypatch):
    jrec, rec = JRecording.load(recordings[name]), Recording.load(recordings[name])
    for frame in [None] + list(range(len(rec.maps))):
        with monkeypatch.context() as m:
            ax = _jax_overview_calls(m, jrec, frame)
        calls, fi = viewer.overview_calls(rec, frame)
        assert_draw_lists_equal(ax.draws(), calls)
        title = [c for c in ax.calls if c[0] == "set_title"][0][1][0]
        assert viewer.overview_figure(rec, frame).title == title == f"frame {fi}"


def test_window_frames_match_jax(recordings, monkeypatch):
    jrec, rec = JRecording.load(recordings["tiny"]), Recording.load(recordings["tiny"])
    with monkeypatch.context() as m:
        want, _ = drive_window(m, lambda: jviewer.interactive(jrec))
    with monkeypatch.context() as m:
        got, scrub = drive_window(m, lambda: viewer.interactive(rec, device="cpu"))
    assert got == want and scrub.frame == want[-1]
    plain, n = viewer.Scrubber(len(rec.maps)), len(rec.maps)
    assert [plain.key(k) for k in KEY_SEQUENCE] == want
    assert 0 in want and n - 1 in want


def test_window_needs_matplotlib(recordings, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viewer.interactive(Recording.load(recordings["tiny"]), device="cpu")


def test_cli_outputs(recordings, tmp_path):
    rec_file = tmp_path / "rec.zip"
    rec_file.write_bytes(recordings["tiny"].read_bytes())
    assert viewer.main(["-f", str(rec_file), "--device", "cpu"]) == 0
    img = np.asarray(Image.open(str(rec_file) + ".png").convert("RGB"))
    assert img.shape == (viewer.SIZE[1], viewer.SIZE[0], 3) and (img != 255).any()
    viewer.main(["-f", str(rec_file), "--frames", str(tmp_path / "frames"), "--stride", "2", "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "frames").iterdir()) == [
        "frame_00000.png", "frame_00002.png", "frame_00004.png"]
    viewer.main(["-f", str(rec_file), "--tag", "0.07:loop closure", "--device", "cpu"])
    assert any(msg == "loop closure" for _, msg in Recording.load(rec_file).tags)
    viewer.main(["-f", str(rec_file), "--tag-shots", str(tmp_path / "tags"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "tags").iterdir()) == ["tag_0000.000.png", "tag_0000.070.png"]
    viewer.main(["-f", str(rec_file), "--avi", str(tmp_path / "r.avi"), "--stride", "2", "--device", "cpu"])
    frames = avi.decode_frames(avi.read_mjpeg(str(tmp_path / "r.avi")), device="cpu")
    assert len(frames) == 3 and frames[0].shape == (viewer.SIZE[1], viewer.SIZE[0], 3)
    # the encoded frame is the rendered frame, to the JPEG's loss
    first = viewer._frame_image(Recording.load(rec_file), 0, "cpu").numpy().astype(float)
    assert np.abs(frames[0] - first).mean() < 3


def test_flat_and_three_d_routes(recordings, tmp_path):
    rec_file = tmp_path / "sim3d.zip"
    rec_file.write_bytes(recordings["sim3d"].read_bytes())
    viewer.main(["-f", str(rec_file), "--device", "cpu"])
    assert (tmp_path / "sim3d.zip.3d.png").exists()
    viewer.main(["-f", str(rec_file), "--flat", "-o", str(tmp_path / "flat.png"), "--device", "cpu"])
    viewer.main(["-f", str(rec_file), "--flat", "--frame", "3", "-o", str(tmp_path / "flat3.png"),
                 "--device", "cpu"])
    a, b = (np.asarray(Image.open(tmp_path / n)) for n in ("flat.png", "flat3.png"))
    assert a.shape == b.shape and (a != b).any()


def test_sidebar_export(recordings, tmp_path):
    rec = Recording.load(recordings["tiny"])
    import io

    buf = io.BytesIO()
    avi.write_mjpeg(buf, [np.zeros((8, 8), np.uint8)], fps=1)
    rec.sidebar = buf.getvalue()
    rec.save(tmp_path / "rec.zip")
    viewer.main(["-f", str(tmp_path / "rec.zip"), "--sidebar", str(tmp_path / "side.avi"), "--device", "cpu"])
    assert len(avi.read_mjpeg(str(tmp_path / "side.avi"))) == 1
