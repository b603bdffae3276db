"""The port's MJPEG AVI (monorfs_tpu_torch/io/avi.py, a NumPy baseline JPEG
encoder with no PIL) and the recording's sidebar.avi member, against the
JAX package's io.avi / io.recording and PIL's decoder (present here, not on
the card's machine).

Tolerances: at quality 85 the decoded frames' luminance is within a mean
absolute error of 3 grey levels of the sensor-view frames', and their RGB
error is no larger than that of the JAX package's PIL encoding of the same
frames; the containers are read back frame for frame, byte for byte."""

import io

import numpy as np
import pytest
from PIL import Image

from monorfs_tpu.io import avi as javi
from monorfs_tpu.io.recording import Recording as JRecording

from monorfs_tpu_torch.io import avi
from monorfs_tpu_torch.io.recording import Recording
from monorfs_tpu_torch.io.world import World


def sidebar_frames(n=4, h=30, w=40, seed=0):
    """Sensor-view frames as the simulation draws them: a normalised depth
    map (a slanted wall with a near box) with keypoints marked red."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y, x = np.mgrid[0:h, 0:w]
        depth = 1.2 + 0.01 * x + 0.005 * y + i * 0.02
        depth[h // 4 : h // 2, w // 3 : w // 2] = 0.8
        img = ((depth - depth.min()) / (depth.max() - depth.min()) * 255).astype(np.uint8)
        rgb = np.stack([img] * 3, axis=-1)
        for px, py in rng.integers(2, [w - 2, h - 2], (6, 2)):
            rgb[py - 1 : py + 2, px - 1 : px + 2] = (255, 64, 64)
        out.append(rgb)
    return out


def decode(jpeg):
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")).astype(float)


def luma(rgb):
    return rgb @ np.array([0.299, 0.587, 0.114])


@pytest.mark.parametrize("shape", [(30, 40), (120, 160), (37, 53)])
def test_port_mjpeg_read_by_jax_and_pil(shape):
    h, w = shape
    frames = sidebar_frames(4, h, w)
    buf = io.BytesIO()
    assert avi.write_mjpeg(buf, frames, fps=30, quality=85) == 4
    jpegs = javi.read_mjpeg(io.BytesIO(buf.getvalue()))
    assert len(jpegs) == 4
    for jpeg, frame in zip(jpegs, frames):
        assert jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9"
        assert avi.jpeg_size(jpeg) == (w, h) == Image.open(io.BytesIO(jpeg)).size
        got, ref = decode(jpeg), decode(javi.jpeg_encode(frame, 85)[0])
        assert np.abs(luma(got) - luma(frame)).mean() <= 3.0
        assert np.abs(got - frame).mean() <= np.abs(ref - frame).mean()
    assert avi.read_mjpeg(io.BytesIO(buf.getvalue())) == jpegs


def test_grey_frames_and_quality():
    """A [H, W] frame is one grey component; higher quality, smaller error;
    quality 100 is near lossless."""
    frame = sidebar_frames(1, 48, 64)[0][..., 0]
    errs = []
    for q in (10, 50, 85, 100):
        jpeg, size = avi.jpeg_encode(frame, q)
        assert size == (64, 48)
        dec = np.asarray(Image.open(io.BytesIO(jpeg)))
        assert dec.shape == frame.shape
        errs.append(np.abs(dec.astype(float) - frame).mean())
    assert errs == sorted(errs, reverse=True) and errs[-1] < 0.5 and errs[2] <= 3.0
    # a float frame is scaled over its own range first, as the JAX encoder does
    f = frame.astype(np.float32) / 255.0 * 3.0 + 1.0
    np.testing.assert_allclose(decode(avi.jpeg_encode(f, 100)[0])[..., 0], frame, atol=2.0)


def test_jax_mjpeg_read_by_port():
    frames = sidebar_frames(3)
    buf = io.BytesIO()
    javi.write_mjpeg(buf, frames, fps=10)
    assert avi.read_mjpeg(io.BytesIO(buf.getvalue())) == javi.read_mjpeg(io.BytesIO(buf.getvalue()))
    # pre-encoded payloads pass through the port's writer unchanged
    jpegs = avi.read_mjpeg(io.BytesIO(buf.getvalue()))
    out = io.BytesIO()
    avi.write_mjpeg(out, jpegs, fps=10)
    assert avi.read_mjpeg(io.BytesIO(out.getvalue())) == jpegs
    with pytest.raises(ValueError):
        avi.read_mjpeg(io.BytesIO(b"RIFF\x00\x00\x00\x00WAVE"))


def test_recording_sidebar_round_trip(tmp_path):
    frames = sidebar_frames(3)
    buf = io.BytesIO()
    avi.write_mjpeg(buf, [avi.jpeg_encode(f)[0] for f in frames], fps=30)
    world = World(pose=np.array([0, 0, 0, 1, 0, 0, 0.0]), landmarks=np.zeros((0, 3)), measurer_params=None)
    rec = Recording(world=world, trajectory=[(0.0, world.pose)], odometry=[(0.0, np.zeros(6))],
                    estimate=[(0.0, [(0.0, world.pose)])], maps=[(0.0, [])], vismaps=[(0.0, [])],
                    measurements=[(0.0, [])], tags=[], config_text="", sidebar=buf.getvalue())
    rec.save(tmp_path / "rec.zip")
    back, jback = Recording.load(tmp_path / "rec.zip"), JRecording.load(tmp_path / "rec.zip")
    assert back.sidebar == jback.sidebar == buf.getvalue()
    assert len(avi.read_mjpeg(io.BytesIO(back.sidebar))) == 3
    # without frames the member is absent, and reads back empty
    rec.sidebar = b""
    rec.save(tmp_path / "plain.zip")
    assert Recording.load(tmp_path / "plain.zip").sidebar == b""
