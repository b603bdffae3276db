"""The port's MJPEG AVI (monorfs_tpu_torch/io/avi.py, a NumPy baseline JPEG
encoder with no PIL) and the recording's sidebar.avi member, against the
JAX package's io.avi / io.recording and PIL's decoder (present here, not on
the card's machine).

Tolerances: at quality 85 the decoded frames' luminance is within a mean
absolute error of 3 grey levels of the sensor-view frames', and their RGB
error is no larger than that of the JAX package's PIL encoding of the same
frames; the containers are read back frame for frame, byte for byte.

The port's decoder (decode_frames / jpeg_decode: Huffman on the host, the
rest on the device) against the JAX package's decode_frames (PIL, i.e.
libjpeg) on the frames the JAX package's write_mjpeg encodes (4:2:0,
quality 85), on the port encoder's (4:4:4), on grey frames, at odd sizes
such as 30 x 41, and on PIL's 4:2:2 encodings and encodings with restart
markers: the pixels are equal, because the port computes libjpeg's islow
IDCT, fancy upsampling and colour tables in libjpeg's own integer
arithmetic (a tighter test than the 2-level bound a float IDCT would
need). The port encoder's frames decode to within the mean error of 3
levels above of the frames they were encoded from."""

import io

import numpy as np
import pytest
import torch
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


def _test_images(seed=0, shape=(61, 83)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = np.stack([128 + 100 * np.sin(xx / 7), 128 + 100 * np.cos(yy / 5), (xx * yy) % 256], -1)
    noisy = np.clip(smooth + rng.integers(-20, 20, smooth.shape), 0, 255).astype(np.uint8)
    return [noisy, rng.integers(0, 256, shape + (3,), dtype=np.uint8)] + sidebar_frames(2, seed=seed)


def _pil_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["jax-420", "port-444", "grey", "odd-30x41", "pil-422", "restart",
                                  "pil-444-q100", "tiny-5x3"])
def test_decoder_matches_jax(kind):
    """The port's decode_frames against the JAX package's (PIL) on the same
    JPEG bytes: equal pixels."""
    jpegs = []
    for i, img in enumerate(_test_images(seed=len(kind))):
        if kind == "jax-420":
            jpegs.append(javi.jpeg_encode(img)[0])
        elif kind == "port-444":
            jpegs.append(avi.jpeg_encode(img)[0])
        elif kind == "grey":
            jpegs += [avi.jpeg_encode(img[..., i % 3])[0], _pil_jpeg(img[..., 0], quality=70)]
        elif kind == "odd-30x41":
            jpegs += [javi.jpeg_encode(img[:30, :41])[0], avi.jpeg_encode(img[:30, :41])[0]]
        elif kind == "pil-422":
            jpegs.append(_pil_jpeg(img, quality=85, subsampling=1))
        elif kind == "restart":
            jpegs.append(_pil_jpeg(img, quality=90, restart_marker_blocks=1 + i))
        elif kind == "pil-444-q100":
            jpegs.append(_pil_jpeg(img, quality=100, subsampling=0))
        else:
            jpegs.append(_pil_jpeg(img[:5, :3], quality=85))
    got, want = avi.decode_frames(jpegs, device="cpu"), javi.decode_frames(jpegs)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if kind == "restart":
        assert all(b"\xff\xdd" in j for j in jpegs)


def test_decoder_reads_avi_files_of_both_packages(tmp_path):
    frames = sidebar_frames(3, h=45, w=61)
    javi.write_mjpeg(str(tmp_path / "j.avi"), frames, fps=5)
    avi.write_mjpeg(str(tmp_path / "p.avi"), frames, fps=5)
    for name in ("j.avi", "p.avi"):
        got = avi.decode_frames(avi.read_mjpeg(str(tmp_path / name)), device="cpu")
        want = javi.decode_frames(javi.read_mjpeg(str(tmp_path / name)))
        assert len(got) == 3
        for g, w, f in zip(got, want, frames):
            np.testing.assert_array_equal(g, w)
            if name == "p.avi":  # the port's 4:4:4 encoding keeps the red marks' chroma
                assert np.abs(g.astype(float) - f).mean() < 3.0


def test_decoder_refuses_other_jpeg():
    img = _test_images()[0]
    with pytest.raises(ValueError, match="progressive"):
        avi.jpeg_decode(_pil_jpeg(img, progressive=True), device="cpu")
    with pytest.raises(ValueError, match="not a JPEG"):
        avi.jpeg_decode(b"\x89PNG\r\n", device="cpu")
    tensor = avi.jpeg_decode(avi.jpeg_encode(img)[0], device="cpu")
    assert tensor.dtype == torch.uint8 and tuple(tensor.shape) == img.shape
