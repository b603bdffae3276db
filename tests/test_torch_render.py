"""The port's rasterizer (monorfs_tpu_torch.render) on the CPU.

- png: read_png(write_png(x)) equals x, and so does PIL's reading of it
  (PIL is used here only, as the reference reader);
- png: read_png refuses what write_png does not write (PIL's filtered rows);
- transform: the 3D projection, through the device path (to_pixels),
  equals matplotlib's own (proj3d.proj_transform with Axes3D.get_proj after
  view_init and the same limits) to 1e-9 at five (elev, azim, roll);
- canvas: a segment's end pixels carry its colour; a batch of frames drawn
  in one call equals the frames drawn one by one, byte for byte, figures of
  different dpi in one batch among them; two renders
  of the same figures are byte-identical (PNG bytes too);
- font and axes: every printable character lights pixels (space none), and
  ticks fall at 1-2-5 steps inside the limits.
Inputs are made from seeded numpy generators.
"""

import io

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from mpl_toolkits.mplot3d import proj3d  # noqa: E402
from PIL import Image  # noqa: E402

from monorfs_tpu_torch.render import axes, font, transform  # noqa: E402
from monorfs_tpu_torch.render.canvas import Canvas  # noqa: E402
from monorfs_tpu_torch.render.png import encode_png, read_png, write_png  # noqa: E402


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 48)])
def test_png_roundtrip(shape, tmp_path):
    x = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,), dtype=np.uint8)
    path = tmp_path / "x.png"
    n = write_png(path, torch.from_numpy(x))
    assert n == path.stat().st_size
    np.testing.assert_array_equal(read_png(path), x)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), x)


def test_read_png_refuses_other_pngs(tmp_path):
    """PIL writes the adaptive row filters (Sub, Up, Average, Paeth) and
    grey PNGs; read_png reads what write_png writes only, and says so."""
    yy, xx = np.mgrid[0:40, 0:50]
    x = np.stack([xx * 5, yy * 6, (xx * yy) % 256], -1).astype(np.uint8)
    Image.fromarray(x).save(tmp_path / "p.png", optimize=True)
    with pytest.raises(ValueError, match="filter"):
        read_png(tmp_path / "p.png")
    Image.fromarray(x[..., 0]).save(tmp_path / "g.png")
    with pytest.raises(ValueError, match="8-bit RGB only"):
        read_png(tmp_path / "g.png")


@pytest.mark.parametrize("elev,azim,roll", [(25, -60, 0), (0, 0, 0), (90, -90, 30), (-30, 120, -75),
                                            (60, 200, 140)])
def test_projection_matches_matplotlib(elev, azim, roll):
    rng = np.random.default_rng(abs(int(elev * 7 + azim)))
    lims = np.sort(rng.normal(0, 2, (3, 2)), axis=1)
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim, roll=roll)
    ax.set_xlim(*lims[0])
    ax.set_ylim(*lims[1])
    ax.set_zlim(*lims[2])
    want_m = ax.get_proj()
    plt.close(fig)
    m = transform.proj_matrix(*lims, elev, azim, roll)
    np.testing.assert_allclose(m, want_m, rtol=0, atol=1e-9)
    pts = rng.normal(0, 2, (3, 200))
    want = proj3d.proj_transform(*pts, want_m)
    ident = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]], dtype=torch.float64)
    got = transform.to_pixels(torch.from_numpy(pts.T.copy()), torch.zeros(200, dtype=torch.long),
                              torch.from_numpy(m)[None], ident)
    np.testing.assert_allclose(got.numpy(), np.stack(want[:2], 1), rtol=0, atol=1e-9)


def test_segment_end_pixels_carry_colour():
    rng = np.random.default_rng(3)
    c = Canvas(1, 80, 100, "cpu")
    ends = []
    for k in range(6):
        rgb = tuple(rng.random(3))
        # ends at pixel centres
        seg = np.concatenate([rng.integers(5, 95, 1), rng.integers(5, 75, 1), rng.integers(5, 95, 1),
                              rng.integers(5, 75, 1)]) + 0.5
        c.segments(c.layer(0, rgb), seg[None], 2.0)
        ends.append((seg, rgb))
    img = c.render()[0].numpy().astype(int)
    # the last segment lies on top of all: both its end pixels are its colour
    seg, rgb = ends[-1]
    want = np.floor(np.array(rgb) * 255 + 0.5)
    for x, y in ((seg[0], seg[1]), (seg[2], seg[3])):
        np.testing.assert_array_equal(img[int(y), int(x)], want)


def _figures(n, seed=0, dpis=(60.0,)):
    rng = np.random.default_rng(seed)
    figs = []
    for i in range(n):
        walk = np.cumsum(rng.normal(0, 1, (30, 2)), 0)
        calls = [axes.Call("plot", (walk[:, 0], walk[:, 1]), "k-", dict(lw=1.2, label="walk")),
                 axes.Call("plot", (walk[::5, 0], walk[::5, 1]), "g+", dict(ms=6)),
                 axes.Call("plot", (walk[:3, 0], walk[:3, 1]), "k*", dict(ms=8, label="stars")),
                 axes.Call("plot", ([0, walk[-1, 0]], [0, walk[-1, 1]]), "r-", dict(lw=0.4, alpha=0.5))]
        figs.append(axes.Figure(calls, title=f"frame {i}", size=(320, 240), dpi=dpis[i % len(dpis)], legend="best"))
    pts = rng.normal(0, 1, (3, 20))
    figs.append(axes.Figure([axes.Call("plot", tuple(pts), "b-", dict(lw=1.0)),
                             axes.Call("scatter", tuple(pts[:, :4]), "", dict(marker="*", s=40, c="k"))],
                            size=(320, 240), dpi=60.0, view3d=((-2, 2), (-2, 2), (-2, 2), 25.0, -60.0, 0.0),
                            xlabel="x", ylabel="y", zlabel="z", title="3d"))
    return figs


@pytest.mark.parametrize("dpis", [(60.0,), (60.0, 144.0, 30.0)])
def test_batch_equals_one_by_one(dpis):
    figs = _figures(4, dpis=dpis)
    batch = axes.render(figs, "cpu")
    for i, f in enumerate(figs):
        np.testing.assert_array_equal(batch[i].numpy(), axes.render([f], "cpu")[0].numpy())
    assert (batch != 255).any(dim=(1, 2, 3)).all()  # every frame drew something


def test_renders_repeat_bit_for_bit():
    figs = _figures(3, seed=5)
    a, b = axes.render(figs, "cpu"), axes.render(figs, "cpu")
    assert torch.equal(a, b)
    assert encode_png(a[0].numpy()) == encode_png(b[0].numpy())
    buf = io.BytesIO()
    write_png(buf, a[1])
    assert buf.getvalue() == encode_png(b[1].numpy())


def test_font_and_ticks():
    for code in range(32, 127):
        rows, cols = font.text_pixels(chr(code), 0, 0)
        assert (len(rows) == 0) == (code == 32)
        assert rows.max(initial=0) < font.GLYPH_H and cols.max(initial=0) < font.GLYPH_W
    assert font.text_size("abc", 2) == (34, 14)
    ticks, labels = axes.nice_ticks(-0.37, 1.21)
    assert labels == ["-0.2", "0.0", "0.2", "0.4", "0.6", "0.8", "1.0", "1.2"]
    ticks, labels = axes.nice_ticks(0, 270)
    assert ticks[0] == 0 and labels[-1] == "250" and all(0 <= t <= 270 for t in ticks)


def test_empty_and_single_point_calls():
    """An empty series (a recording with no estimate yet) and a one-point
    line draw nothing, as in matplotlib, while a one-point marker call draws
    its marker; a figure without calls is blank but for its axes."""
    calls = [axes.Call("plot", (np.zeros(0), np.zeros(0)), "k-", dict(label="empty")),
             axes.Call("plot", (np.zeros(0), np.zeros(0)), "k*"),
             axes.Call("plot", ([1.0], [2.0]), "b-", dict(lw=3.0))]
    figs = [axes.Figure(calls, size=(320, 240), dpi=50.0, legend="best"),
            axes.Figure(calls + [axes.Call("plot", ([1.0], [2.0]), "b+", dict(ms=12))], size=(320, 240), dpi=50.0),
            axes.Figure([], size=(320, 240), dpi=50.0)]
    img = axes.render(figs, "cpu").numpy()
    blue = (img[..., 2] > 200) & (img[..., 0] < 60)
    assert blue[0].sum() == 0 and blue[1].sum() >= 8 and blue[2].sum() == 0
