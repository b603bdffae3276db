"""Figures of the port's viewers and plots: matplotlib-style calls drawn
into a batched canvas, with the axes pieces that make a figure readable.

A `Call` is one `ax.plot` / `ax.scatter` call as the JAX viewers make it:
its data arrays, its format string and its keyword arguments, kept as
given so that a draw list can be held against the JAX function's calls. A
`Figure` is one frame: its calls, title, labels, legend and either a 2D
axes (equal aspect or not) or a 3D view. `render(figures, device)` draws a
batch of figures in one pass: every data point of every frame goes to the
device in one tensor, through its frame's projection to pixels
(transform.to_pixels), and every line, marker, text and box of the batch
is one layer of one Canvas.

Sizes follow matplotlib's: a line width or marker size in points is
points * dpi / 72 pixels; '+' is two strokes of the marker size with
markeredgewidth 1 point; '*' is a filled star of outer radius half the
marker size; a scatter marker's size s is points squared. 2D axes get a
frame, ticks at 1-2-5 steps with numeric labels, axis labels and a title;
3D axes the edges of the box of their limits and the axis names. The
legend is a box of the labelled calls, each line's colour beside its label.
Tick positions are not matplotlib's.
"""

import dataclasses
import math

import numpy as np
import torch

from . import font, transform
from .canvas import Canvas

# matplotlib's single-letter colours, 'orange' and the default cycle (tab10)
COLORS = {"b": (0, 0, 1), "g": (0, 0.5, 0), "r": (1, 0, 0), "c": (0, 0.75, 0.75),
          "m": (0.75, 0, 0.75), "y": (0.75, 0.75, 0), "k": (0, 0, 0), "w": (1, 1, 1),
          "orange": (1, 165 / 255, 0)}
CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2", "#7f7f7f",
         "#bcbd22", "#17becf"]
MARKERS = "*+o."
TEXT_SCALE = 2
GREY = (0.5, 0.5, 0.5)


def color_rgb(c):
    if isinstance(c, str) and c.startswith("#"):
        return tuple(int(c[i:i + 2], 16) / 255 for i in (1, 3, 5))
    if isinstance(c, str):
        return COLORS[c]
    return tuple(float(v) for v in c[:3])


@dataclasses.dataclass
class Call:
    """One ax.plot(*data, fmt, **kw) or ax.scatter(*data, **kw)."""
    kind: str
    data: tuple
    fmt: str = ""
    kw: dict = dataclasses.field(default_factory=dict)

    def color(self):
        """The call's own colour (format letter, color= or c=), or None
        when it takes the next colour of the cycle."""
        letter = next((c for c in self.fmt if c in "bgrcmykw"), None)
        return self.kw.get("color", self.kw.get("c", letter))

    def style(self, color):
        """(rgb, alpha, line width pt or None, marker or None, marker size pt)."""
        fmt, kw = self.fmt, self.kw
        marker = kw.get("marker", next((m for m in fmt if m in MARKERS), None))
        if self.kind == "scatter":
            return color_rgb(color), kw.get("alpha", 1.0), None, marker or "o", math.sqrt(kw.get("s", 36.0))
        line = "-" in fmt or not marker
        lw = kw.get("lw", kw.get("linewidth", 1.5)) if line else None
        return color_rgb(color), kw.get("alpha", 1.0), lw, marker, kw.get("ms", kw.get("markersize", 6.0))


@dataclasses.dataclass
class Figure:
    """One frame: calls in draw order and the axes around them. view3d is
    (xlim, ylim, zlim, elev, azim, roll) for a 3D axes, None for 2D."""
    calls: list
    title: str = ""
    size: tuple = (960, 720)
    dpi: float = 120.0
    equal: bool = True
    view3d: tuple = None
    xlabel: str = ""
    ylabel: str = ""
    zlabel: str = ""
    legend: str = None  # 'best', 'upper left', 'upper right', or None


def nice_ticks(lo, hi, target=8):
    """Ticks at a 1-2-5 step inside [lo, hi] and their labels."""
    if not hi > lo:
        return [], []
    raw = (hi - lo) / target
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    ticks = np.arange(math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9) + 1) * step
    dec = max(0, -int(math.floor(math.log10(step) + 1e-9)))
    labels = [f"{v:.{dec}f}" for v in ticks]
    return list(ticks), [lb[1:] if lb.startswith("-") and float(lb) == 0 else lb for lb in labels]


def _points(call):
    """The call's data as [n, 3] float64 (z = 0 in 2D)."""
    cols = [np.atleast_1d(np.asarray(d, dtype=np.float64)).ravel() for d in call.data]
    if len(cols) == 2:
        cols.append(np.zeros_like(cols[0]))
    return np.stack(cols, axis=1)


class _Batch:
    """Data points of every figure, their frames, and what draws them."""

    def __init__(self):
        self.points, self.frames = [], []
        self.n = 0
        self.lines = []  # (first point index, count, layer, width px)
        self.markers = []  # (first point index, count, layer, marker, size px, dpi)

    def add(self, pts, frame):
        first = self.n
        self.points.append(pts)
        self.frames.append(np.full(len(pts), frame, np.int64))
        self.n += len(pts)
        return first


def _text(canvas, layer, s, x, y, anchor="lt", scale=TEXT_SCALE, vertical=False):
    if vertical:  # turned a quarter anticlockwise about (x, y)
        rows, cols = font.text_pixels(s, 0, 0, scale, anchor)
        canvas.pixels(layer, int(round(y)) - cols, int(round(x)) + rows)
    else:
        canvas.pixels(layer, *font.text_pixels(s, x, y, scale, anchor))


def _layout2d(fig, pts_all):
    w, h = fig.size
    box = (90, 45, w - 25, h - 70)
    if pts_all.size:
        finite = pts_all[np.isfinite(pts_all).all(1)]
        lo, hi = finite.min(0), finite.max(0)
    else:
        lo, hi = np.zeros(3), np.ones(3)
    xlim = transform.autoscale(lo[0], hi[0])
    ylim = transform.autoscale(lo[1], hi[1])
    xlim, ylim, aff = transform.axes2d(xlim, ylim, box, fig.equal)
    return box, xlim, ylim, np.eye(4), aff


def _layout3d(fig):
    w, h = fig.size
    side = min(w - 40, h - 90)
    x0, y0 = (w - side) / 2, 50 + (h - 90 - side) / 2
    box = (x0, y0, x0 + side, y0 + side)
    return box, transform.proj_matrix(*fig.view3d), transform.axes3d(box)


def view_coords(fig, x, y):
    """The 3D axes' 2D view coordinates (the projected x, y that an
    Axes3D's mouse events carry as xdata, ydata) of the pixel point (x, y)
    of the figure fig."""
    return transform.invert_affine(_layout3d(fig)[2], x, y)


def _decorate2d(canvas, f, fig, box, xlim, ylim, aff):
    x0, y0, x1, y1 = box
    ink = canvas.layer(f, (0, 0, 0))
    px = fig.dpi / 72
    segs = [[x0, y0, x1, y0], [x1, y0, x1, y1], [x1, y1, x0, y1], [x0, y1, x0, y0]]
    for v, lb in zip(*nice_ticks(*xlim)):
        x, _ = transform.apply_affine(aff, v, 0.0)
        segs.append([x, y1, x, y1 + 3.5 * px])
        _text(canvas, ink, lb, x, y1 + 5 * px, "ct")
    for v, lb in zip(*nice_ticks(*ylim)):
        _, y = transform.apply_affine(aff, 0.0, v)
        segs.append([x0, y, x0 - 3.5 * px, y])
        _text(canvas, ink, lb, x0 - 5 * px, y, "rm")
    canvas.segments(ink, np.array(segs), 0.8 * px)
    if fig.xlabel:
        _text(canvas, ink, fig.xlabel, (x0 + x1) / 2, y1 + 5 * px + 22, "ct")
    if fig.ylabel:
        _text(canvas, ink, fig.ylabel, 8, (y0 + y1) / 2, "ct", vertical=True)


def _box_corners(xlim, ylim, zlim):
    """The 8 corners of the limits' box, corner i at bit 2 / 1 / 0 of i for
    the upper x / y / z limit."""
    return np.array([[x, y, z] for x in xlim for y in ylim for z in zlim], np.float64)


BOX_EDGES = [(i, j) for i in range(8) for j in range(i + 1, 8) if bin(i ^ j).count("1") == 1]


def _legend(canvas, f, fig, entries, box, occupied):
    """entries: (label, rgb, alpha, width px or None, marker, size px)."""
    if not entries or not fig.legend:
        return
    scale = TEXT_SCALE
    pad, swatch, row_h = 8, 36, font.LINE * scale + 4
    tw = max(font.text_size(e[0], scale)[0] for e in entries)
    bw, bh = pad * 3 + swatch + tw, pad * 2 + row_h * len(entries) - 4
    x0, y0, x1, y1 = box
    corners = {"upper right": (x1 - 10 - bw, y0 + 10), "upper left": (x0 + 10, y0 + 10),
               "lower left": (x0 + 10, y1 - 10 - bh), "lower right": (x1 - 10 - bw, y1 - 10 - bh)}
    if fig.legend == "best":  # the corner over the fewest data points
        def inside(c):
            return int(((occupied[:, 0] >= c[0]) & (occupied[:, 0] <= c[0] + bw)
                        & (occupied[:, 1] >= c[1]) & (occupied[:, 1] <= c[1] + bh)).sum())
        lx, ly = min(corners.values(), key=inside)
    else:
        lx, ly = corners[fig.legend]
    canvas.rect(canvas.layer(f, (1, 1, 1), 0.8), lx, ly, lx + bw, ly + bh)
    frame = canvas.layer(f, (0.8, 0.8, 0.8))
    canvas.segments(frame, np.array([[lx, ly, lx + bw, ly], [lx + bw, ly, lx + bw, ly + bh],
                                     [lx + bw, ly + bh, lx, ly + bh], [lx, ly + bh, lx, ly]]), 1.0)
    for i, (label, rgb, alpha, width, marker, size) in enumerate(entries):
        cy = ly + pad + i * row_h + font.GLYPH_H * scale / 2
        layer = canvas.layer(f, rgb, alpha)
        if width is not None:
            canvas.segments(layer, np.array([[lx + pad, cy, lx + pad + swatch, cy]]), width)
        _marker(canvas, layer, np.array([[lx + pad + swatch / 2, cy]]), marker, size, fig.dpi)
        _text(canvas, canvas.layer(f, (0, 0, 0)), label, lx + 2 * pad + swatch, cy, "lm")


def _marker(canvas, layer, centres, marker, size, dpi):
    """Markers of size px at centres [n, 2] (a tensor or an array)."""
    if marker is None:
        return
    centres = torch.as_tensor(centres, dtype=torch.float64, device=canvas.device)
    if marker == "+":
        arm = size / 2
        hor = torch.cat([centres - torch.tensor([arm, 0.0], dtype=centres.dtype, device=centres.device),
                         centres + torch.tensor([arm, 0.0], dtype=centres.dtype, device=centres.device)], 1)
        ver = torch.cat([centres - torch.tensor([0.0, arm], dtype=centres.dtype, device=centres.device),
                         centres + torch.tensor([0.0, arm], dtype=centres.dtype, device=centres.device)], 1)
        canvas.segments(layer, torch.cat([hor, ver]), dpi / 72)
    elif marker == "*":
        canvas.stars(layer, centres, size / 2)
    else:  # 'o' and '.': filled dots
        canvas.segments(layer, torch.cat([centres, centres], 1), size if marker == "o" else size / 2)


def render(figures, device):
    """uint8 [F, H, W, 3] of the figures (all of one size) on device."""
    dev = torch.device(device)
    w, h = figures[0].size
    canvas = Canvas(len(figures), h, w, dev)
    batch = _Batch()
    mats, affs, per_fig = [], [], []
    for f, fig in enumerate(figures):
        if fig.size != (w, h):
            raise ValueError(f"figure {f} is {fig.size}, the batch's {(w, h)}")
        pts = [_points(c) for c in fig.calls]
        if fig.view3d is None:
            box, xlim, ylim, m, aff = _layout2d(fig, np.concatenate(pts) if pts else np.zeros((0, 3)))
            clip, corners = box, None
        else:
            box, m, aff = _layout3d(fig)
            xlim = ylim = clip = None
            corners = batch.add(_box_corners(*fig.view3d[:3]), f)  # projected with the data
        mats.append(m)
        affs.append(aff)
        entries, cycle = [], 0
        for call, p in zip(fig.calls, pts):
            color = call.color()
            if color is None:
                color, cycle = CYCLE[cycle % len(CYCLE)], cycle + 1
            rgb, alpha, lw, marker, ms = call.style(color)
            layer = canvas.layer(f, rgb, alpha, clip)
            first = batch.add(p, f)
            size = ms * fig.dpi / 72
            if lw is not None and len(p) > 1:  # matplotlib strokes no one-point line
                batch.lines.append((first, len(p), layer, lw * fig.dpi / 72))
            if marker is not None and len(p):
                batch.markers.append((first, len(p), layer, marker, size, fig.dpi))
            if "label" in call.kw:
                entries.append((call.kw["label"], rgb, alpha, None if lw is None else lw * fig.dpi / 72,
                                marker, size))
        per_fig.append((fig, box, xlim, ylim, aff, entries, pts, corners))

    # every data point of the batch through its frame's projection, at once
    if batch.n:
        points = torch.as_tensor(np.concatenate(batch.points), dtype=torch.float64, device=dev)
        frames = torch.as_tensor(np.concatenate(batch.frames), device=dev)
        px = transform.to_pixels(points, frames, torch.as_tensor(np.stack(mats), device=dev),
                                 torch.as_tensor(np.stack(affs), device=dev))
        seg_idx, seg_layer, seg_w = [], [], []
        for first, n, layer, width in batch.lines:
            seg_idx.append(np.stack([np.arange(first, first + n - 1), np.arange(first + 1, first + n)], 1))
            seg_layer.append(np.full(n - 1, layer))
            seg_w.append(np.full(n - 1, width))
        if seg_idx:
            idx = torch.as_tensor(np.concatenate(seg_idx), device=dev)
            canvas.segments(torch.as_tensor(np.concatenate(seg_layer), device=dev),
                            torch.cat([px[idx[:, 0]], px[idx[:, 1]]], 1), np.concatenate(seg_w))
        for first, n, layer, marker, size, dpi in batch.markers:
            _marker(canvas, layer, px[first:first + n], marker, size, dpi)
        boxes = [c for *_, c in per_fig if c is not None]
        if boxes:  # the 3D boxes' corners to the host in one copy
            rows = torch.as_tensor(np.add.outer(boxes, np.arange(8)).ravel(), device=dev)
            boxes = dict(zip(boxes, px[rows].cpu().numpy().reshape(len(boxes), 8, 2)))

    for f, (fig, box, xlim, ylim, aff, entries, pts, corners) in enumerate(per_fig):
        if fig.view3d is None:
            _decorate2d(canvas, f, fig, box, xlim, ylim, aff)
            occupied = np.concatenate(pts) if pts else np.zeros((0, 3))
            occupied = np.stack(transform.apply_affine(aff, occupied[:, 0], occupied[:, 1]), 1)
        else:
            _decorate3d(canvas, f, fig, boxes[corners])
            occupied = np.zeros((0, 2))
        _legend(canvas, f, fig, entries, box, occupied)
        if fig.title:
            _text(canvas, canvas.layer(f, (0, 0, 0)), fig.title, (box[0] + box[2]) / 2, box[1] - 10, "cb")
    return canvas.render()


def _decorate3d(canvas, f, fig, px):
    """The edges of the limits' box (grey; px the pixels of its corners)
    and the axis names at the middle of the three edges through the lowest
    corner."""
    layer = canvas.layer(f, GREY, 0.8)
    canvas.segments(layer, np.array([np.concatenate([px[i], px[j]]) for i, j in BOX_EDGES]), 0.8 * fig.dpi / 72)
    ink = canvas.layer(f, (0, 0, 0))
    for axis, label in enumerate((fig.xlabel, fig.ylabel, fig.zlabel)):
        if label:
            mid = (px[0] + px[1 << (2 - axis)]) / 2
            _text(canvas, ink, label, mid[0] - 12, mid[1] + 6, "ct")
