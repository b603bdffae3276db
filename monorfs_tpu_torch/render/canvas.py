"""A batched RGB canvas [F, H, W, 3] on an explicit device: the port's
rasterizer, standing where matplotlib's Agg backend stands for the JAX
viewers.

What is drawn is a list of layers in draw order, one for each matplotlib
call it stands for (a `plot` line, a set of markers, a text, a legend's
box), each with one colour, one alpha, a clip box and the frame of the
batch it belongs to. Three primitives fill a layer:
  - segments with a width in pixels, anti-aliased by the distance from a
    pixel's centre to the segment: coverage min(1, max(0, w / 2 + 0.5 - d));
    a dot is a segment of length 0 (scatter's filled circle, width = its
    diameter);
  - filled five-pointed stars (matplotlib's '*' marker: outer radius r,
    inner radius 0.381966 r, a point up), anti-aliased by the signed
    distance to their outline;
  - explicit pixels of coverage 1 (the bitmap font, rectangle fills).
`render` rasterizes every layer of every frame in one pass over the batch:
each primitive proposes the pixels of a window around it, a layer's
coverage of a pixel is the largest any of its primitives gives
(`scatter_reduce(..., "amax")`, which does not depend on the order of the
proposals), and the layers are then blended over the background in draw
order, a later layer on top, with colour * alpha * coverage. The blend walks
each pixel's layers by rank (first, second, ... layer on that pixel), so
each step writes every pixel at most once. Nothing accumulates floats in a
data-dependent order (no float index_add_, no atomics), so a render repeats
bit for bit on the card.
"""

import math

import numpy as np
import torch

PIECE = 8.0  # segments are cut into pieces of at most this many pixels
CHUNK = 1 << 23  # candidate pixels per rasterizing step (bounds the memory)
STAR_INNER = 0.381966  # matplotlib's Path.unit_regular_star(5) inner radius


class Canvas:
    """Layers of a batch of `frames` white RGB frames of height x width,
    drawn by `render` on `device`."""

    def __init__(self, frames, height, width, device):
        self.frames, self.height, self.width = frames, height, width
        self.device = torch.device(device)
        self._layers = []  # (frame, r, g, b, alpha, clip x0, y0, x1, y1)
        self._segments = []  # (segs [n, 4] px, width [n] px, layer [n])
        self._stars = []  # (centres [n, 2] px, outer radius [n] px, layer [n])
        self._pixels = []  # (rows, cols, layer): numpy

    def layer(self, frame, color, alpha=1.0, clip=None):
        """A new layer on top of the frame's others; returns its id."""
        clip = clip if clip is not None else (0, 0, self.width, self.height)
        self._layers.append((frame, *map(float, color[:3]), float(alpha), *map(float, clip)))
        return len(self._layers) - 1

    def _tensor(self, x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def segments(self, layer, segs, width):
        """Segments [n, 4] (x0, y0, x1, y1 in pixels) of one layer id or of
        a layer id each, width in pixels (one, or one each)."""
        segs = self._tensor(segs).reshape(-1, 4)
        n = segs.shape[0]
        self._segments.append((segs, self._tensor(width).expand(n),
                               self._tensor(layer, torch.int64).expand(n)))

    def stars(self, layer, centres, radius):
        """Filled five-pointed stars at centres [n, 2], outer radius px."""
        c = self._tensor(centres).reshape(-1, 2)
        n = c.shape[0]
        self._stars.append((c, self._tensor(radius).expand(n), self._tensor(layer, torch.int64).expand(n)))

    def pixels(self, layer, rows, cols):
        """Explicit pixels (coverage 1) of one layer."""
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        self._pixels.append((rows, cols, np.full(rows.shape, layer, np.int64)))

    def rect(self, layer, x0, y0, x1, y1):
        """Fill the pixels whose centres lie in [x0, x1) x [y0, y1)."""
        cols = np.arange(math.ceil(x0 - 0.5), math.ceil(x1 - 0.5))
        rows = np.arange(math.ceil(y0 - 0.5), math.ceil(y1 - 0.5))
        r, c = np.meshgrid(rows, cols, indexing="ij")
        self.pixels(layer, r.ravel(), c.ravel())

    # ---- rasterizing -------------------------------------------------------

    def _segment_candidates(self, clip):
        segs = torch.cat([s for s, _, _ in self._segments])
        width = torch.cat([w for _, w, _ in self._segments])
        layer = torch.cat([ly for _, _, ly in self._segments])
        length = torch.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
        k = torch.clamp(torch.ceil(length / PIECE), min=1).to(torch.int64)
        src = torch.repeat_interleave(torch.arange(len(k), device=self.device), k)
        j = torch.arange(len(src), device=self.device) - torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
        kf = k[src].to(segs.dtype)
        t0, t1 = (j / kf)[:, None], ((j + 1) / kf)[:, None]
        s = segs[src]
        a, b = s[:, :2] + t0 * (s[:, 2:] - s[:, :2]), s[:, :2] + t1 * (s[:, 2:] - s[:, :2])
        r = width[src] / 2 + 0.5
        size = int(math.ceil(PIECE + 2 * float(r.max()) + 2))
        origin = torch.floor(torch.minimum(a, b) - r[:, None])
        seg_dir, seg_len2 = b - a, ((b - a) ** 2).sum(1)

        def cover(sl, centre):
            rel = centre - a[sl, None, :]
            t = (rel * seg_dir[sl, None, :]).sum(-1) / seg_len2[sl, None].clamp(min=1e-30)
            t = torch.where(seg_len2[sl, None] > 0, t.clamp(0, 1), torch.zeros_like(t))
            d = torch.linalg.vector_norm(rel - t[..., None] * seg_dir[sl, None, :], dim=-1)
            return torch.clamp(r[sl, None] - d, 0, 1)

        yield from self._windows(origin, size, layer[src], cover, clip)

    def _star_candidates(self, clip):
        c = torch.cat([s for s, _, _ in self._stars])
        radius = torch.cat([r for _, r, _ in self._stars])
        layer = torch.cat([ly for _, _, ly in self._stars])
        theta = torch.arange(11, device=self.device, dtype=c.dtype) * (math.pi / 5) + math.pi / 2
        rad = torch.ones(11, device=self.device, dtype=c.dtype)
        rad[1::2] = STAR_INNER
        unit = torch.stack([rad * torch.cos(theta), -rad * torch.sin(theta)], dim=1)  # y down
        verts = c[:, None, :] + radius[:, None, None] * unit[None]  # [n, 11, 2], closed
        size = int(math.ceil(2 * float(radius.max()) + 3))
        origin = torch.floor(c - radius[:, None] - 1)

        def cover(sl, centre):
            p0, p1 = verts[sl, None, :-1, :], verts[sl, None, 1:, :]  # [n, 1, 10, 2]
            q = centre[:, :, None, :]
            e = p1 - p0
            t = (((q - p0) * e).sum(-1) / (e * e).sum(-1)).clamp(0, 1)
            d = torch.linalg.vector_norm(q - p0 - t[..., None] * e, dim=-1).amin(-1)
            crosses = ((p0[..., 1] > q[..., 1]) != (p1[..., 1] > q[..., 1])) & (
                q[..., 0] < p0[..., 0] + (q[..., 1] - p0[..., 1]) * e[..., 0] / (e[..., 1] + (e[..., 1] == 0)))
            inside = crosses.sum(-1) % 2 == 1
            return torch.clamp(0.5 + torch.where(inside, d, -d), 0, 1)

        yield from self._windows(origin, size, layer, cover, clip)

    def _windows(self, origin, size, layer, cover, clip):
        """(layer, pixel, coverage) of the size x size pixel window at each
        origin, in chunks of at most CHUNK candidates."""
        off = torch.arange(size, device=self.device)
        oy, ox = torch.meshgrid(off, off, indexing="ij")
        oy, ox = oy.reshape(-1), ox.reshape(-1)
        step = max(1, CHUNK // (size * size))
        for s0 in range(0, origin.shape[0], step):
            sl = slice(s0, s0 + step)
            x = origin[sl, None, 0].to(torch.int64) + ox[None, :]
            y = origin[sl, None, 1].to(torch.int64) + oy[None, :]
            centre = torch.stack([x + 0.5, y + 0.5], dim=-1).to(origin.dtype)
            cov = cover(sl, centre)
            box = clip[layer[sl]][:, None, :]  # each primitive's layer's clip box
            keep = (cov > 0) & (x >= box[..., 0]) & (x < box[..., 2]) & (y >= box[..., 1]) & (y < box[..., 3])
            yield layer[sl, None].expand_as(x)[keep], y[keep] * self.width + x[keep], cov[keep]

    def render(self):
        """uint8 [F, H, W, 3] on the canvas's device."""
        f, h, w = self.frames, self.height, self.width
        hw = h * w
        image = torch.ones((f * hw, 3), dtype=torch.float32, device=self.device)
        if not self._layers:
            return self._to_uint8(image)
        style = self._tensor([ly[1:5] for ly in self._layers], torch.float32)
        frame_of = self._tensor([ly[0] for ly in self._layers], torch.int64)
        clip = self._tensor([[max(ly[5], 0), max(ly[6], 0), min(ly[7], w), min(ly[8], h)]
                             for ly in self._layers], torch.float64)
        parts = []
        if self._segments:
            parts += list(self._segment_candidates(clip))
        if self._stars:
            parts += list(self._star_candidates(clip))
        for rows, cols, ly in self._pixels:
            ly_t, r, c = (self._tensor(v, torch.int64) for v in (ly, rows, cols))
            box = clip[ly_t]
            keep = (c >= box[:, 0]) & (c < box[:, 2]) & (r >= box[:, 1]) & (r < box[:, 3])
            parts.append((ly_t[keep], r[keep] * w + c[keep],
                          torch.ones(int(keep.sum()), dtype=torch.float64, device=self.device)))
        if not parts:
            return self._to_uint8(image)
        layer = torch.cat([p[0] for p in parts])
        pix = torch.cat([p[1] for p in parts])
        cov = torch.cat([p[2] for p in parts]).to(torch.float32)
        # one coverage per (layer, pixel): the largest proposed
        key, inverse = torch.unique(layer * hw + pix, return_inverse=True)
        cov = torch.zeros(len(key), dtype=torch.float32, device=self.device).scatter_reduce(
            0, inverse, cov, "amax", include_self=True)
        layer, pix = key // hw, key % hw
        gpix = frame_of[layer] * hw + pix
        # each pixel's layers in draw order, then blended rank by rank
        order = torch.argsort(gpix * len(self._layers) + layer)
        gpix, layer, cov = gpix[order], layer[order], cov[order]
        _, counts = torch.unique_consecutive(gpix, return_counts=True)
        starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        rank = torch.arange(len(gpix), device=self.device) - starts
        order = torch.sort(rank, stable=True).indices
        gpix, layer, cov = gpix[order], layer[order], cov[order]
        s0 = 0
        for n in torch.bincount(rank).tolist():
            sl = slice(s0, s0 + n)
            s0 += n
            a = (style[layer[sl], 3] * cov[sl])[:, None]
            idx = gpix[sl]
            image[idx] = image[idx] * (1 - a) + style[layer[sl], :3] * a
        return self._to_uint8(image)

    def _to_uint8(self, image):
        out = torch.clamp(torch.floor(image * 255 + 0.5), 0, 255).to(torch.uint8)
        return out.reshape(self.frames, self.height, self.width, 3)
