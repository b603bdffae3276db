"""FAST keypoint detection as dense tensor ops: the torch twin of
monorfs_tpu.frontend.fast (reference: kpextractor/kpextractor.cpp:42-137,
OpenCV FAST with threshold 45 and non-maximum suppression).

The whole image is processed as 16 shifted planes with a contiguous-arc
test per pixel, non-maximum suppression is a 3x3 max comparison, and the
keypoints come out of one stable sort. torch.roll wraps around the image
edges as jnp.roll does; the detector's border margin keeps the wrapped
pixels out of the result."""

import numpy as np
import torch

# Bresenham circle of radius 3 (the standard FAST-16 ring), (dx, dy)
RING = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ]
)


def _shifted_ring(img):
    """[16, H, W] ring-neighbour intensities (wrapping at the edges)."""
    return torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1)) for dx, dy in RING])


def fast_score(img, threshold=45.0, arc=9):
    """FAST-N corner response: a pixel is a corner when `arc` contiguous
    ring pixels are all brighter than p + t or all darker than p - t. The
    [H, W] score is the sum over the ring of the threshold exceedances, 0
    for non-corners."""
    img = img.to(torch.float32)
    ring = _shifted_ring(img)
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def has_arc(mask):
        out = mask
        for k in range(1, arc):
            out = out & torch.roll(mask, -k, dims=0)
        return torch.any(out, dim=0)

    corner = has_arc(bright) | has_arc(dark)
    excess = torch.clamp(torch.abs(ring - img[None]) - threshold, min=0.0)
    score = torch.sum(excess, dim=0)
    return torch.where(corner, score, torch.zeros_like(score))


def nonmax_suppress(score):
    """3x3 non-maximum suppression."""
    neighborhood = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neighborhood = torch.maximum(neighborhood, torch.roll(score, (dy, dx), dims=(0, 1)))
    return torch.where(score >= neighborhood, score, torch.zeros_like(score))


def detect(img, threshold=45.0, max_keypoints=512, border=24):
    """Up to `max_keypoints` FAST corners, strongest first; equal scores in
    flat (row-major) index order, as the JAX package's stable argsort gives
    them. Returns (xy [K, 2] float32 (x, y), score [K], valid [K]); the
    `border` margin keeps descriptor windows in the image (latch.cpp:535)."""
    h, w = img.shape
    score = nonmax_suppress(fast_score(img, threshold))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(inb, score, torch.zeros_like(score))
    neg, idx = torch.sort(-score.reshape(-1), stable=True)
    top, idx = -neg[:max_keypoints], idx[:max_keypoints]
    xy = torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")], dim=-1).to(torch.float32)
    return xy, top, top > 0
