"""Binary patch-triplet descriptors (LATCH), batched over keypoints: the
torch twin of monorfs_tpu.frontend.latch (reference:
kpextractor/external/latch.cpp:96-320, 32-byte LATCH after a 3x3 sigma=2
Gaussian blur, latch.cpp:527-528).

Bit j compares the SSDs of two companion 7x7 patches against a shared anchor
patch B: bit = SSD(A, B) < SSD(C, B), the patches at the learned offsets of
latch_table.py (its first 256 triplets), packed MSB-first per byte as
pixelTests32 does. FAST keypoints carry no orientation, so the upright path
matches the reference's effective behaviour.

The arithmetic follows the JAX function's order: blur rows then columns,
squared differences summed over the 49 patch pixels, in float32. A bit
whose two SSDs tie within rounding may come out either way: the sums run in
another order than XLA's (and the JAX function blurs in float64 when JAX's
x64 mode is on). In float32 such ties mostly round to equal sums, bit 0, as
they do in the JAX function's float64 sums of exactly tied patches."""

import functools

import numpy as np
import torch

from .latch_table import SAMPLING_POINTS

DESCRIPTOR_BITS = 256
HALF_SSD = 3  # half_ssd_size (7x7 patches), latch.cpp:59

# [256, 3, 2] (x, y) offsets per bit, ordered (A, B = anchor, C)
TRIPLETS = np.asarray(SAMPLING_POINTS[:DESCRIPTOR_BITS], np.int64).reshape(DESCRIPTOR_BITS, 3, 2)

# 7x7 patch offsets (dy, dx)
_PATCH = np.asarray(
    [(dy, dx) for dy in range(-HALF_SSD, HALF_SSD + 1) for dx in range(-HALF_SSD, HALF_SSD + 1)]
)


@functools.cache
def _constants(device):
    """(triplet offsets [1, 256, 3, 2], patch offsets [49, 2], byte weights
    [8]) on the device, uploaded once."""
    return (torch.as_tensor(TRIPLETS, device=device)[None], torch.as_tensor(_PATCH, device=device),
            torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=device))


def blur3(img, sigma=2.0):
    """3x3 Gaussian pre-blur (latch.cpp:527-528), rows then columns; the
    weights are Python floats, rounded to float32 in the products."""
    ax = np.array([-1.0, 0.0, 1.0])
    k1 = np.exp(-(ax**2) / (2 * sigma * sigma))
    k1 /= k1.sum()
    k = [float(v) for v in k1]
    img = img.to(torch.float32)
    img = torch.roll(img, 1, dims=0) * k[0] + img * k[1] + torch.roll(img, -1, dims=0) * k[2]
    return torch.roll(img, 1, dims=1) * k[0] + img * k[1] + torch.roll(img, -1, dims=1) * k[2]


def ssd_pairs(img, xy):
    """(ssd_a, ssd_c) [K, 256]: each bit's two patch SSDs against its anchor,
    positions clamped to the image."""
    img = blur3(img)
    h, w = img.shape
    kx = xy[:, 0].to(torch.int32).long()
    ky = xy[:, 1].to(torch.int32).long()
    centers, patch, _ = _constants(img.device)  # centers (x, y), patch (dy, dx)
    pos_y = ky[:, None, None, None] + centers[..., 1][..., None] + patch[:, 0]
    pos_x = kx[:, None, None, None] + centers[..., 0][..., None] + patch[:, 1]
    patches = img[torch.clamp(pos_y, 0, h - 1), torch.clamp(pos_x, 0, w - 1)]  # [K, 256, 3, 49]
    pa, anchor, pc = patches[:, :, 0, :], patches[:, :, 1, :], patches[:, :, 2, :]
    return torch.sum((pa - anchor) ** 2, dim=-1), torch.sum((pc - anchor) ** 2, dim=-1)


def describe(img, xy, valid):
    """[K, 32] uint8 descriptors at the keypoints xy [K, 2] (x, y); rows of
    invalid keypoints are 0."""
    ssd_a, ssd_c = ssd_pairs(img, xy)
    bits = (ssd_a < ssd_c).to(torch.int32).reshape(-1, 32, 8)
    desc = torch.sum(bits * _constants(img.device)[2], dim=-1).to(torch.uint8)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))
