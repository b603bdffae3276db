"""RGB-D sensor source: the keypoint pipeline over recorded depth / gray
streams, the torch twin of monorfs_tpu.frontend.kinect (reference:
KinectVehicle.cs:52-941).

Per frame the depth and gray images are delta-subsampled by box averaging
on the host (:396-484), uploaded, and keypoints are extracted on the device
(FAST + LATCH, fast.py and latch.py), temporally filtered by descriptor
matching + RANSAC homography (:503-576), and keypoints with valid depth
become pixel-range measurements (px - cx, py - cy, range) with
range = depth * |(px / f, py / f, 1)| (GetRange, :730-742). The last step
is a host loop over the accepted keypoints, after one device-to-host read a
frame (counted in `reads`)."""

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..models.prm3d import Params as CameraParams
from . import fast, latch, matching


class FrameFeatures(NamedTuple):
    xy: torch.Tensor  # [K, 2] pixel coordinates in the subsampled image
    desc: torch.Tensor  # [K, 32] uint8
    valid: torch.Tensor  # [K]


def make_extractor(threshold=45.0, max_keypoints=256, border=24):
    """Single-frame extraction: gray [H, W] tensor -> FrameFeatures."""

    def extract(gray):
        xy, _, valid = fast.detect(gray, threshold=threshold, max_keypoints=max_keypoints, border=border)
        return FrameFeatures(xy=xy, desc=latch.describe(gray, xy, valid), valid=valid)

    return extract


def subsample(img, delta):
    """delta x delta box average of a NumPy image (KinectVehicle.cs:396-484)."""
    h, w = img.shape
    h2, w2 = h // delta, w // delta
    return img[: h2 * delta, : w2 * delta].reshape(h2, delta, w2, delta).mean(axis=(1, 3))


def upload(array, device, dtype=None):
    """A NumPy array on the device; a CUDA copy goes from pinned memory
    without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class KinectSource:
    """Measurement source over a converted RGB-D dataset, the simulation's
    vehicle in a Kinect run (the true pose is unknown, odometry comes from
    the commands, measurements from vision).

    draw: RANSAC's sampler, draw(mask [K] bool, iterations) -> [iterations, 4]
    rows (matching.uniform_draws over a torch.Generator seeded with `seed` on
    the device by default)."""

    def __init__(self, dataset, camera: CameraParams = None, delta=4, max_keypoints=256,
                 keypoint_filter=True, threshold=45.0, seed=0, device="cuda", draw=None):
        self.dataset = dataset
        self.delta = delta
        self.camera = camera or CameraParams()
        self.keypoint_filter = keypoint_filter
        self.device = resolve_device(device)
        self.extract = make_extractor(threshold=threshold, max_keypoints=max_keypoints)
        self.prev: FrameFeatures = None
        if draw is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            draw = matching.uniform_draws(gen)
        self.draw = draw
        # scaled intrinsics for the subsampled image
        self.focal = self.camera.focal / delta
        self.reads = 0  # device-to-host reads

    def measure(self, i):
        """Measurements of frame i, [M, 3] (px, py, range) float64, and the
        subsampled depth map [H, W] (NumPy) for occlusion."""
        _, depth, gray = self.dataset.frame(i)
        gray_s = subsample(gray.astype(np.float32), self.delta)
        depth_s = subsample(depth, self.delta)

        with record_function("kinect.frontend"):
            feats = self.extract(upload(gray_s, self.device))
            valid = feats.valid
            if self.keypoint_filter and self.prev is not None:
                valid = matching.temporal_filter(
                    feats.xy, feats.desc, feats.valid, self.prev.xy, self.prev.desc, self.prev.valid,
                    self.draw,
                )
        self.prev = feats

        host = torch.cat([feats.xy, valid[:, None].to(feats.xy.dtype)], dim=1).cpu().numpy()
        self.reads += 1
        xy, val = host[:, :2], host[:, 2] > 0
        h, w = gray_s.shape
        out = []
        for k in np.nonzero(val)[0]:
            x, y = int(xy[k, 0]), int(xy[k, 1])
            z = float(depth_s[y, x])
            if z <= 0:
                continue  # keypoints need valid depth (KinectVehicle.cs:555-575)
            px = x - w / 2.0
            py = y - h / 2.0
            rng = z * float(np.sqrt(px * px + py * py + self.focal**2) / self.focal)
            out.append((px, py, rng))
        return np.asarray(out, np.float64).reshape(-1, 3), depth_s
