"""Depth-occlusion-aware pixel-range camera (KinectMeasurer.cs:43-176): the
torch twin of monorfs_tpu.models.kinect_model.

The geometry is PRM3D's; visibility also requires the landmark to lie in
front of the live depth map (range <= depth at its pixel, with a fuzzy ramp
against the depth, :123-175). The depth map is a per-frame argument
(PHDParams.depth_map), re-bound by the simulation every frame; it is
row-major [y, x] where the reference indexes [x][y]."""

import dataclasses

import torch

from . import prm3d
from .base import Model


@dataclasses.dataclass(frozen=True)
class Params(prm3d.Params):
    """PRM3D intrinsics plus the sensor's resolution and keypoint border
    (KinectMeasurer.cs:44-63)."""

    res_x: float = 640.0
    res_y: float = 480.0
    border: int = 24

    def to_linear(self):
        return super().to_linear() + [self.res_x, self.res_y, self.border]

    @staticmethod
    def from_linear(vals):
        base = prm3d.Params.from_linear(vals[:7])
        if len(vals) >= 10:
            return Params(**dataclasses.asdict(base), res_x=float(vals[7]),
                          res_y=float(vals[8]), border=int(vals[9]))
        return Params(**dataclasses.asdict(base))


def _depth_at_xy(p: Params, px, py, depth):
    """The depth map at the pixel of (px, py): truncated to int32, then
    clipped to the image (KinectMeasurer.cs:126)."""
    h, w = depth.shape
    x = torch.clamp((px + p.res_x / 2).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((py + p.res_y / 2).to(torch.int32), 0, h - 1).long()
    return depth[y, x]


def _depth_at(p: Params, z, depth):
    return _depth_at_xy(p, z[..., 0], z[..., 1], depth)


def _depth_at_soa(p: Params, z, depth):
    return _depth_at_xy(p, z[0], z[1], depth)


def visible(p: Params, z, depth):
    """In the frustum and in front of the depth map (KinectMeasurer.cs:123-145)."""
    return prm3d.visible(p, z) & (z[..., 2] <= _depth_at(p, z, depth))


def _ramp_depth(p: Params, base, rng, d, ramp):
    """The fuzzy base visibility further ramped against the depth map
    (KinectMeasurer.cs:151-175); a NaN depth hides the landmark."""
    v = torch.minimum(base, (rng - p.range_min) / ramp[2])
    v = torch.minimum(v, (d - rng) / ramp[2])
    v = torch.where(torch.isnan(d), torch.zeros_like(v), v)
    return torch.where(base <= 0, torch.zeros_like(v), torch.clamp(v, 0.0, 1.0))


def fuzzy_visible(p: Params, z, ramp, depth):
    return _ramp_depth(p, prm3d.fuzzy_visible(p, z, ramp), z[..., 2], _depth_at(p, z, depth), ramp)


def fuzzy_visible_soa(p: Params, z, ramp, depth):
    """SoA twin of fuzzy_visible (z a 3-list of [..., K] tensors)."""
    return _ramp_depth(p, prm3d.fuzzy_visible_soa(p, z, ramp), z[2], _depth_at_soa(p, z, depth), ramp)


MODEL = Model(
    name="Kinect",
    pose=prm3d.POSE_OPS,
    meas_dim=3,
    params=Params(),
    measure=prm3d.measure,
    jac_landmark=prm3d.jac_landmark,
    jac_pose=prm3d.jac_pose,
    to_map=prm3d.to_map,
    fit_to_measurement=prm3d.fit_to_measurement,
    fuzzy_visible=fuzzy_visible,
    visible=visible,
    random_measure=prm3d.random_measure,
    volume=prm3d.volume,
    measure_soa=prm3d.measure_soa,
    jac_landmark_soa=prm3d.jac_landmark_soa,
    to_map_soa=prm3d.to_map_soa,
    fuzzy_visible_soa=fuzzy_visible_soa,
    uses_depth=True,
)
