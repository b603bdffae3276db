"""Linear 1D/2D world models (Linear2DMeasurer.cs:43-, Linear1DMeasurer.cs):
the torch twin of monorfs_tpu.models.linear_models.

Pose state == Euclidean position; the sensor reports landmark offsets within
a box of half-width `range` (uniform norm). Landmark means stay 3-vectors
(padded with zeros), so the map representation is the same for every model
family."""

import dataclasses

import torch

from ..geometry import linear
from .base import Model, PoseOps


@dataclasses.dataclass(frozen=True)
class Params:
    range: float = 2.0

    def to_linear(self):
        return [self.range]

    @staticmethod
    def from_linear(vals):
        return Params(float(vals[0]))


def kernel_params(p: Params):
    """The range as csrc/model_policy.cuh's Linear reads it (the rest unused)."""
    return (p.range,) + (0.0,) * 7


def _pose_ops(dim):
    return PoseOps(
        state_dim=dim,
        odo_dim=dim,
        identity=lambda dtype=torch.float32, device=None: linear.identity(dim, dtype, device),
        add=linear.add,
        subtract=linear.subtract,
        add_global=linear.add,
        subtract_global=linear.subtract,
        add_odometry=linear.add_odometry,
        diff_odometry=linear.diff_odometry,
        add_jacobian=linear.add_jacobian,
        subtract_jacobian=linear.subtract_jacobian,
        add_odometry_jacobian=linear.add_odometry_jacobian,
    )


def _make(dim, name):
    def measure(p, pose, landmark):
        """z = landmark - pose, first `dim` coordinates
        (Linear2DMeasurer.cs:110-113)."""
        return landmark[..., :dim] - pose

    def jac_landmark(p, pose, landmark):
        """[dim x 3] selector (Linear2DMeasurer.cs:121-125)."""
        eye = torch.eye(dim, 3, dtype=pose.dtype, device=pose.device)
        return eye.expand(pose.shape[:-1] + (dim, 3))

    def jac_pose(p, pose, landmark):
        """-I: the pose enters the measurement with a minus sign."""
        eye = torch.eye(dim, dtype=pose.dtype, device=pose.device)
        return (-eye).expand(pose.shape[:-1] + (dim, dim))

    def to_map(p, pose, z):
        """Embed into 3D with zero padding (Linear2DMeasurer.cs:200-203)."""
        lm = pose + z
        pad = torch.zeros(lm.shape[:-1] + (3 - dim,), dtype=lm.dtype, device=lm.device)
        return torch.cat([lm, pad], dim=-1)

    def fit_to_measurement(p, pose0, z, landmark):
        """pose = landmark - z (Linear2DMeasurer.cs:146-149)."""
        return landmark[..., :dim] - z

    def visible(p, z):
        return torch.all((-p.range < z) & (z < p.range), dim=-1)

    def fuzzy_visible(p, z, ramp):
        d = torch.amin(
            torch.minimum((z + p.range) / ramp[:dim], (p.range - z) / ramp[:dim]), dim=-1
        )
        return torch.clamp(d, 0.0, 1.0)

    def random_measure(p, u):
        """Uniform clutter in the box from injected uniforms u [..., dim] in
        [0, 1): -range + u * 2 range."""
        return -p.range + u * (2.0 * p.range)

    def volume(p):
        return (2.0 * p.range) ** dim

    # structure-of-arrays (K-last) forms (see gm/smallmat.py)
    def measure_soa(p, pose, m):
        return [m[i] - pose[..., i : i + 1] for i in range(dim)]

    def jac_landmark_soa(p, pose, m):
        one, zero = torch.ones_like(m[0]), torch.zeros_like(m[0])
        return [[one if i == k else zero for k in range(3)] for i in range(dim)]

    def to_map_soa(p, pose, z):
        lm = [pose[..., i : i + 1] + z[i] for i in range(dim)]
        shape = torch.broadcast_shapes(*[v.shape for v in lm])
        lm = [v.expand(shape) for v in lm]
        return lm + [torch.zeros_like(lm[0])] * (3 - dim)

    def fuzzy_visible_soa(p, z, ramp):
        d = torch.minimum((z[0] + p.range) / ramp[0], (p.range - z[0]) / ramp[0])
        for i in range(1, dim):
            d = torch.minimum(d, (z[i] + p.range) / ramp[i])
            d = torch.minimum(d, (p.range - z[i]) / ramp[i])
        return torch.clamp(d, 0.0, 1.0)

    return Model(
        name=name,
        pose=_pose_ops(dim),
        meas_dim=dim,
        params=Params(),
        measure=measure,
        jac_landmark=jac_landmark,
        jac_pose=jac_pose,
        to_map=to_map,
        fit_to_measurement=fit_to_measurement,
        visible=visible,
        fuzzy_visible=fuzzy_visible,
        random_measure=random_measure,
        volume=volume,
        measure_soa=measure_soa,
        jac_landmark_soa=jac_landmark_soa,
        to_map_soa=to_map_soa,
        fuzzy_visible_soa=fuzzy_visible_soa,
        kernel_params=kernel_params,
    )


MODEL_2D = _make(2, "Linear2D")
MODEL_1D = _make(1, "Linear1D")
