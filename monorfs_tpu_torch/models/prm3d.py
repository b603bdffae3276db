"""Pixel-range 3D camera model (PRM3DMeasurer.cs:43-511): the torch twin of
monorfs_tpu.models.prm3d.

z = (px, py, range) with px = f x_L / z_L, py = f y_L / z_L and
range = sign(z_L) |m - p|, (.)_L the camera-local frame. The SoA forms take
3-lists of [..., K] tensors and a pose [..., 7] that broadcasts against them
through a trailing singleton (pose [P, 7] with landmarks [P, K])."""

import dataclasses

import torch

from ..geometry import pose3d
from ..geometry import quaternion as quat
from ..gm import smallmat
from .base import Model, PoseOps


@dataclasses.dataclass(frozen=True)
class Params:
    """Camera intrinsics (PRM3DMeasurer.cs:70-73 defaults)."""

    focal: float = 575.8156
    film_left: float = -320.0
    film_top: float = -240.0
    film_width: float = 640.0
    film_height: float = 480.0
    range_min: float = 0.1
    range_max: float = 2.0

    @property
    def film_right(self):
        return self.film_left + self.film_width

    @property
    def film_bottom(self):
        return self.film_top + self.film_height

    def to_linear(self):
        """Descriptor layout (PRM3DMeasurer.cs:92-96)."""
        return [self.focal, self.range_min, self.range_max, self.film_left,
                self.film_top, self.film_width, self.film_height]

    @staticmethod
    def from_linear(vals):
        f, rmin, rmax, x, y, w, h = [float(v) for v in vals]
        return Params(f, x, y, w, h, rmin, rmax)


# -- array-of-structures forms (the simulated vehicle) ------------------------

def measure(p: Params, pose, landmark):
    """h(pose, m) (PRM3DMeasurer.cs:138-149); pose [..., 7], lm [..., 3]."""
    diff = landmark - pose3d.location(pose)
    local = quat.rotate(quat.conj(pose3d.orientation(pose)), diff)
    lz = local[..., 2]
    rng = torch.sign(lz) * torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.stack(
        [p.focal * local[..., 0] / lz, p.focal * local[..., 1] / lz, rng], dim=-1
    )


def _local(pose, landmark):
    """Landmark in the camera-local frame."""
    return quat.rotate(quat.conj(pose3d.orientation(pose)), landmark - pose3d.location(pose))


def _projection_jacobian(p: Params, local):
    """d(px, py, range)/d(local) (PRM3DMeasurer.cs:163-170)."""
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    one = torch.ones_like(lz)
    mag = torch.where(lz > 0, one, -one) * torch.sqrt(lx * lx + ly * ly + lz * lz)
    f, zero = p.focal, torch.zeros_like(lz)
    return torch.stack([
        torch.stack([f / lz, zero, -f * lx / (lz * lz)], dim=-1),
        torch.stack([zero, f / lz, -f * ly / (lz * lz)], dim=-1),
        torch.stack([lx / mag, ly / mag, lz / mag], dim=-1),
    ], dim=-2)


def jac_landmark(p: Params, pose, landmark):
    """dh/dm = J_proj C(q)^T (PRM3DMeasurer.cs:157-177) -> [..., 3, 3]."""
    jproj = _projection_jacobian(p, _local(pose, landmark))
    return jproj @ quat.to_matrix(quat.conj(pose3d.orientation(pose)))


def jac_pose(p: Params, pose, landmark):
    """dh/dpose in the semi-Lie `pose3d.add` tangent (body-frame translation,
    right-multiplied rotation): J = J_proj [-I | [local]_x] -> [..., 3, 6]."""
    local = _local(pose, landmark)
    jproj = _projection_jacobian(p, local)
    eye = torch.eye(3, dtype=local.dtype, device=local.device).expand(jproj.shape)
    return jproj @ torch.cat([-eye, pose3d.cross_matrix(local)], dim=-1)


def to_map(p: Params, pose, z):
    """Back-projection into 3D space (PRM3DMeasurer.cs:299-312)."""
    px, py, rng = z[..., 0], z[..., 1], z[..., 2]
    alpha = rng / torch.sqrt(p.focal * p.focal + px * px + py * py)
    diff = torch.stack([alpha * px, alpha * py, alpha * p.focal], dim=-1)
    return pose3d.location(pose) + quat.rotate(pose3d.orientation(pose), diff)


def _fuzzy(p: Params, px, py, rng, ramp):
    d = torch.minimum((px - p.film_left) / ramp[0], (p.film_right - px) / ramp[0])
    d = torch.minimum(d, (py - p.film_top) / ramp[1])
    d = torch.minimum(d, (p.film_bottom - py) / ramp[1])
    d = torch.minimum(d, (rng - p.range_min) / ramp[2])
    d = torch.minimum(d, (p.range_max - rng) / ramp[2])
    return torch.clamp(d, 0.0, 1.0)


def fuzzy_visible(p: Params, z, ramp):
    """Linear visibility ramp near the frustum border
    (PRM3DMeasurer.cs:277-291)."""
    return _fuzzy(p, z[..., 0], z[..., 1], z[..., 2], ramp)


def visible(p: Params, z):
    """Frustum visibility (PRM3DMeasurer.cs:264-269)."""
    px, py, rng = z[..., 0], z[..., 1], z[..., 2]
    return (
        (p.film_left < px) & (px < p.film_right)
        & (p.film_top < py) & (py < p.film_bottom)
        & (p.range_min < rng) & (rng < p.range_max)
    )


def random_measure(p: Params, u):
    """Uniform clutter in the visible frustum (PRM3DMeasurer.cs:249-256)
    from injected uniforms u [..., 3] in [0, 1): lo + u * span."""
    lo = (p.film_left, p.film_top, p.range_min)
    span = (p.film_width, p.film_height, p.range_max - p.range_min)
    return torch.stack([lo[i] + u[..., i] * span[i] for i in range(3)], dim=-1)


def volume(p: Params):
    """Measurement-space volume (PRM3DMeasurer.cs:119-122)."""
    return p.film_width * p.film_height * (p.range_max - p.range_min)


# -- structure-of-arrays (K-last) forms (the PHD step) -------------------------

def _pose_lists(pose):
    """(location 3-list, quaternion 4-list) of [..., 1] tensors."""
    loc = [pose[..., i : i + 1] for i in range(3)]
    q = [pose[..., 3 + i : 4 + i] for i in range(4)]
    return loc, q


def _quat_mat(q):
    """R(q) as a smallmat 3x3 list."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    return [
        [1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)],
    ]


def _local_soa(pose, m):
    loc, q = _pose_lists(pose)
    d = [mi - li for mi, li in zip(m, loc)]
    r = _quat_mat(q)
    local = smallmat.matvec(smallmat.transpose(r), d)
    return local, d, r


def measure_soa(p: Params, pose, m):
    local, d, _ = _local_soa(pose, m)
    lx, ly, lz = local
    rng = torch.sign(lz) * torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return [p.focal * lx / lz, p.focal * ly / lz, rng]


def jac_landmark_soa(p: Params, pose, m):
    """dh/dm = J_proj R(q)^T (PRM3DMeasurer.cs:157-177)."""
    local, _, r = _local_soa(pose, m)
    lx, ly, lz = local
    one = torch.ones_like(lz)
    sign = torch.where(lz > 0, one, -one)
    mag = sign * torch.sqrt(lx * lx + ly * ly + lz * lz)
    f = p.focal
    zero = torch.zeros_like(lz)
    jproj = [
        [f / lz, zero, -f * lx / (lz * lz)],
        [zero, f / lz, -f * ly / (lz * lz)],
        [lx / mag, ly / mag, lz / mag],
    ]
    return smallmat.matmul(jproj, smallmat.transpose(r))


def to_map_soa(p: Params, pose, z):
    """Back-projection into 3D space (PRM3DMeasurer.cs:299-312)."""
    px, py, rng = z
    alpha = rng / torch.sqrt(p.focal * p.focal + px * px + py * py)
    diff = [alpha * px, alpha * py, alpha * p.focal]
    loc, q = _pose_lists(pose)
    rotated = smallmat.matvec(_quat_mat(q), diff)
    return [li + vi for li, vi in zip(loc, rotated)]


def fuzzy_visible_soa(p: Params, z, ramp):
    return _fuzzy(p, z[0], z[1], z[2], ramp)


POSE_OPS = PoseOps(
    state_dim=7,
    odo_dim=6,
    identity=pose3d.identity,
    add=pose3d.add,
    subtract=pose3d.subtract,
    add_global=pose3d.add_global,
    subtract_global=pose3d.subtract_global,
    add_odometry=pose3d.add_odometry,
    diff_odometry=pose3d.diff_odometry,
    add_jacobian=pose3d.add_jacobian,
    subtract_jacobian=pose3d.subtract_jacobian,
    add_odometry_jacobian=pose3d.add_odometry_jacobian,
)

MODEL = Model(
    name="PRM3D",
    pose=POSE_OPS,
    meas_dim=3,
    params=Params(),
    measure=measure,
    jac_landmark=jac_landmark,
    jac_pose=jac_pose,
    to_map=to_map,
    fuzzy_visible=fuzzy_visible,
    visible=visible,
    random_measure=random_measure,
    volume=volume,
    measure_soa=measure_soa,
    jac_landmark_soa=jac_landmark_soa,
    to_map_soa=to_map_soa,
    fuzzy_visible_soa=fuzzy_visible_soa,
)
