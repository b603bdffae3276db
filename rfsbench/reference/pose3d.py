"""Batched 3D pose algebra on 7-state tensors (x, y, z, qw, qx, qy, qz) and
6-vector odometry/tangents (Pose3D.cs:38-528): the torch twin of
monorfs_tpu.geometry.pose3d, same semi-Lie conventions.

  add / subtract:           body-frame translation, Lie rotation
  add_global / subtract_global: world-frame translation
  add_odometry / diff_odometry: midpoint-rotation composition and inverse
"""

import torch

from . import quaternion as quat

STATE_DIM = 7
ODO_DIM = 6


def identity(dtype=torch.float32, device=None):
    return torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=dtype, device=device)


def location(state):
    return state[..., 0:3]


def orientation(state):
    return state[..., 3:7]


def make(loc, q):
    shape = torch.broadcast_shapes(loc.shape[:-1], q.shape[:-1])
    return torch.cat(
        [loc.expand(shape + (3,)), q.expand(shape + (4,))], dim=-1
    )


def normalize(state):
    """Renormalize the quaternion part."""
    return make(location(state), quat.normalize(orientation(state)))


def add(state, delta):
    """Semi-Lie (+) of a 6-tangent (Pose3D.cs:282-291)."""
    q = orientation(state)
    newq = quat.normalize(quat.add(q, delta[..., 3:6]))
    return make(location(state) + quat.rotate(q, delta[..., 0:3]), newq)


def subtract(state, origin):
    """Semi-Lie (-): tangent taking `origin` to `state` (Pose3D.cs:297-308)."""
    qo = orientation(origin)
    dx = quat.rotate(quat.conj(qo), location(state) - location(origin))
    lie = quat.sub(orientation(state), qo)
    dx, lie = torch.broadcast_tensors(dx, lie)
    return torch.cat([dx, lie], dim=-1)


def add_global(state, delta):
    """World-frame translation, right-multiplied rotation (Pose3D.cs:257-263)."""
    q = orientation(state)
    newq = quat.normalize(quat.add(q, delta[..., 3:6]))
    return make(location(state) + delta[..., 0:3], newq)


def subtract_global(state, origin):
    """World-frame translation difference, Lie rotation difference
    (Pose3D.cs:270-276)."""
    dq = quat.sub(orientation(state), orientation(origin))
    dx = location(state) - location(origin)
    dx, dq = torch.broadcast_tensors(dx, dq)
    return torch.cat([dx, dq], dim=-1)


def add_odometry(state, delta):
    """Body-frame odometry with midpoint rotation (Pose3D.cs:314-333)."""
    q = orientation(state)
    dq = quat.exp(0.5 * delta[..., 3:6])
    newq = quat.normalize(quat.mul(q, dq))
    mid = quat.mul(q, quat.sqrt(dq))
    return make(location(state) + quat.rotate(mid, delta[..., 0:3]), newq)


def diff_odometry(state, origin):
    """Odometry delta taking `origin` to `state` (Pose3D.cs:339-359)."""
    qo = orientation(origin)
    dq = quat.mul(quat.conj(qo), orientation(state))
    mid = quat.mul(qo, quat.sqrt(dq))
    dx = quat.rotate(quat.conj(mid), location(state) - location(origin))
    lie = 2.0 * quat.log(dq)
    dx, lie = torch.broadcast_tensors(dx, lie)
    return torch.cat([dx, lie], dim=-1)


def _eye3(like):
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-1] + (3, 3))


def _zeros3(like):
    return torch.zeros(like.shape[:-1] + (3, 3), dtype=like.dtype, device=like.device)


def _block(a, b, c, d):
    top = torch.cat([a, b], dim=-1)
    bot = torch.cat([c, d], dim=-1)
    return torch.cat([top, bot], dim=-2)


def add_jacobian(state, delta):
    """d add(state, d)/dd: [[C_rot, 0], [0, I]] (Pose3D.cs:366-377)."""
    crot = quat.to_matrix(orientation(state))
    return _block(crot, _zeros3(state), _zeros3(state), _eye3(state))


def subtract_jacobian(state, origin):
    """d subtract(state, origin)/dstate: [[C_o^T, 0], [0, I]]
    (Pose3D.cs:384-395)."""
    crot_t = quat.to_matrix(orientation(origin)).transpose(-1, -2)
    return _block(crot_t, _zeros3(state), _zeros3(state), _eye3(state))


def cross_matrix(v):
    """[v]_x, [..., 3] -> [..., 3, 3] (Util.cs:107-118)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def add_odometry_jacobian(state, delta):
    """Linearization F of add_odometry around this pose (Pose3D.cs:404-423)."""
    dq = quat.add(quat.identity(state.dtype, state.device), delta[..., 3:6])
    sq = quat.sqrt(dq)
    cmid = quat.to_matrix(quat.mul(orientation(state), sq))
    cdelta = quat.to_matrix(dq)
    csqrt = quat.to_matrix(sq)
    crossdx = cross_matrix(delta[..., 0:3])
    dxdq = -torch.einsum("...ij,...jk,...lk->...il", cmid, crossdx, csqrt)
    return _block(_eye3(state), dxdq, _zeros3(state), cdelta.transpose(-1, -2))
