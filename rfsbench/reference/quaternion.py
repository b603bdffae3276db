"""Batched quaternion algebra on (w, x, y, z) tensors [..., 4]
(Quaternion.cs:38-411): the torch twin of monorfs_tpu.geometry.quaternion.

exp(v) = [cos|v|, sin|v| v/|v|]; log(q) = phi unit(vec) via atan2;
add(q, v) = q exp(v/2); sub(a, b) = 2 log(b* a); sqrt is the positive
half-rotation."""

import torch

_EPS = 1e-12


def identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def mul(a, b):
    """Hamilton product a*b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
        ],
        dim=-1,
    )


def conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def normalize(q):
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=_EPS))
    return q * torch.where(n2 > 0, inv, torch.ones_like(inv))


def exp(v):
    """Quaternion exponential of a vector [..., 3] -> [..., 4]."""
    phi2 = torch.sum(v * v, dim=-1, keepdim=True)
    phi = torch.sqrt(torch.clamp(phi2, min=_EPS * _EPS))
    small = phi2 < _EPS * _EPS
    sinc = torch.where(small, 1.0 - phi2 / 6.0, torch.sin(phi) / phi)
    w = torch.where(small, 1.0 - phi2 / 2.0, torch.cos(phi))
    return torch.cat([w, sinc * v], dim=-1)


def log(q):
    """Quaternion logarithm [..., 4] -> [..., 3] (phi * unit axis)."""
    q = normalize(q)
    w = q[..., 0:1]
    vec = q[..., 1:4]
    mag2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    mag = torch.sqrt(torch.clamp(mag2, min=_EPS * _EPS))
    phi = torch.atan2(mag, w)
    scale = torch.where(mag2 < _EPS * _EPS, torch.zeros_like(phi), phi / mag)
    return scale * vec


def sqrt(q):
    """Positive square root of a rotation quaternion (Quaternion.cs:225-235)."""
    w = q[..., 0:1]
    near_pi = torch.abs(w + 1.0) < 1e-8
    rw = torch.sqrt(torch.clamp(0.5 * (1.0 + w), min=1e-16))
    alpha = torch.where(near_pi, torch.zeros_like(rw), 1.0 / (2.0 * rw))
    return torch.cat(
        [torch.where(near_pi, torch.ones_like(rw), rw), alpha * q[..., 1:4]],
        dim=-1,
    )


def add(q, v):
    """Lie (+): q * exp(v/2) (Quaternion.cs:165-168)."""
    return mul(q, exp(0.5 * v))


def sub(a, b):
    """Lie (-): 2 log(b* a) (Quaternion.cs:175-178)."""
    return 2.0 * log(mul(conj(b), a))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate v by q (expanded cross-product form of q (0, v) q*)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def vector_rotator(src, dst):
    """Quaternion rotating unit vector src into unit vector dst
    (Quaternion.cs:281-284)."""
    w = 1.0 + torch.sum(src * dst, dim=-1, keepdim=True)
    v = _cross(src, dst)
    return normalize(torch.cat([w.expand(v.shape[:-1] + (1,)), v], dim=-1))


def to_matrix(q):
    """Rotation matrix [..., 3, 3] (Quaternion.cs:327-342)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)], dim=-1)
    row1 = torch.stack([2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)], dim=-1)
    row2 = torch.stack([2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
