"""Data-to-pixel maps of the port's figures.

A figure maps each data point in two steps, done on the device for a whole
batch of frames at once (`to_pixels`): a 4x4 homogeneous matrix M, then a
2x3 affine A to pixels (x right, y down, pixel (i, j) the unit square at
column j, row i). A 2D axes has M = I and an A with equal aspect,
matplotlib's default 5% data margins and the y axis pointing up
(`axes2d`). A 3D axes has matplotlib's own projection as M (`proj_matrix`)
and an A that maps the 3D axes' fixed 2D view limits onto a square
(`axes3d`).

`proj_matrix` is the math of matplotlib 3.10.8's `Axes3D.get_proj` and
`mpl_toolkits.mplot3d.proj3d` (world_transformation, _view_axes,
_rotation_about_vector, _view_transformation_uvw, _persp_transformation)
for the defaults the JAX viewer uses: `view_init(elev, azim, roll)` with z
vertical, the perspective projection with focal length 1 at camera
distance 10, and the box aspect 4:4:3 scaled as `Axes3D.set_box_aspect(None)`
scales it. `view_axes` is the camera's screen axes in the world's unit box,
as `Axes3D._calc_view_axes` gives them, for the window's mouse pan.
"""

import math

import numpy as np
import torch

MARGIN = 0.05  # matplotlib's axes.xmargin / axes.ymargin
VIEW_LIM = (-0.095, 0.09)  # an Axes3D's 2D view limits, both axes
DIST = 10.0  # Axes3D._dist after view_init
FOCAL = 1.0  # Axes3D's focal length for proj_type='persp'
# Axes3D.set_box_aspect(None): (4, 4, 3) * 1.8294640721620434 * 25/24 / |(4, 4, 3)|
BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * 1.8294640721620434 * 25 / 24 / math.sqrt(41.0)


def _norm_angle(a):
    """mpl_toolkits.mplot3d.art3d._norm_angle: degrees into (-180, 180]."""
    a = (a + 360) % 360
    return a - 360 if a > 180 else a


def _rotation_about_vector(v, angle):
    """proj3d._rotation_about_vector: the rotation by angle (radians) about v."""
    vx, vy, vz = v / np.linalg.norm(v)
    sn, cs = np.sin(angle), np.cos(angle)
    t = 2 * np.sin(angle / 2) ** 2
    return np.array([[t * vx * vx + cs, t * vx * vy - vz * sn, t * vx * vz + vy * sn],
                     [t * vy * vx + vz * sn, t * vy * vy + cs, t * vy * vz - vx * sn],
                     [t * vz * vx - vy * sn, t * vz * vy + vx * sn, t * vz * vz + cs]])


def view_axes(elev, azim, roll=0.0):
    """(u, v, w, ps) of an Axes3D after view_init(elev, azim, roll): u to the
    right of the screen, v to its top, w out of it (Axes3D._calc_view_axes),
    and ps the unit direction from the box's centre to the eye."""
    elev_rad, azim_rad = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(elev_rad) * np.cos(azim_rad), np.cos(elev_rad) * np.sin(azim_rad),
                   np.sin(elev_rad)])
    vert = np.array([0.0, 0.0, -1.0 if abs(np.deg2rad(_norm_angle(elev))) > np.pi / 2 else 1.0])
    r = 0.5 * BOX_ASPECT
    w = (r + DIST * ps) - r
    w = w / np.linalg.norm(w)
    u = np.cross(vert, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    roll_rad = np.deg2rad(_norm_angle(roll))
    if roll_rad != 0:  # a positive roll of the camera turns the world the other way
        rot = _rotation_about_vector(w, -roll_rad)
        u, v = np.dot(rot, u), np.dot(rot, v)
    return u, v, w, ps


def proj_matrix(xlim, ylim, zlim, elev, azim, roll=0.0):
    """Axes3D.get_proj: the 4x4 float64 projection of an Axes3D with these
    limits after view_init(elev, azim, roll) (z vertical)."""
    (x0, x1), (y0, y1), (z0, z1) = xlim, ylim, zlim
    ax, ay, az = BOX_ASPECT
    dx, dy, dz = (x1 - x0) / ax, (y1 - y0) / ay, (z1 - z0) / az
    world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
    u, v, w, ps = view_axes(elev, azim, roll)
    # proj3d._view_transformation_uvw at the focal-length-scaled eye
    eye_focal = 0.5 * BOX_ASPECT + DIST * ps * FOCAL
    mr, mt = np.eye(4), np.eye(4)
    mr[:3, :3] = [u, v, w]
    mt[:3, -1] = -eye_focal
    view = np.dot(mr, mt)
    # proj3d._persp_transformation(-DIST, DIST, FOCAL)
    zfront, zback = -DIST, DIST
    b = (zfront + zback) / (zfront - zback)
    c = -2 * (zfront * zback) / (zfront - zback)
    persp = np.array([[FOCAL, 0, 0, 0], [0, FOCAL, 0, 0], [0, 0, b, c], [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view, world))


def autoscale(lo, hi):
    """matplotlib's default view interval of data spanning [lo, hi]."""
    if hi <= lo:  # a single value: matplotlib's nonsingular expansion
        d = 0.001 * abs(lo) if lo else 1.0
        return lo - d, hi + d
    pad = (hi - lo) * MARGIN
    return lo - pad, hi + pad


def axes2d(xlim, ylim, box, equal=True):
    """(xlim, ylim, A) of a 2D axes whose frame fills the pixel box (x0, y0,
    x1, y1): with equal aspect, the limits of the axis with room to spare
    widen about their centre (matplotlib's adjustable='datalim')."""
    x0, y0, x1, y1 = box
    (a, b), (c, d) = xlim, ylim
    sx, sy = (x1 - x0) / (b - a), (y1 - y0) / (d - c)
    if equal:
        s = min(sx, sy)
        cx, cy = (a + b) / 2, (c + d) / 2
        a, b = cx - (x1 - x0) / s / 2, cx + (x1 - x0) / s / 2
        c, d = cy - (y1 - y0) / s / 2, cy + (y1 - y0) / s / 2
        sx = sy = s
    aff = np.array([[sx, 0.0, x0 - a * sx], [0.0, -sy, y1 + c * sy]])
    return (a, b), (c, d), aff


def axes3d(box):
    """A of a 3D axes whose square view box is the pixel box (x0, y0, x1,
    y1): the projected coordinates' VIEW_LIM square onto it, y up."""
    x0, y0, x1, y1 = box
    lo, hi = VIEW_LIM
    s = min(x1 - x0, y1 - y0) / (hi - lo)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    mid = (lo + hi) / 2
    return np.array([[s, 0.0, cx - mid * s], [0.0, -s, cy + mid * s]])


def invert_affine(aff, x, y):
    """(x, y) whose pixel coordinates under the 2x3 affine are (x, y)."""
    return tuple(np.linalg.solve(aff[:, :2], np.array([x - aff[0, 2], y - aff[1, 2]])))


def apply_affine(aff, x, y):
    """Pixel coordinates of (x, y) under one 2x3 affine (host numpy)."""
    return aff[0, 0] * x + aff[0, 1] * y + aff[0, 2], aff[1, 0] * x + aff[1, 1] * y + aff[1, 2]


def to_pixels(points, frame, m, aff):
    """Pixel coordinates [N, 2] of data points [N, 3] (float64 tensors on
    the device) of frames `frame` [N], under per-frame matrices m [F, 4, 4]
    and affines aff [F, 2, 3]."""
    h = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    hw = torch.einsum("nij,nj->ni", m[frame], h)
    uv1 = torch.stack([hw[:, 0] / hw[:, 3], hw[:, 1] / hw[:, 3], torch.ones_like(hw[:, 0])], dim=1)
    return torch.einsum("nij,nj->ni", aff[frame], uv1)
