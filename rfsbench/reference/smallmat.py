"""Unrolled small-matrix algebra over structure-of-arrays operands: the torch
twin of monorfs_tpu.gm.smallmat.

A small matrix is a list-of-lists of same-shape tensors (e.g. [P, K]); every
operation unrolls into elementwise tensor ops, in the same order as the JAX
twin (Python `sum` from 0). Symmetric 3x3 covariances travel as 6-tuples
(xx, xy, xz, yy, yz, zz)."""

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def from_tensor(t):
    """[..., R, C] tensor -> R x C list-of-lists of [...] tensors."""
    r, c = t.shape[-2], t.shape[-1]
    return [[t[..., i, j] for j in range(c)] for i in range(r)]


def to_tensor(a):
    return torch.stack([torch.stack(row, dim=-1) for row in a], dim=-2)


def vec_from_tensor(t):
    return [t[..., i] for i in range(t.shape[-1])]


def vec_to_tensor(v):
    return torch.stack(v, dim=-1)


def shape_of(a):
    return len(a), len(a[0])


def matmul(a, b):
    """(R x K) @ (K x C) -> R x C."""
    ra, ka = shape_of(a)
    kb, cb = shape_of(b)
    assert ka == kb, (ka, kb)
    return [
        [sum(a[i][k] * b[k][j] for k in range(ka)) for j in range(cb)]
        for i in range(ra)
    ]


def matvec(a, x):
    r, c = shape_of(a)
    assert c == len(x)
    return [sum(a[i][k] * x[k] for k in range(c)) for i in range(r)]


def transpose(a):
    r, c = shape_of(a)
    return [[a[i][j] for i in range(r)] for j in range(c)]


def add(a, b):
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def sub(a, b):
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def scale(a, s):
    return [[x * s for x in row] for row in a]


def identity_like(n, ref):
    one = torch.ones_like(ref)
    zero = torch.zeros_like(ref)
    return [[one if i == j else zero for j in range(n)] for i in range(n)]


def det(a):
    n, _ = shape_of(a)
    if n == 1:
        return a[0][0]
    if n == 2:
        return a[0][0] * a[1][1] - a[0][1] * a[1][0]
    if n == 3:
        return (
            a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
            - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0])
        )
    raise NotImplementedError(n)


def inv(a, dt=None):
    """Adjugate inverse for n in {1, 2, 3}; pass a precomputed determinant to
    share it."""
    n, _ = shape_of(a)
    if dt is None:
        dt = det(a)
    r = 1.0 / dt
    if n == 1:
        return [[r]]
    if n == 2:
        return [[a[1][1] * r, -a[0][1] * r], [-a[1][0] * r, a[0][0] * r]]
    if n == 3:
        return [
            [
                (a[1][1] * a[2][2] - a[1][2] * a[2][1]) * r,
                (a[0][2] * a[2][1] - a[0][1] * a[2][2]) * r,
                (a[0][1] * a[1][2] - a[0][2] * a[1][1]) * r,
            ],
            [
                (a[1][2] * a[2][0] - a[1][0] * a[2][2]) * r,
                (a[0][0] * a[2][2] - a[0][2] * a[2][0]) * r,
                (a[0][2] * a[1][0] - a[0][0] * a[1][2]) * r,
            ],
            [
                (a[1][0] * a[2][1] - a[1][1] * a[2][0]) * r,
                (a[0][1] * a[2][0] - a[0][0] * a[2][1]) * r,
                (a[0][0] * a[1][1] - a[0][1] * a[1][0]) * r,
            ],
        ]
    raise NotImplementedError(n)


def quadform(x, a, y=None):
    """x^T A y (y defaults to x)."""
    if y is None:
        y = x
    n, c = shape_of(a)
    return sum(x[i] * a[i][j] * y[j] for i in range(n) for j in range(c))


def sandwich(j, p):
    """J P J^T."""
    return matmul(matmul(j, p), transpose(j))


def log_multiplier(a, dt=None):
    """log[(2 pi)^(-D/2) det^(-1/2)] (Gaussian.cs:155)."""
    n, _ = shape_of(a)
    if dt is None:
        dt = det(a)
    return -0.5 * (n * LOG2PI + torch.log(dt))


def sym_to_mat(c6):
    xx, xy, xz, yy, yz, zz = c6
    return [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]


def mat_to_sym(a):
    return (a[0][0], a[0][1], a[0][2], a[1][1], a[1][2], a[2][2])


def symmetrize(a):
    """Average A with its transpose (hygiene before mat_to_sym)."""
    n, _ = shape_of(a)
    return [[0.5 * (a[i][j] + a[j][i]) for j in range(n)] for i in range(n)]
