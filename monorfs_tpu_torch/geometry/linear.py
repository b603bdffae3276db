"""Trivial Euclidean pose spaces (Linear1D / Linear2D; LinearPose2D.cs:38-,
LinearPose1D.cs:38-): the torch twin of monorfs_tpu.geometry.linear. State ==
odometry == Lie tangent, every group operation is vector addition and every
Jacobian is the identity."""

import torch


def identity(dim, dtype=torch.float32, device=None):
    return torch.zeros((dim,), dtype=dtype, device=device)


def add(state, delta):
    return state + delta


def subtract(state, origin):
    return state - origin


def add_odometry(state, delta):
    return state + delta


def diff_odometry(state, origin):
    return state - origin


def _eye(state):
    n = state.shape[-1]
    eye = torch.eye(n, dtype=state.dtype, device=state.device)
    return eye.expand(state.shape[:-1] + (n, n))


def add_jacobian(state, delta):
    return _eye(state)


def subtract_jacobian(state, origin):
    return _eye(state)


def add_odometry_jacobian(state, delta):
    return _eye(state)
