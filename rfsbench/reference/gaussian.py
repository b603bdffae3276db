"""Batched weighted-Gaussian primitives for small fixed dimensions
(Gaussian.cs:40-490): the torch twin of monorfs_tpu.gm.gaussian, plus the
sampling factor shared by the vehicle and the motion model.

Components live in dense tensors (mean [..., D], cov [..., D, D], log-weight
[...]). Inverses and determinants are closed forms for D in {1, 2, 3}."""

import math

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)


def det(cov):
    """Determinant for [..., D, D] with D in {1, 2, 3}."""
    d = cov.shape[-1]
    if d == 1:
        return cov[..., 0, 0]
    if d == 2:
        return cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    if d == 3:
        a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
        dd, e, f = cov[..., 1, 0], cov[..., 1, 1], cov[..., 1, 2]
        g, h, i = cov[..., 2, 0], cov[..., 2, 1], cov[..., 2, 2]
        return a * (e * i - f * h) - b * (dd * i - f * g) + c * (dd * h - e * g)
    return torch.linalg.det(cov)


def inv(cov):
    """Adjugate inverse for [..., D, D] with D in {1, 2, 3}; LU above that,
    without the status check that would wait for the device (a singular
    matrix gives non-finite entries, as in the JAX package)."""
    d = cov.shape[-1]
    if d == 1:
        return 1.0 / cov
    dt = det(cov)[..., None, None]
    if d == 2:
        a, b = cov[..., 0, 0], cov[..., 0, 1]
        c, e = cov[..., 1, 0], cov[..., 1, 1]
        adj = torch.stack([torch.stack([e, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return adj / dt
    if d == 3:
        a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
        dd, e, f = cov[..., 1, 0], cov[..., 1, 1], cov[..., 1, 2]
        g, h, i = cov[..., 2, 0], cov[..., 2, 1], cov[..., 2, 2]
        adj = torch.stack(
            [
                torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
                torch.stack([f * g - dd * i, a * i - c * g, c * dd - a * f], dim=-1),
                torch.stack([dd * h - e * g, b * g - a * h, a * e - b * dd], dim=-1),
            ],
            dim=-2,
        )
        return adj / dt
    return torch.linalg.inv_ex(cov)[0]


def mahalanobis2(x, mean, cov_inv):
    """Squared Mahalanobis distance (Gaussian.cs:365-369); x, mean [..., D],
    cov_inv [..., D, D]."""
    diff = x - mean
    return torch.einsum("...i,...ij,...j->...", diff, cov_inv, diff)


def log_multiplier(cov):
    """log of the normalisation constant (2 pi)^(-D/2) det^(-1/2)
    (Gaussian.cs:155)."""
    return -0.5 * (cov.shape[-1] * LOG2PI + torch.log(det(cov)))


def logpdf(x, mean, cov):
    """Unweighted log density (Gaussian.cs:211-215)."""
    return log_multiplier(cov) - 0.5 * mahalanobis2(x, mean, inv(cov))


def logpdf_with_inv(x, mean, cov_inv, logmult):
    return logmult - 0.5 * mahalanobis2(x, mean, cov_inv)


def merge_moments(logw, mean, cov, mask, axis=-1):
    """Moment-matched merge of masked components along `axis`
    (Gaussian.cs:297-347): w = sum wi, m = sum wi mi / w,
    P = sum wi (Pi + mi mi^T) / w - m m^T. Returns (w, mean, cov) with the
    component axis reduced; w is in the linear domain."""
    axis = axis % logw.ndim
    w = torch.where(mask, torch.exp(logw), torch.zeros_like(logw))
    wsum = torch.sum(w, dim=axis)
    safe = torch.clamp(wsum, min=1e-300 if w.dtype == torch.float64 else 1e-30)
    wm = w[..., None]
    m = torch.sum(wm * mean, dim=axis) / safe[..., None]
    second = cov + mean[..., :, None] * mean[..., None, :]
    p = torch.sum(wm[..., None] * second, dim=axis) / safe[..., None, None]
    p = p - m[..., :, None] * m[..., None, :]
    return wsum, m, p


def fuse_canonical(vec_a, mat_a, vec_b, mat_b):
    """Information-form product of two Gaussians (Gaussian.cs:253-260)."""
    return vec_a + vec_b, mat_a + mat_b


def canonical_of(mean, cov):
    """(canonical vector, canonical matrix) of a moments-form Gaussian."""
    ci = inv(cov)
    return torch.einsum("...ij,...j->...i", ci, mean), ci


def moments_of(vec, mat):
    """(mean, cov) of a canonical-form Gaussian."""
    cov = inv(mat)
    return torch.einsum("...ij,...j->...i", cov, vec), cov


def canonical_bias(mean, cov):
    """log Multiplier - 0.5 m^T P^-1 m (Gaussian.cs:117-123)."""
    return log_multiplier(cov) - 0.5 * mahalanobis2(torch.zeros_like(mean), mean, inv(cov))


def sqrt_cov(cov):
    """Eigen square-root factor L with L L^T = cov, as monorfs_tpu computes it
    (`vec * sqrt(lam)`, Util.cs:173-202 uses Cholesky; the eigen form also
    takes singular covariances). It is not the symmetric root: each column's
    sign is whatever LAPACK's eigh returns, so the factor is computed once,
    on the host in float64, and the same matrix is used on every device.

    cov: array-like [T, T] -> numpy float64 [T, T]."""
    lam, vec = np.linalg.eigh(np.asarray(cov, np.float64))
    return vec * np.sqrt(np.maximum(lam, 0.0))[None, :]
