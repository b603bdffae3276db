"""Gaussian sampling factor shared by the vehicle and the motion model."""

import numpy as np


def sqrt_cov(cov):
    """Eigen square-root factor L with L L^T = cov, as monorfs_tpu computes it
    (`vec * sqrt(lam)`, Util.cs:173-202 uses Cholesky; the eigen form also
    takes singular covariances). It is not the symmetric root: each column's
    sign is whatever LAPACK's eigh returns, so the factor is computed once,
    on the host in float64, and the same matrix is used on every device.

    cov: array-like [T, T] -> numpy float64 [T, T]."""
    lam, vec = np.linalg.eigh(np.asarray(cov, np.float64))
    return vec * np.sqrt(np.maximum(lam, 0.0))[None, :]
