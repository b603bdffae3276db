"""Shared helpers of the tests/test_torch_*.py parity tests: the same numpy
inputs go through monorfs_tpu (the reference, JAX on the CPU) and
monorfs_tpu_torch (device='cpu', the plain PyTorch paths)."""

import numpy as np
import torch

import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.gm import mixture as jmixture

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm.mixture import SGM

DEAD = -1.0e30


def np_(x):
    return np.asarray(x)


def t32(x):
    return torch.tensor(np.array(x), dtype=torch.float32)


def sgm_to_torch(sgm):
    return SGM(*[t32(leaf) for leaf in sgm])


def params_pair(cfg=None):
    """(JAX PHDParams float32, torch PHDParams float32 on the CPU)."""
    jp = (cfg or JConfig()).phd_params(jnp.float32)
    tp = convert.phd_params({k: np_(v) for k, v in jp._asdict().items()}, device="cpu")
    return jp, tp


def random_state(jmodel, k0, m, seed, p, n_lm=12, dtype=jnp.float32):
    """A warm random filter state (landmark-like components + noise), the
    construction of tests/test_fused_pallas.py::_random_state."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-0.8, 0.8, (n_lm, 3))
    lm[:, 2] = rng.uniform(0.4, 1.6, n_lm)
    mean = np.zeros((p, k0, 3))
    logw = np.full((p, k0), DEAD)
    cov = np.tile(np.eye(3) * 0.02, (p, k0, 1, 1))
    for i in range(p):
        idx = rng.permutation(k0)[:n_lm]
        mean[i, idx] = lm + rng.normal(0, 0.03, lm.shape)
        logw[i, idx] = rng.uniform(-1.2, 0.4, n_lm)
    gm = jmixture.GM(jnp.asarray(mean, dtype), jnp.asarray(cov, dtype), jnp.asarray(logw, dtype))
    maps = jmixture.soa_of(gm)
    pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0.0]), (p, 1))
    pose[:, :3] += rng.normal(0, 0.02, (p, 3))
    pose = jnp.asarray(pose, dtype)
    z = np.zeros((m, 3))
    n_live = min(n_lm, m - 2)
    zs = np.asarray(jmodel.measure(jmodel.params, pose[0][None, :], jnp.asarray(lm)))
    z[:n_live] = zs[:n_live] + rng.normal(0, 1.0, (n_live, 3)) * np.array([2.0, 2.0, 0.01])
    z[n_live] = [5.0, -10.0, 1.2]  # clutter
    z_mask = np.arange(m) < n_live + 1
    return pose, maps, jnp.asarray(z, dtype), jnp.asarray(z_mask)


def component_sets(sgm, p):
    """Per-particle alive components sorted by log-weight, descending."""
    leaves = [np_(leaf) for leaf in sgm]
    logw = leaves[9]
    mean = np.stack(leaves[0:3], axis=-1)
    cov6 = np.stack(leaves[3:9], axis=-1)
    out = []
    for i in range(p):
        al = logw[i] > -0.25e30
        order = np.argsort(-logw[i][al], kind="stable")
        out.append((logw[i][al][order], mean[i][al][order], cov6[i][al][order]))
    return out


def assert_sets_close(ref, got, p):
    """The fused-stage tolerances of tests/test_fused_pallas.py: same count,
    log-weights and means to 1e-4, covariances rtol 1e-3 / atol 1e-5;
    equal-weight components are paired greedily by mean distance."""
    for i, ((lw_r, mu_r, c_r), (lw_k, mu_k, c_k)) in enumerate(
        zip(component_sets(ref, p), component_sets(got, p))
    ):
        assert len(lw_r) == len(lw_k), (i, len(lw_r), len(lw_k))
        np.testing.assert_allclose(lw_k, lw_r, rtol=1e-4, atol=1e-4)
        used = np.zeros(len(lw_r), bool)
        for j in range(len(lw_k)):
            dist = np.linalg.norm(mu_r - mu_k[j], axis=-1) + np.where(used, 1e9, 0.0)
            jj = int(np.argmin(dist))
            used[jj] = True
            np.testing.assert_allclose(mu_k[j], mu_r[jj], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(c_k[j], c_r[jj], rtol=1e-3, atol=1e-5)
