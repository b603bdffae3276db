"""Inputs that hold the hand-written kernels against their plain versions.

chip_smoke.py feeds them to the kernels on the card; the tests feed the same
arrays to the plain versions and to the JAX package's kernels on the CPU.
Every function returns numpy arrays made from a seed."""

import numpy as np
import torch

from .gm.mixture import DEAD
from .models import PRM3D

NEG = np.float32(-1.0e30)


def fused_state(seed, p, k0, m, n_lm, merge_ties=False, model="PRM3D"):
    """A warm random filter state: landmark-like components plus noise, one
    pose per particle, and measurements of the landmarks with one clutter
    return (the construction of tests/test_fused_pallas.py). model names the
    family: PRM3D (camera poses [P, 7], landmarks in the frustum, z [M, 3])
    or Linear2D / Linear1D (poses [P, D] near the origin, landmarks in the
    sensor's box with the padded coordinates zero, z [M, D]).

    merge_ties: every landmark sits in two slots with the same mean, and all
    live weights are equal, so the cut, the gate_top selection and the
    merge's leader order meet exactly equal weights (needs 2 n_lm <= k0).

    Returns (pose [P, S], leaves: 10 arrays [P, K0] in SGM order,
    z [M, D], z_mask [M] bool), float64."""
    rng = np.random.default_rng(seed)
    d = {"PRM3D": 3, "Linear2D": 2, "Linear1D": 1}[model]
    if model == "PRM3D":
        lm = rng.uniform(-0.8, 0.8, (n_lm, 3))
        lm[:, 2] = rng.uniform(0.4, 1.6, n_lm)
    else:
        lm = np.zeros((n_lm, 3))
        lm[:, :d] = rng.uniform(-1.6, 1.6, (n_lm, d))
    spread = np.array([0.03] * d + [0.03 if model == "PRM3D" else 0.0] * (3 - d))
    mean = np.zeros((p, k0, 3))
    logw = np.full((p, k0), DEAD)
    for i in range(p):
        if merge_ties:
            idx = rng.permutation(k0)[:2 * n_lm]
            mu = lm + rng.normal(0, 1.0, lm.shape) * spread
            mean[i, idx] = np.concatenate([mu, mu])
            logw[i, idx] = -0.25
        else:
            idx = rng.permutation(k0)[:n_lm]
            mean[i, idx] = lm + rng.normal(0, 1.0, lm.shape) * spread
            logw[i, idx] = rng.uniform(-1.2, 0.4, n_lm)
    cov = np.full((p, k0), 0.02)
    zero = np.zeros((p, k0))
    leaves = [mean[..., 0], mean[..., 1], mean[..., 2], cov, zero, zero, cov, zero, cov, logw]
    z = np.zeros((m, d))
    n_live = min(n_lm, m - 2)
    if model == "PRM3D":
        pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0.0]), (p, 1))
        pose[:, :3] += rng.normal(0, 0.02, (p, 3))
        zs = PRM3D.measure(PRM3D.params, torch.tensor(pose[0]), torch.tensor(lm)).numpy()
        z[:n_live] = zs[:n_live] + rng.normal(0, 1.0, (n_live, 3)) * np.array([2.0, 2.0, 0.01])
        z[n_live] = [5.0, -10.0, 1.2]  # clutter
    else:
        pose = rng.normal(0, 0.02, (p, d))
        z[:n_live] = lm[:n_live, :d] - pose[0] + rng.normal(0, 0.02, (n_live, d))
        z[n_live] = [1.7, -1.9][:d]  # clutter
    return pose, leaves, z, np.arange(m) < n_live + 1


def beam_ties(seed, p, m, c, n_words):
    """Tie-heavy beam options. Only row 0 of the beam starts alive; every
    option of a step has the same delta, a multiple of 1/4, so sums are
    exact and whole rows tie; some steps have only the clutter option (the
    others NEG), so hundreds of candidates tie at exactly -1e30; and the
    candidates name five landmarks (bit 31 of a word among them), so most
    are used after a few steps. A few word indices fall outside
    [0, n_words) and match no word.

    Returns base [P] f32, opt_delta [P, M, C+1] f32, word_k / bit_k
    [P, M, C] int32 (bit patterns of uint32 words)."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(-8, 8, p) / 4).astype(np.float32)
    delta = (rng.integers(-4, 1, (p, m, 1)) / 4).astype(np.float32)
    od = np.repeat(delta, c + 1, axis=2)
    od[:, :, 1:][rng.random((p, m)) < 0.2] = NEG
    pool = np.array([0, 31, 32 * (n_words - 1), 32 * n_words - 1, 5])
    idx = rng.choice(pool, (p, m, c))
    wk = (idx // 32).astype(np.int32)
    wk[rng.random((p, m, c)) < 0.05] = n_words
    bk = np.left_shift(np.uint32(1), (idx % 32).astype(np.uint32)).view(np.int32)
    return base, od, wk, bk
