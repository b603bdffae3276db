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


def mixture_case(seed, p, kp, kc, e, n_lm=40, live_p=None, live_c=None, n_valid=None, singular=0,
                 garbage=False):
    """Inputs of the weight stage's mixture likelihoods (the predicted and
    the corrected map, the MAP means and their valid rows), as a filter
    hands them on: in each map the first n_lm live components lie at the
    world's landmarks with weights near 1, the other live ones are light
    (births, clutter), on random slots among dead ones; the rows are the
    corrected map's live means in weight order, valid up to floor(sum w)
    (or n_valid) and E.

    live_p / live_c: live components of each map (default half the slots).
    singular: that many of the heaviest live components of both maps get a
    zero covariance (det 0) and one more a negative one (log det NaN), so
    their density is not finite. garbage: the dead slots hold NaN and 1e30
    means and zero covariances instead of an empty slot's zeros and
    identity.

    Returns (pred leaves [10, P, KP], cor leaves [10, P, KC] in SGM order,
    jmeans [3, P, E], float64; jvalid [P, E] bool)."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-1.0, 1.0, (n_lm, 3))
    lm[:, 2] += 2.0

    def make(k, live):
        live = k // 2 if live is None else min(live, k)
        slots = np.argsort(rng.random((p, k)), axis=1)[:, :live]
        rank = np.full((p, k), k)
        np.put_along_axis(rank, slots, np.broadcast_to(np.arange(live), (p, live)), axis=1)
        alive = rank < live
        heavy = rank < n_lm
        which = np.where(heavy, rank % max(n_lm, 1), rng.integers(0, n_lm, (p, k)))
        mean = lm[which] + rng.normal(0.0, 0.03, (p, k, 3))
        sd = rng.uniform(0.05, 0.2, (p, k, 3))
        rho = rng.uniform(-0.3, 0.3, (p, k, 3))
        cov = [sd[..., 0] ** 2, rho[..., 0] * sd[..., 0] * sd[..., 1], rho[..., 1] * sd[..., 0] * sd[..., 2],
               sd[..., 1] ** 2, rho[..., 2] * sd[..., 1] * sd[..., 2], sd[..., 2] ** 2]
        logw = np.where(heavy, rng.uniform(-0.4, 0.1, (p, k)), rng.uniform(-9.0, -3.0, (p, k)))
        logw = np.where(alive, logw, DEAD)
        bad = alive & (rank < singular + 1)
        for i in range(6):
            neg = -0.01 if i in (0, 3, 5) else 0.0
            cov[i] = np.where(bad, np.where(rank < singular, 0.0, neg), cov[i])
        dead = ~alive
        if garbage:
            junk = np.where(rng.random((p, k)) < 0.5, np.nan, 1e30)
            mean = np.where(dead[..., None], junk[..., None], mean)
            cov = [np.where(dead, 0.0, c) for c in cov]
        else:
            mean = np.where(dead[..., None], 0.0, mean)
            cov = [np.where(dead, float(i in (0, 3, 5)), c) for i, c in enumerate(cov)]
        return np.stack([mean[..., 0], mean[..., 1], mean[..., 2], *cov, logw]), alive

    pred, _ = make(kp, live_p)
    cor, alive = make(kc, live_c)
    order = np.argsort(-cor[9], axis=1, kind="stable")[:, :e]
    if order.shape[1] < e:
        order = np.concatenate([order, np.zeros((p, e - order.shape[1]), order.dtype)], axis=1)
    jmeans = np.stack([np.take_along_axis(cor[i], order, axis=1) for i in range(3)])
    jmeans = np.where(np.isfinite(jmeans), jmeans, 0.0)
    if n_valid is None:
        n = np.minimum(np.floor(np.where(alive, np.exp(cor[9]), 0.0).sum(1)), alive.sum(1))
    else:
        n = np.full(p, n_valid)
    jvalid = np.arange(e)[None, :] < n[:, None]
    return pred, cor, jmeans, jvalid


# The edge cases of the mixture likelihood kernel, each a mixture_case:
# name: (P, KP, KC, E, keyword arguments)
MIXTURE_EDGES = {
    "no-live-predicted": (4, 64, 48, 16, dict(live_p=0)),
    "no-live": (4, 64, 48, 16, dict(live_p=0, live_c=0, n_valid=16)),
    "all-invalid": (4, 64, 48, 16, dict(n_valid=0)),
    "singular-covariance": (4, 64, 48, 16, dict(singular=3)),
    "k-not-a-multiple-of-32": (5, 45, 37, 12, dict(n_lm=10)),
    "more-live-than-a-tile": (2, 2500, 2300, 8, dict(live_p=2400, live_c=2200)),
    "one-row": (4, 64, 48, 1, {}),
    "dead-slots-garbage": (4, 64, 48, 16, dict(garbage=True)),
}
