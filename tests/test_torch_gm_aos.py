"""The port's Gaussian primitives and AoS mixture against the JAX package's,
same numpy inputs from a seed. Closed-form determinants and inverses and
einsum sums: float64 to rtol 1e-10, float32 to rtol 2e-4 (inverses of
covariances with condition number ~10 lose a few digits); masks, counts and
shapes exactly; prune_merge covariances to atol 1e-5 (float32) and 1e-10."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.gm import gaussian as jg
from monorfs_tpu.gm import mixture as jmix

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm import gaussian as tg
from monorfs_tpu_torch.gm import mixture as tmix

DTYPES = [(jnp.float32, torch.float32, 2e-4), (jnp.float64, torch.float64, 1e-10)]


def _spd(rng, shape, d):
    a = rng.normal(size=shape + (d, d))
    return a @ np.swapaxes(a, -1, -2) * 0.05 + 0.05 * np.eye(d)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_gaussian_primitives(d, jdt, tdt, tol):
    rng = np.random.default_rng(d)
    cov, x, mean = _spd(rng, (6,), d), rng.normal(size=(6, d)), rng.normal(size=(6, d))
    jc, jx, jm = jnp.asarray(cov, jdt), jnp.asarray(x, jdt), jnp.asarray(mean, jdt)
    tc, tx, tm = torch.tensor(cov, dtype=tdt), torch.tensor(x, dtype=tdt), torch.tensor(mean, dtype=tdt)
    _close(tg.det(tc), jg.det(jc), tol)
    _close(tg.inv(tc), jg.inv(jc), tol)
    _close(tg.mahalanobis2(tx, tm, tg.inv(tc)), jg.mahalanobis2(jx, jm, jg.inv(jc)), 10 * tol)
    _close(tg.log_multiplier(tc), jg.log_multiplier(jc), tol)
    _close(tg.logpdf(tx, tm, tc), jg.logpdf(jx, jm, jc), 10 * tol)
    _close(tg.logpdf_with_inv(tx, tm, tg.inv(tc), tg.log_multiplier(tc)),
           jg.logpdf_with_inv(jx, jm, jg.inv(jc), jg.log_multiplier(jc)), 10 * tol)
    for t, j in zip(tg.canonical_of(tm, tc), jg.canonical_of(jm, jc)):
        _close(t, j, 10 * tol)
    for t, j in zip(tg.moments_of(*tg.canonical_of(tm, tc)), jg.moments_of(*jg.canonical_of(jm, jc))):
        _close(t, j, 100 * tol)
    _close(tg.canonical_bias(tm, tc), jg.canonical_bias(jm, jc), 10 * tol)
    for t, j in zip(tg.fuse_canonical(tm, tc, tm, tc), jg.fuse_canonical(jm, jc, jm, jc)):
        _close(t, j, tol)
    logw, mask = rng.normal(size=6), rng.uniform(size=6) < 0.7
    for t, j in zip(tg.merge_moments(torch.tensor(logw, dtype=tdt), tm, tc, torch.tensor(mask)),
                    jg.merge_moments(jnp.asarray(logw, jdt), jm, jc, jnp.asarray(mask))):
        _close(t, j, 10 * tol)


def _mixture(rng, k, batch=()):
    mean = rng.normal(size=batch + (k, 3))
    cov = _spd(rng, batch + (k,), 3)
    logw = np.where(rng.uniform(size=batch + (k,)) < 0.6, rng.uniform(-2, 0.5, batch + (k,)), tmix.DEAD)
    return mean, cov, logw


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_aos_mixture(jdt, tdt, tol):
    rng = np.random.default_rng(5)
    mean, cov, logw = _mixture(rng, 12)
    jgm = jmix.GM(jnp.asarray(mean, jdt), jnp.asarray(cov, jdt), jnp.asarray(logw, jdt))
    tgm = convert.gm(mean, cov, logw, tdt, "cpu")
    assert (tgm.capacity, tgm.dim) == (jgm.capacity, jgm.dim) == (12, 3)
    np.testing.assert_array_equal(tmix.alive(tgm).numpy(), np.asarray(jmix.alive(jgm)))
    assert int(tmix.count(tgm)) == int(jmix.count(jgm))
    _close(tmix.weights(tgm), jmix.weights(jgm), tol)
    _close(tmix.expected_size(tgm), jmix.expected_size(jgm), tol)
    pts = mean[:5] + rng.normal(0, 0.2, (5, 3))
    jp, tp = jnp.asarray(pts, jdt), torch.tensor(pts, dtype=tdt)
    for radius in (None, 0.8):
        _close(tmix.evaluate_many(tgm, tp, radius), jmix.evaluate_many(jgm, jp, radius), 20 * tol)
        _close(tmix.evaluate(tgm, tp[0], radius), jmix.evaluate(jgm, jp[0], radius), 20 * tol)
    # empty, concat, SoA <-> AoS, take
    te, je = tmix.empty(4, dtype=tdt, batch=(2,)), jmix.empty(4, dtype=jdt, batch=(2,))
    for t, j in zip(te, je):
        _close(t, j, 0)
    both_t, both_j = tmix.concat(tgm, tmix.empty(3, dtype=tdt)), jmix.concat(jgm, jmix.empty(3, dtype=jdt))
    for t, j in zip(both_t, both_j):
        _close(t, j, 0)
    ts, js = tmix.soa_of(tgm), jmix.soa_of(jgm)
    for t, j in zip(ts, js, strict=True):
        _close(t, j, 0)
    for t, j in zip(tmix.aos_of(ts), jmix.aos_of(js)):
        _close(t, j, 0)
    idx = np.array([3, 0, 7])
    for t, j in zip(tmix.take_soa(ts, torch.tensor(idx), axis=0), jmix.take_soa(js, jnp.asarray(idx), axis=0)):
        _close(t, j, 0)


@pytest.mark.parametrize("seed,max_q", [(0, 10), (1, 6), (2, 16)])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_prune_merge(seed, max_q, jdt, tdt, tol):
    """Clustered components, so the merge has work; a cap below the live
    count, so the cut has too. Same survivors slot for slot."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2, 2, (5, 3))
    mean = centres[rng.integers(0, 5, 16)] + rng.normal(0, 0.02, (16, 3))
    cov = np.tile(np.eye(3) * 0.02, (16, 1, 1))
    logw = np.where(rng.uniform(size=16) < 0.85, rng.uniform(-3, 0.5, 16), tmix.DEAD)
    logw[3] = np.log(5e-4)  # below min_weight
    j = jmix.prune_merge(jmix.GM(jnp.asarray(mean, jdt), jnp.asarray(cov, jdt), jnp.asarray(logw, jdt)),
                         max_q, 1e-3, 0.3, rounds=4)
    t = tmix.prune_merge(convert.gm(mean, cov, logw, tdt, "cpu"), max_q, 1e-3, 0.3, rounds=4)
    np.testing.assert_array_equal(tmix.alive(t).numpy(), np.asarray(jmix.alive(j)))
    assert 0 < int(tmix.count(t)) < int((logw > -1e29).sum())
    _close(t.logw, j.logw, 10 * tol)
    _close(t.mean, j.mean, 10 * tol)
    # raw second moments minus mean mean^T: |mean|^2 eps of absolute noise
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), rtol=0,
                               atol=1e-5 if tdt == torch.float32 else 1e-10)
