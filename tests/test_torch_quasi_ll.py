"""The port's quasi set log-likelihood (batched over leading dims), its
gradient and Hessian through the plain beam under torch.autograd, and the
models' fit_to_measurement, against monorfs_tpu on numpy-seeded inputs.

Tolerances: values rtol 1e-10 in float64 and 1e-4 in float32 (the same
sums in another order: einsum contractions, the logsumexp's shift);
gradients 1e-9 and Hessians 1e-7 in float64 (the acceptance bounds of the
smoother's port: autograd's and JAX's reverse passes sum in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu import models as jmodels
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.geometry import quaternion as jquat
from monorfs_tpu.slam import association as jassoc

from monorfs_tpu_torch import models
from monorfs_tpu_torch.geometry import quaternion as quat
from monorfs_tpu_torch.slam import association, beam_kernel

J, M, B = 10, 9, 16


def _problem(name, seed, rows):
    """rows poses around a true pose, a jmap of J landmarks (2 invalid) with
    covariances, M measurement slots (2 clutter, 1 masked)."""
    rng = np.random.default_rng(seed)
    jm = jmodels.get(name)
    jc = JConfig()
    if name == "PRM3D":
        lm = np.column_stack([rng.uniform(-.5, .5, J), rng.uniform(-.4, .4, J), rng.uniform(.6, 1.6, J)])
        truth = np.array([0, 0, 0, 1, 0, 0, 0.0])
        noise = np.array([3.0, 3.0, 0.01])
        tangent_scale = np.array([.02, .02, .02, .01, .01, .01])
    else:
        jc.set_model_defaults(name)
        d = jm.meas_dim
        lm = np.zeros((J, 3))
        lm[:, :d] = rng.uniform(-1.5, 1.5, (J, d))
        truth = np.zeros(d)
        noise = np.full(d, 0.05)
        tangent_scale = np.full(d, 0.05)
    d = jm.meas_dim
    z = np.asarray(jm.measure(jm.params, jnp.asarray(truth)[None, :], jnp.asarray(lm)))[: M - 2]
    z = z + rng.normal(size=z.shape) * noise
    clutter = z[:2] + rng.normal(size=(2, d)) * noise * 20
    z = np.concatenate([z, clutter])[:M]
    z_mask = np.ones(M, bool)
    z_mask[3] = False
    jvalid = np.ones(J, bool)
    jvalid[[1, 6]] = False
    a = rng.normal(size=(J, 3, 3)) * 0.03
    jcov = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    tang = rng.normal(size=(rows, tangent_scale.size)) * tangent_scale
    poses = np.stack([np.asarray(jm.pose.add(jnp.asarray(truth), jnp.asarray(t))) for t in tang])
    params = jc.phd_params(jnp.float64)
    return jm, models.get(name), dict(
        meas_cov=np.asarray(params.meas_cov), pd=float(params.pd),
        log_clutter=float(np.log(params.clutter_density)), poses=poses, jmap=lm, jvalid=jvalid,
        z=z, z_mask=z_mask, jcov=jcov, truth=truth,
    )


def _jax_ll(jm, p, poses, dtype, lm_cov):
    f = lambda pose: jassoc.quasi_set_log_likelihood(  # noqa: E731
        jm, jnp.asarray(p["meas_cov"], dtype), jnp.asarray(p["pd"], dtype),
        jnp.asarray(p["log_clutter"], dtype), pose, jnp.asarray(p["jmap"], dtype),
        jnp.asarray(p["jvalid"]), jnp.asarray(p["z"], dtype), jnp.asarray(p["z_mask"]), B,
        lm_cov=jnp.asarray(p["jcov"], dtype) if lm_cov else None,
    )
    return f, jnp.asarray(poses, dtype)


def _port_ll(tm, p, dtype, lm_cov, **kw):
    t = lambda x: torch.tensor(np.asarray(x), dtype=dtype)  # noqa: E731

    def f(pose):
        return association.quasi_set_log_likelihood(
            tm, t(p["meas_cov"]), t(p["pd"]), t(p["log_clutter"]), pose, t(p["jmap"]),
            torch.tensor(p["jvalid"]), t(p["z"]), torch.tensor(p["z_mask"]), B,
            lm_cov=t(p["jcov"]) if lm_cov else None, **kw,
        )

    return f, t(p["poses"])


@pytest.mark.parametrize("name", ["PRM3D", "Linear2D", "Linear1D"])
@pytest.mark.parametrize("lm_cov", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quasi_ll_values(name, lm_cov, dtype):
    jm, tm, p = _problem(name, 1, 6)
    jf, jposes = _jax_ll(jm, p, p["poses"], getattr(jnp, dtype), lm_cov)
    want = np.asarray(jax.jit(jax.vmap(jf))(jposes))
    tf, tposes = _port_ll(tm, p, getattr(torch, dtype), lm_cov)
    got = tf(tposes).numpy()  # one batched call, [6]
    assert np.isfinite(want).all()
    tol = 1e-10 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # leading dims broadcast: a [2, 3] batch of poses gives the same rows
    np.testing.assert_allclose(tf(tposes.reshape(2, 3, -1)).reshape(-1).numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["PRM3D", "Linear2D"])
@pytest.mark.parametrize("lm_cov", [False, True])
def test_quasi_ll_gradient_and_hessian(name, lm_cov):
    """d/dpose and d2/dpose2 in the pose tangent (the smoother's variable),
    float64: autograd through the plain beam against jax.grad / jax.hessian."""
    jm, tm, p = _problem(name, 2, 4)
    truth = p["truth"]
    jf, _ = _jax_ll(jm, p, p["poses"], jnp.float64, lm_cov)
    o = jm.pose.odo_dim
    rng = np.random.default_rng(3)
    tang = rng.normal(size=(4, o)) * (0.02 if name == "PRM3D" else 0.05)
    jobj = lambda tg: jf(jm.pose.add(jnp.asarray(truth), tg))  # noqa: E731
    want_g = np.asarray(jax.jit(jax.vmap(jax.grad(jobj)))(jnp.asarray(tang)))
    want_h = np.asarray(jax.jit(jax.vmap(jax.hessian(jobj)))(jnp.asarray(tang)))

    tf, _ = _port_ll(tm, p, torch.float64, lm_cov)
    x = torch.tensor(tang, requires_grad=True)
    val = tf(tm.pose.add(torch.tensor(truth), x))
    (g,) = torch.autograd.grad(val.sum(), x, create_graph=True)
    rows = [torch.autograd.grad(g[:, i].sum(), x, retain_graph=True)[0] for i in range(o)]
    h = torch.stack(rows, dim=-2).detach().numpy()
    assert np.abs(want_g).max() > 1.0  # a gradient that says something
    np.testing.assert_allclose(g.detach().numpy(), want_g, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(h, want_h, rtol=1e-7, atol=1e-7)


def test_beam_choice():
    """beam=None: value-only float32 calls go through the beam kernel's
    wrapper (its plain version on CPU tensors: the same numbers), calls that
    need a gradient through the plain beam; an explicit beam is used as
    given."""
    jm, tm, p = _problem("Linear2D", 4, 3)
    calls = []

    def spy(*args):
        calls.append(args[1].shape[0])
        return association.beam_scan(*args)

    tf, poses = _port_ll(tm, p, torch.float32, True, beam=spy)
    ref = tf(poses)
    assert calls == [3]
    tf, _ = _port_ll(tm, p, torch.float32, True)
    launches = beam_kernel.beam_scan_batch.launches
    assert torch.equal(tf(poses), ref)
    assert beam_kernel.beam_scan_batch.launches == launches  # CPU tensors: no launch
    x = poses.clone().requires_grad_(True)
    tf(x).sum().backward()  # the plain beam: a gradient exists
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("name", ["PRM3D", "Linear2D", "Linear1D"])
def test_fit_to_measurement(name):
    rng = np.random.default_rng(5)
    jm, tm = jmodels.get(name), models.get(name)
    s, d = jm.pose.state_dim, jm.meas_dim
    if name == "PRM3D":
        pose0 = np.asarray(jm.pose.add(jnp.asarray([0, 0, 0, 1, 0, 0, 0.0]),
                                       jnp.asarray(rng.normal(size=6) * 0.1)))
        lm = np.column_stack([rng.uniform(-.5, .5, 5), rng.uniform(-.5, .5, 5), rng.uniform(.6, 1.5, 5)])
        z = np.column_stack([rng.uniform(-200, 200, 4), rng.uniform(-150, 150, 4), rng.uniform(.5, 1.8, 4)])
    else:
        pose0 = rng.normal(size=s)
        lm = rng.normal(size=(5, 3))
        z = rng.normal(size=(4, d))
    want = jax.vmap(jax.vmap(lambda l, zz: jm.fit_to_measurement(jm.params, jnp.asarray(pose0), zz, l),
                             in_axes=(None, 0)), in_axes=(0, None))(jnp.asarray(lm), jnp.asarray(z))
    got = tm.fit_to_measurement(tm.params, torch.tensor(pose0), torch.tensor(z)[None, :, :],
                                torch.tensor(lm)[:, None, :])
    assert got.shape == (5, 4, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    if name == "PRM3D":  # the fitted pose sees the landmark where z says
        h = tm.measure(tm.params, got, torch.tensor(lm)[:, None, :])
        np.testing.assert_allclose(h.numpy(), np.broadcast_to(z, h.shape), rtol=1e-9, atol=1e-9)


def test_vector_rotator():
    rng = np.random.default_rng(6)
    src, dst = rng.normal(size=(2, 7, 3))
    src /= np.linalg.norm(src, axis=-1, keepdims=True)
    dst /= np.linalg.norm(dst, axis=-1, keepdims=True)
    want = np.asarray(jquat.vector_rotator(jnp.asarray(src), jnp.asarray(dst)))
    got = quat.vector_rotator(torch.tensor(src), torch.tensor(dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(quat.rotate(got, torch.tensor(src)).numpy(), dst, atol=1e-12)
