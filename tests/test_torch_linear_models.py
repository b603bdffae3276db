"""The port's linear geometry and Linear1D / Linear2D models against the JAX
package's, on the same numpy inputs from a seed, float32 and float64: every
AoS and SoA function. The functions are sums, differences, minima and
divisions of the same operands, so they agree to rtol 1e-6 (float32) and
1e-12 (float64); booleans and shapes exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.geometry import linear as jlinear
from monorfs_tpu.models import get as jget

from monorfs_tpu_torch.geometry import linear as tlinear
from monorfs_tpu_torch.models import get as tget

DTYPES = [(jnp.float32, torch.float32, 1e-6), (jnp.float64, torch.float64, 1e-12)]


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_linear_pose_ops(dim, jdt, tdt, tol):
    rng = np.random.default_rng(dim)
    a, b = rng.normal(size=(5, dim)), rng.normal(size=(5, dim))
    ja, jb, ta, tb = jnp.asarray(a, jdt), jnp.asarray(b, jdt), torch.tensor(a, dtype=tdt), torch.tensor(b, dtype=tdt)
    jops, tops = jget(f"Linear{dim}D").pose, tget(f"Linear{dim}D").pose
    assert (tops.state_dim, tops.odo_dim) == (jops.state_dim, jops.odo_dim) == (dim, dim)
    for name in ("add", "subtract", "add_global", "subtract_global", "add_odometry",
                 "diff_odometry", "add_jacobian", "subtract_jacobian", "add_odometry_jacobian"):
        _close(getattr(tops, name)(ta, tb), getattr(jops, name)(ja, jb), tol)
    _close(tops.identity(tdt), jops.identity(jdt), 0)
    _close(tlinear.identity(dim, tdt), jlinear.identity(dim, jdt), 0)


@pytest.mark.parametrize("name,dim", [("Linear2D", 2), ("Linear1D", 1)])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_linear_model_aos(name, dim, jdt, tdt, tol):
    rng = np.random.default_rng(7 + dim)
    jm, tm = jget(name), tget(name)
    assert tm.meas_dim == jm.meas_dim == dim and tm.params == tm.params.from_linear(jm.params.to_linear())
    pose, lm = rng.normal(size=(1, dim)), rng.uniform(-3, 3, (9, 3))
    z, ramp = rng.uniform(-2.5, 2.5, (9, dim)), np.array([0.07, 0.05, 0.0])[:dim] + 0.0
    jp, jl, jz, jr = (jnp.asarray(x, jdt) for x in (pose, lm, z, ramp))
    tp, tl, tz, tr = (torch.tensor(x, dtype=tdt) for x in (pose, lm, z, ramp))
    _close(tm.measure(tm.params, tp, tl), jm.measure(jm.params, jp, jl), tol)
    _close(tm.jac_landmark(tm.params, tp, tl), jm.jac_landmark(jm.params, jp, jl), 0)
    _close(tm.to_map(tm.params, tp, tz), jm.to_map(jm.params, jp, jz), tol)
    _close(tm.fuzzy_visible(tm.params, tz, tr), jm.fuzzy_visible(jm.params, jz, jr), tol)
    np.testing.assert_array_equal(tm.visible(tm.params, tz).numpy(), np.asarray(jm.visible(jm.params, jz)))
    assert tm.volume(tm.params) == jm.volume(jm.params)
    # clutter: the JAX form draws uniform(-range, range); the port maps a
    # uniform [0, 1) it is handed onto the same box
    u = rng.uniform(size=(6, dim))
    zc = tm.random_measure(tm.params, torch.tensor(u, dtype=tdt)).numpy()
    np.testing.assert_allclose(zc, -2.0 + 4.0 * u, rtol=tol, atol=tol)
    assert np.all(tm.visible(tm.params, torch.tensor(zc, dtype=tdt)).numpy())


@pytest.mark.parametrize("name,dim", [("Linear2D", 2), ("Linear1D", 1)])
@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_linear_model_soa(name, dim, jdt, tdt, tol):
    rng = np.random.default_rng(17 + dim)
    jm, tm = jget(name), tget(name)
    pose = rng.normal(size=(4, dim))
    m = [rng.uniform(-3, 3, (4, 6)) for _ in range(3)]
    z = [rng.uniform(-2.5, 2.5, (4, 6)) for _ in range(dim)]
    ramp = np.array([0.07, 0.05])[:dim]
    jp, tp = jnp.asarray(pose, jdt), torch.tensor(pose, dtype=tdt)
    jm3, tm3 = [jnp.asarray(x, jdt) for x in m], [torch.tensor(x, dtype=tdt) for x in m]
    jz, tz = [jnp.asarray(x, jdt) for x in z], [torch.tensor(x, dtype=tdt) for x in z]
    jr, tr = jnp.asarray(ramp, jdt), torch.tensor(ramp, dtype=tdt)
    for t, j in zip(tm.measure_soa_fn()(tm.params, tp, tm3), jm.measure_soa_fn()(jm.params, jp, jm3), strict=True):
        _close(t, j, tol)
    tj, jj = tm.jac_landmark_soa_fn()(tm.params, tp, tm3), jm.jac_landmark_soa_fn()(jm.params, jp, jm3)
    assert len(tj) == len(jj) == dim
    for trow, jrow in zip(tj, jj):
        for t, j in zip(trow, jrow, strict=True):
            _close(t, j, 0)
    for t, j in zip(tm.to_map_soa_fn()(tm.params, tp, tz), jm.to_map_soa_fn()(jm.params, jp, jz), strict=True):
        _close(t, j, tol)
    _close(tm.fuzzy_visible_soa_fn()(tm.params, tz, tr),
           jm.fuzzy_visible_soa_fn(None)(jm.params, jz, jr), tol)
    # the SoA forms agree with the AoS forms
    aos = tm.measure(tm.params, tp[:, None, :], torch.stack(tm3, -1))
    for i, t in enumerate(tm.measure_soa(tm.params, tp, tm3)):
        np.testing.assert_array_equal(t.numpy(), aos[..., i].numpy())


def test_prm3d_aos_additions_match():
    """The PRM3D AoS forms added for the specification path (jac_landmark,
    to_map, to_linear), float64 to 1e-12."""
    rng = np.random.default_rng(3)
    jm, tm = jget("PRM3D"), tget("PRM3D")
    q = rng.normal(size=4)
    pose = np.concatenate([rng.normal(0, 0.1, 3), q / np.linalg.norm(q)])[None, :]
    lm = rng.uniform(-0.5, 0.5, (7, 3)) + np.array([0, 0, 1.2])
    jp, jl = jnp.asarray(pose, jnp.float64), jnp.asarray(lm, jnp.float64)
    tp, tl = torch.tensor(pose), torch.tensor(lm)
    _close(tm.jac_landmark(tm.params, tp, tl), jm.jac_landmark(jm.params, jp, jl), 1e-12)
    z = jm.measure(jm.params, jp, jl)
    _close(tm.to_map(tm.params, tp, torch.tensor(np.asarray(z))), jm.to_map(jm.params, jp, z), 1e-12)
    assert tm.params.to_linear() == jm.params.to_linear()
