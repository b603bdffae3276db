"""The port's graph solver (slam/graph.py) and the model Jacobians it needs
against the JAX package's, on hand-built graphs (tests/torch_parity.py::
graph_problem: 12 poses, 8 landmarks, Linear2D and PRM3D) carried over with
convert.graph_state.

Tolerances: Jacobians 1e-12 in float64 and 1e-5 in float32; normal
equations, Schur solve, five Gauss-Newton iterations and marginals relative
1e-9 in float64; float32 poses and landmarks absolute 1e-4. The JAX
functions run under jax.jit, as the JAX package's navigator runs them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu import models as jmodels
from monorfs_tpu.geometry import pose3d as jpose3d
from monorfs_tpu.slam import graph as jgraph

from monorfs_tpu_torch import convert, models
from monorfs_tpu_torch.geometry import pose3d
from monorfs_tpu_torch.slam import graph

from torch_parity import fields, graph_problem, np_

MODELS = ["Linear2D", "PRM3D"]


def _pair(name, dtype=jnp.float64, **kw):
    jm, jcfg, jst, minfo, sinfo = graph_problem(name, dtype=dtype, **kw)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tcfg = graph.GraphConfig(jcfg.max_poses, jcfg.max_landmarks, jcfg.max_factors)
    tst = convert.graph_state(fields(jst), dtype=tdt, device="cpu")
    jinfo = (jnp.asarray(minfo, dtype), jnp.asarray(sinfo, dtype))
    tinfo = (torch.tensor(minfo, dtype=tdt), torch.tensor(sinfo, dtype=tdt))
    return jm, models.get(name), jcfg, tcfg, jst, tst, jinfo, tinfo


def _close(got, want, rel):
    want = np_(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", ["Linear1D"] + MODELS)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_jac_pose_matches_jax(name, dtype, tol):
    rng = np.random.default_rng(3)
    jm, tm = jmodels.get(name), models.get(name)
    if name == "PRM3D":
        pose = np.tile([0, 0, 0, 1, 0, 0, 0.0], (9, 1))
        pose = np_(jpose3d.add(jnp.asarray(pose), jnp.asarray(rng.normal(size=(9, 6)) * 0.1)))
        lm = np.column_stack([rng.uniform(-.4, .4, 9), rng.uniform(-.4, .4, 9), rng.uniform(.6, 1.8, 9)])
    else:
        pose = rng.normal(size=(9, jm.pose.state_dim))
        lm = rng.normal(size=(9, 3))
    pose, lm = pose.astype(dtype), lm.astype(dtype)
    want = np_(jm.jac_pose(jm.params, jnp.asarray(pose), jnp.asarray(lm)))
    got = tm.jac_pose(tm.params, torch.tensor(pose), torch.tensor(lm))
    assert got.dtype == torch.tensor(pose).dtype and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the Jacobian is the derivative of measure along pose.add
    if dtype == np.float64:
        step = 1e-6
        for k in range(tm.pose.odo_dim):
            d = torch.zeros(9, tm.pose.odo_dim, dtype=torch.float64)
            d[:, k] = step
            fd = (tm.measure(tm.params, tm.pose.add(torch.tensor(pose), d), torch.tensor(lm))
                  - tm.measure(tm.params, tm.pose.add(torch.tensor(pose), -d), torch.tensor(lm))) / (2 * step)
            np.testing.assert_allclose(got[..., k].numpy(), fd.numpy(), rtol=1e-5, atol=1e-5)


def test_visible_fn_and_normalize():
    tm = models.get("PRM3D")
    assert tm.visible_fn() is tm.visible
    pose = torch.tensor([[1.0, 2.0, 3.0, 2.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]],
                        dtype=torch.float64)
    np.testing.assert_allclose(pose3d.normalize(pose).numpy(),
                               np_(jpose3d.normalize(jnp.asarray(pose.numpy()))), atol=1e-15)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-12), (jnp.float32, 1e-5)])
def test_between_jacobians_match_jax(name, dtype, tol):
    jm, tm, _, _, jst, tst, _, _ = _pair(name, dtype)
    for want, got in zip(jax.jit(lambda st: jgraph._linearize_between(jm, st))(jst),
                         graph._linearize_between(tm, tst)):
        np.testing.assert_allclose(got.numpy(), np_(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("duplicate", [False, True])
def test_normal_equations_match_jax(name, duplicate):
    jm, tm, jcfg, tcfg, jst, tst, jinfo, tinfo = _pair(name, duplicate=duplicate)
    want = jax.jit(lambda st: jgraph.build_normal_equations(jm, jcfg, st, *jinfo))(jst)
    got = graph.build_normal_equations(tm, tcfg, tst, *tinfo)
    for w, g in zip(want, got):
        assert g.shape == np_(w).shape
        _close(g, w, 1e-9)
    # the same with the slot axis fixed ahead (no count read from the data)
    layout = graph.factor_layout(tcfg, tst)
    fixed = graph.GraphConfig(tcfg.max_poses, tcfg.max_landmarks, tcfg.max_factors,
                              factors_per_pose=layout.mask.shape[1] + 3)
    for w, g in zip(want, graph.build_normal_equations(tm, fixed, tst, *tinfo)):
        _close(g, w, 1e-9)


def test_factor_layout_keeps_order():
    _, _, _, tcfg, _, tst, _, _ = _pair("Linear2D", duplicate=True)
    layout = graph.factor_layout(tcfg, tst)
    fp, fl, fm = tst.f_pose.numpy(), tst.f_lm.numpy(), tst.f_mask.numpy()
    assert int(layout.mask.sum()) == int(fm.sum())
    for t in range(tcfg.max_poses):
        mine = fl[fm & (fp == t)]
        n = int(layout.mask[t].sum())
        assert n == len(mine) and layout.mask[t, :n].all()
        np.testing.assert_array_equal(layout.lm[t, :n].numpy(), mine)
        np.testing.assert_array_equal(layout.z[t, :n].numpy(), tst.f_z.numpy()[fm & (fp == t)])


@pytest.mark.parametrize("name", MODELS)
def test_schur_solve_matches_jax(name):
    jm, tm, jcfg, tcfg, jst, tst, jinfo, tinfo = _pair(name)
    o = tm.pose.odo_dim
    jh = jax.jit(lambda st: jgraph.build_normal_equations(jm, jcfg, st, *jinfo))(jst)
    th = graph.build_normal_equations(tm, tcfg, tst, *tinfo)
    jhpp, jhpl, jbp = jgraph._apply_gauges(jcfg, jst, o, jh[0], jh[1], jh[3])
    thpp, thpl, tbp = graph._apply_gauges(tcfg, tst, o, th[0], th[1], th[3])
    for w, g in ((jhpp, thpp), (jhpl, thpl), (jbp, tbp)):
        _close(g, w, 1e-9)
    jdxp, jdxl, (jsolve, *_) = jgraph._schur_solve(jcfg, jst, o, jhpp, jhpl, jh[2], jbp, jh[4], 1e-6)
    tdxp, tdxl, (tsolve, *_) = graph._schur_solve(tcfg, tst, o, thpp, thpl, th[2], tbp, th[4], 1e-6)
    _close(tdxp, jdxp, 1e-9)
    _close(tdxl, jdxl, 1e-9)
    rhs = np.random.default_rng(1).normal(size=(thpp.shape[0], 4))
    _close(tsolve(torch.tensor(rhs)), jsolve(jnp.asarray(rhs)), 1e-9)
    _close(tsolve(torch.tensor(rhs[:, 0])), jsolve(jnp.asarray(rhs[:, 0])), 1e-9)


@pytest.mark.parametrize("name", MODELS)
def test_gauss_newton_and_marginals_match_jax(name):
    jm, tm, jcfg, tcfg, jst, tst, jinfo, tinfo = _pair(name)
    before = graph.counts["cholesky"]
    jout = jgraph.gauss_newton(jm, jcfg, jst, *jinfo)
    tout = graph.gauss_newton(tm, tcfg, tst, *tinfo)
    assert graph.counts["cholesky"] - before == tcfg.gn_iters == 5
    _close(tout.poses, jout.poses, 1e-9)
    _close(tout.landmarks, jout.landmarks, 1e-9)
    assert float((tout.poses - tst.poses).abs().max()) > 1e-4  # it moved
    np.testing.assert_array_equal(tout.poses[tst.n_poses:].numpy(), tst.poses[tst.n_poses:].numpy())
    meas_cov = np.linalg.inv(np_(jinfo[1]))
    jlm, jpl = jax.jit(lambda st: jgraph.marginals(jm, jcfg, st, *jinfo, jnp.asarray(meas_cov)))(jout)
    tlm, tpl = graph.marginals(tm, tcfg, tout, *tinfo, torch.tensor(meas_cov))
    _close(tlm, jlm, 1e-9)
    _close(tpl, jpl, 1e-9)
    # J Sigma J^T + R is at least R
    live = tout.lm_mask.numpy()
    assert (np.linalg.eigvalsh(tpl.numpy()[live]).min(axis=1) >= 0.99 * np.diag(meas_cov).min()).all()


@pytest.mark.parametrize("name", MODELS)
def test_gauss_newton_float32(name):
    jm, tm, jcfg, tcfg, jst, tst, jinfo, tinfo = _pair(name, jnp.float32)
    jout = jgraph.gauss_newton(jm, jcfg, jst, *jinfo)
    tout = graph.gauss_newton(tm, tcfg, tst, *tinfo)
    assert tout.poses.dtype == torch.float32
    np.testing.assert_allclose(tout.poses.numpy(), np_(jout.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout.landmarks.numpy(), np_(jout.landmarks), rtol=0, atol=1e-4)


def test_empty_state_and_mapping_mode():
    """empty_state's fields equal the JAX package's; with every pose pinned
    (mapping mode) Gauss-Newton leaves the poses where they are."""
    jm, tm, jcfg, tcfg, jst, tst, jinfo, tinfo = _pair("Linear2D")
    je = jgraph.empty_state(jm, jcfg, np.array([0.5, -1.0]), jnp.float64)
    te = graph.empty_state(tm, tcfg, np.array([0.5, -1.0]), torch.float64, "cpu")
    for k, v in fields(je).items():
        np.testing.assert_array_equal(np.asarray(getattr(te, k)), v, err_msg=k)
    pinned = tst._replace(pose_fixed=torch.ones_like(tst.pose_fixed))
    jout = jgraph.gauss_newton(jm, jcfg, jst._replace(pose_fixed=jnp.ones_like(jst.pose_fixed)), *jinfo)
    tout = graph.gauss_newton(tm, tcfg, pinned, *tinfo)
    np.testing.assert_array_equal(tout.poses.numpy(), tst.poses.numpy())
    _close(tout.landmarks, jout.landmarks, 1e-9)


def test_solve_refuses_tf32_and_needs_a_gpu_by_default():
    tm = models.get("Linear2D")
    cfg = graph.GraphConfig(4, 4, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graph.empty_state(tm, cfg, np.zeros(2))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            graph.gauss_newton(tm, cfg, graph.empty_state(tm, cfg, np.zeros(2), device="cpu"),
                               torch.eye(2), torch.eye(2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_cholesky_failure_raises():
    """An indefinite reduced system is an error, never a silent NaN."""
    _, tm, _, tcfg, _, tst, _, tinfo = _pair("Linear2D")
    with pytest.raises(torch.linalg.LinAlgError):
        graph.gauss_newton(tm, tcfg, tst, -tinfo[0], -tinfo[1])
