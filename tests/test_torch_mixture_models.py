"""The port's smallmat, SoA mixture functions and PRM3D model against
monorfs_tpu on the same numpy inputs. float64 to 1e-10 relative where the
arithmetic is elementwise; float32 where the hot path runs it (stated per
test)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.gm import mixture as jmix
from monorfs_tpu.gm import smallmat as jsm
from monorfs_tpu.io.world import World as JWorld
from monorfs_tpu.models import prm3d as jprm
from monorfs_tpu.sim.simulation import model_for_config as j_model_for_config

from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm import mixture, smallmat as sm
from monorfs_tpu_torch.io.world import World
from monorfs_tpu_torch.models import prm3d
from monorfs_tpu_torch.sim.simulation import model_for_config

RNG = np.random.default_rng(5)


def spd(n, batch):
    a = RNG.normal(size=batch + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def lists(t, lib):
    mk = torch.tensor if lib == "t" else jnp.asarray
    return [[mk(t[..., i, j]) for j in range(t.shape[-1])] for i in range(t.shape[-2])]


def close(a, b, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_smallmat(n):
    a, b = spd(n, (7,)), RNG.normal(size=(7, n, n))
    ta, ja, tb, jb = lists(a, "t"), lists(a, "j"), lists(b, "t"), lists(b, "j")
    close(sm.det(ta), jsm.det(ja))
    for x, y in zip(sum(sm.inv(ta), []), sum(jsm.inv(ja), [])):
        close(x, y)
    close(sm.log_multiplier(ta), jsm.log_multiplier(ja))
    v = RNG.normal(size=(7, n))
    tv, jv = [torch.tensor(v[:, i]) for i in range(n)], [jnp.asarray(v[:, i]) for i in range(n)]
    close(sm.quadform(tv, ta), jsm.quadform(jv, ja))
    for x, y in zip(sm.matvec(tb, tv), jsm.matvec(jb, jv)):
        close(x, y)
    for fn in ("matmul", "add", "sub"):
        for x, y in zip(sum(getattr(sm, fn)(ta, tb), []), sum(getattr(jsm, fn)(ja, jb), [])):
            close(x, y)
    for fn in ("symmetrize", "transpose"):
        for x, y in zip(sum(getattr(sm, fn)(tb), []), sum(getattr(jsm, fn)(jb), [])):
            close(x, y)
    for x, y in zip(sum(sm.sandwich(tb, ta), []), sum(jsm.sandwich(jb, ja), [])):
        close(x, y)
    for x, y in zip(sum(sm.scale(tb, 2.5), []), sum(jsm.scale(jb, 2.5), [])):
        close(x, y)
    close(sm.to_tensor(ta), jsm.to_tensor(ja))
    close(sm.to_tensor(sm.from_tensor(torch.tensor(b))), b)
    close(sm.vec_to_tensor(sm.vec_from_tensor(torch.tensor(v))), v)
    eye = sm.identity_like(n, torch.zeros(7, dtype=torch.float64))
    close(sm.to_tensor(eye), np.broadcast_to(np.eye(n), (7, n, n)))


def _sgm(p, k):
    mean = RNG.normal(size=(p, k, 3))
    cov = spd(3, (p, k)) * 0.05
    logw = np.where(RNG.random((p, k)) < 0.3, jmix.DEAD, RNG.uniform(-2, 0.7, (p, k)))
    logw[:, 0] = 0.0  # a tie on weight 1 for best_map_indices
    logw[:, 1] = 0.0
    jg = jmix.soa_of(jmix.GM(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(logw)))
    return jg, mixture.SGM(*[torch.tensor(np.asarray(x)) for x in jg])


def test_soa_containers():
    e, je = mixture.empty_soa(5, torch.float64, batch=(2,)), jmix.empty_soa(5, jnp.float64, batch=(2,))
    for x, y in zip(e, je):
        close(x, y)
    jg, tg = _sgm(2, 6)
    for x, y in zip(mixture.concat_soa(tg, e), jmix.concat_soa(jg, je)):
        close(x, y)
    cov = spd(3, ())
    lw = RNG.normal(size=(4,))
    mean = RNG.normal(size=3)
    t = mixture.sgm_make([torch.tensor(m) for m in mean], lists(cov, "t"), torch.tensor(lw))
    j = jmix.sgm_make([jnp.asarray(m) for m in mean], lists(cov, "j"), jnp.asarray(lw))
    for x, y in zip(t, j):
        close(x, y)


@pytest.mark.parametrize("radius", [None, 1.5])
def test_evaluate_many_soa(radius):
    jg, tg = _sgm(3, 10)
    pts = RNG.normal(size=(3, 3, 6))
    tp, jp = [torch.tensor(pts[:, i]) for i in range(3)], [jnp.asarray(pts[:, i]) for i in range(3)]
    close(mixture.evaluate_many_soa(tg, tp, radius), jmix.evaluate_many_soa(jg, jp, radius))
    close(mixture.log_evaluate_many_soa(tg, tp, radius), jmix.log_evaluate_many_soa(jg, jp, radius))
    close(mixture.expected_size(tg), jmix.expected_size(jmix.aos_of(jg)))


@pytest.mark.parametrize("cap", [None, 8])
def test_best_map_indices_exact(cap):
    """Indices equal lax.top_k's, ties (the two weight-1 components and the
    dead slots) to the lower index."""
    jg, tg = _sgm(4, 12)
    ti, tv = mixture.best_map_indices(tg.logw, cap)
    ji, jv = jmix.best_map_indices(jg.logw, cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _pose_and_points(p, k, dtype):
    pose = np.tile([0.1, -0.2, 0.05, 1, 0, 0, 0.0], (p, 1))
    q = RNG.normal(size=(p, 4)) * 0.1 + [1, 0, 0, 0]
    pose[:, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    m = RNG.uniform(-0.5, 0.5, (3, p, k))
    m[2] = RNG.uniform(0.3, 1.8, (p, k))
    return pose.astype(dtype), m.astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_prm3d_soa(dtype, tol):
    pose, m = _pose_and_points(4, 9, dtype)
    tp, jp = torch.tensor(pose), jnp.asarray(pose)
    tm, jm = [torch.tensor(x) for x in m], [jnp.asarray(x) for x in m]
    P, jP = prm3d.Params(), jprm.Params()
    th, jh = prm3d.measure_soa(P, tp, tm), jprm.measure_soa(jP, jp, jm)
    for x, y in zip(th, jh):
        close(x, y, rtol=tol, atol=tol)
    for x, y in zip(sum(prm3d.jac_landmark_soa(P, tp, tm), []), sum(jprm.jac_landmark_soa(jP, jp, jm), [])):
        close(x, y, rtol=tol, atol=tol)
    for x, y in zip(prm3d.to_map_soa(P, tp, th), jprm.to_map_soa(jP, jp, jh)):
        close(x, y, rtol=tol, atol=tol)
    ramp = np.array([4.0, 4.0, 0.1], dtype)
    close(prm3d.fuzzy_visible_soa(P, th, torch.tensor(ramp)),
          jprm.fuzzy_visible_soa(jP, jh, jnp.asarray(ramp)), rtol=tol, atol=tol)


def test_prm3d_aos():
    """The vehicle's AoS forms, float64."""
    pose, m = _pose_and_points(1, 12, np.float64)
    lm = np.stack([m[i][0] for i in range(3)], axis=-1)
    P, jP = prm3d.Params(), jprm.Params()
    z = prm3d.measure(P, torch.tensor(pose), torch.tensor(lm))
    jz = jprm.measure(jP, jnp.asarray(pose), jnp.asarray(lm))
    close(z, jz)
    ramp = np.array([4.0, 4.0, 0.1])
    close(prm3d.fuzzy_visible(P, z, torch.tensor(ramp)), jprm.fuzzy_visible(jP, jz, jnp.asarray(ramp)))
    np.testing.assert_array_equal(prm3d.visible(P, z).numpy(), np.asarray(jprm.visible(jP, jz)))
    u = RNG.random((5, 3))
    lo = np.array([P.film_left, P.film_top, P.range_min])
    span = np.array([P.film_width, P.film_height, P.range_max - P.range_min])
    close(prm3d.random_measure(P, torch.tensor(u)), lo + u * span)
    assert prm3d.volume(P) == jprm.volume(jP)


def test_model_for_config_and_config():
    jw, w = JWorld.from_file("assets/sim3d.world"), World.from_file("assets/sim3d.world")
    np.testing.assert_array_equal(w.landmarks, jw.landmarks)
    np.testing.assert_array_equal(w.pose, jw.pose)
    jm, m = j_model_for_config(JConfig(), jw), model_for_config(Config(), w)
    assert m.name == jm.name == "PRM3D"
    for f in ("focal", "film_left", "film_top", "film_width", "film_height", "range_min", "range_max"):
        assert getattr(m.params, f) == getattr(jm.params, f)
    jc, c = JConfig(), Config()
    for f in ("motion_covariance", "measurement_covariance", "visibility_ramp", "birth_covariance"):
        np.testing.assert_array_equal(getattr(c, f), getattr(jc, f))
    jp, tp = jc.phd_params(jnp.float32), c.phd_params(torch.float32, "cpu")
    for f in jp._fields:
        if f != "depth_map":
            np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
