"""The port's XLA-semantics path (phd._births_soa + phd._correct_prune_soa),
its AoS specification (_births, _correct) and the step built with
kernels=False against the JAX package's functions and
make_slam_step(pallas_beam=False, pallas_correct=False), for PRM3D, Linear2D
and Linear1D, on the same numpy inputs from a seed.

Tolerances: float64 1e-9 everywhere (same formulas; reductions differ in
order only); float32 component sets to the fused-stage tolerances of
tests/test_fused_pallas.py (log-weights and means 1e-4, covariances rtol 1e-3
/ atol 1e-5). Both packages keep survivors in weight order, so float64 maps
are compared slot for slot. The step gets JAX's own draws: the key splits of
make_slam_step are replayed and their normals and uniform handed to the port."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.gm import mixture as jmixture
from monorfs_tpu.io.world import World as JWorld
from monorfs_tpu.models import get as jget
from monorfs_tpu.sim import vehicle as jveh
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm import mixture
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.kernel_cases import fused_state
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.slam import phd

from torch_parity import assert_sets_close, np_

MODELS = ["PRM3D", "Linear2D", "Linear1D"]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
WORLDS = {"PRM3D": "sim3d", "Linear2D": "linear2d", "Linear1D": "linear1d"}


def _params(name, jdt, tdt, **over):
    jc = JConfig()
    jc.set_model_defaults(name)
    for k, v in over.items():
        setattr(jc, k, v)
    jp = jc.phd_params(jdt)
    return jp, convert.phd_params({k: np_(v) for k, v in jp._asdict().items()}, tdt, "cpu")


def _fns(jm, jp):
    return (jm.measure_soa_fn(), jm.jac_landmark_soa_fn(), jm.to_map_soa_fn(),
            jm.fuzzy_visible_soa_fn(jp.depth_map))


def _assert_maps(jmaps, tmaps, p, f64):
    if f64:
        for name, a, b in zip(SGM._fields, jmaps, tmaps):
            np.testing.assert_allclose(b.numpy(), np_(a), rtol=1e-9, atol=1e-9, err_msg=name)
    else:
        assert_sets_close(jmaps, tmaps, p)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("k_out", [32, 10])  # the cap loose, and binding
def test_births_correct_prune_soa(name, jdt, tdt, k_out):
    p, k0, m = 3, 32, 12
    jm, tm = jget(name), tget(name)
    jp, tp = _params(name, jdt, tdt)
    cfgs = dict(num_particles=p, max_components=k_out, max_measurements=m, merge_rounds=4)
    pose, leaves, z, z_mask = fused_state(31, p, k0, m, 10, model=name)
    d = jm.meas_dim
    jpose, jz, jmask = jnp.asarray(pose, jdt), jnp.asarray(z, jdt), jnp.asarray(z_mask)
    jmaps = jmixture.SGM(*[jnp.asarray(x, jdt) for x in leaves])
    jzl = [jz[:, i] for i in range(d)]
    fns = _fns(jm, jp)

    def one(pose_i, maps_i):
        births = jphd._births_soa(jm, fns[2], jp, pose_i, maps_i, jzl, jmask)
        pred = jmixture.concat_soa(maps_i, births)
        return births, jphd._correct_prune_soa(jm, jphd.PHDConfig(**cfgs), jp, fns, pose_i, pred, jzl, jmask)

    jbirths, jcor = jax.vmap(one)(jpose, jmaps)

    tpose, tz = torch.tensor(pose, dtype=tdt), torch.tensor(z, dtype=tdt)
    tmaps = SGM(*[torch.tensor(x, dtype=tdt) for x in leaves])
    tzl = [tz[:, i] for i in range(d)]
    tbirths = phd._births_soa(tm, tp, tpose, tmaps, tzl, torch.tensor(z_mask))
    tcor = phd._correct_prune_soa(tm, phd.PHDConfig(**cfgs), tp, tpose,
                                  mixture.concat_soa(tmaps, tbirths), tzl, torch.tensor(z_mask))
    tol = 1e-9 if tdt == torch.float64 else 2e-5
    for a, b in zip(jbirths, tbirths):
        np.testing.assert_allclose(b.numpy(), np_(a), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tbirths.logw.numpy() > -1e29, np_(jbirths.logw) > -1e29)
    _assert_maps(jcor, tcor, p, tdt == torch.float64)
    n_alive = (tcor.logw.numpy() > -1e29).sum(-1)
    assert (n_alive > 0).all() and (n_alive <= k_out).all()


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_aos_births_and_correct(name, jdt, tdt):
    k0, m = 24, 10
    jm, tm = jget(name), tget(name)
    jp, tp = _params(name, jdt, tdt)
    jcfg = jphd.PHDConfig(num_particles=1, max_components=k0, max_measurements=m, gate_top=4)
    tcfg = phd.PHDConfig(num_particles=1, max_components=k0, max_measurements=m, gate_top=4)
    pose, leaves, z, z_mask = fused_state(33, 1, k0, m, 8, model=name)
    jgm = jmixture.aos_of(jmixture.SGM(*[jnp.asarray(x[0], jdt) for x in leaves]))
    tgm = mixture.aos_of(SGM(*[torch.tensor(x[0], dtype=tdt) for x in leaves]))
    jpose, jz, jmask = jnp.asarray(pose[0], jdt), jnp.asarray(z, jdt), jnp.asarray(z_mask)
    tpose, tz, tmask = torch.tensor(pose[0], dtype=tdt), torch.tensor(z, dtype=tdt), torch.tensor(z_mask)
    jb = jphd._births(jm, jp, jpose, jgm, jz, jmask)
    tb = phd._births(tm, tp, tpose, tgm, tz, tmask)
    jc = jphd._correct(jm, jcfg, jp, jpose, jmixture.concat(jgm, jb), jz, jmask)
    tc = phd._correct(tm, tcfg, tp, tpose, mixture.concat(tgm, tb), tz, tmask)
    tol = 1e-9 if tdt == torch.float64 else 2e-4
    for j, t in ((jb, tb), (jc, tc)):
        live = np_(j.logw) > -1e29
        np.testing.assert_array_equal(t.logw.numpy() > -1e29, live)
        np.testing.assert_allclose(t.logw.numpy()[live], np_(j.logw)[live], rtol=tol, atol=tol)
        np.testing.assert_allclose(t.mean.numpy()[live], np_(j.mean)[live], rtol=tol, atol=tol)
        np.testing.assert_allclose(t.cov.numpy()[live], np_(j.cov)[live], rtol=10 * tol, atol=tol)
    assert tc.capacity == k0 + m + m * 4 and live.sum() > 8


# ---- the step ------------------------------------------------------------------------

CFG = dict(num_particles=5, max_components=24, max_measurements=14, gate_top=8,
           estimate_cap=16, beam_width=12, beam_candidates=4, merge_rounds=4)


@functools.cache
def _frames(name, n, seed):
    """(first pose, [(true pose, noisy odometry, z, z_mask)]) of n frames of
    the JAX vehicle on the first 6 landmarks of the model's asset world."""
    jw, jc = JWorld.from_file(f"assets/{WORLDS[name]}.world"), JConfig()
    jc.set_model_defaults(name)
    model = jget(name)
    f64 = jnp.float64
    vp = jveh.VehicleParams(
        jnp.asarray(jc.motion_covariance, f64) * 0.01, jnp.asarray(jc.measurement_covariance, f64),
        jnp.asarray(0.9, f64), jnp.asarray(0.5, f64), jnp.asarray(jc.visibility_ramp, f64),
        jnp.asarray(jc.measure_elapsed, f64), jnp.asarray(False),
    )
    near = np.argsort(np.linalg.norm(jw.landmarks - np.pad(jw.pose[:3], (0, max(0, 3 - len(jw.pose)))), axis=1))
    lm = jw.landmarks[near[:6]] if name != "PRM3D" else jw.landmarks[:6]
    vs = jveh.VehicleState(jnp.asarray(jw.pose, f64), jnp.asarray(lm, f64), jnp.ones(6, bool))
    reading = {"PRM3D": [0.004, 0, 0, 0, 0.002, 0], "Linear2D": [0.03, 0.01], "Linear1D": [0.03]}[name]
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, ku, km = jax.random.split(key, 3)
        vs, noisy = jveh.update(model, vp, vs, jnp.asarray(reading, f64), ku)
        z, mask, _, _, _ = jveh.measure(model, vp, vs, km, 8)
        out.append((np_(vs.pose), np_(noisy), np_(z), np_(mask)))
    return jw.pose, out


def _run_steps(name, slam, jdt, tdt, kernels, n=3, min_eff=0.9999):
    jm, tm = jget(name), tget(name)
    # a motion covariance small enough that particles keep their landmarks in gate
    jp, tp = _params(name, jdt, tdt, min_effective_particle=min_eff,
                     motion_covariance=JConfig().motion_covariance if name == "PRM3D"
                     else np.eye(jm.pose.odo_dim) * 0.05)
    jcfg, tcfg = jphd.PHDConfig(**CFG), phd.PHDConfig(**CFG)
    jstep = jax.jit(jphd.make_slam_step(jm, jcfg, slam=slam, pallas_beam=False, pallas_correct=False))
    tstep = phd.make_slam_step(tm, tcfg, slam=slam, kernels=kernels)
    pose0, frames = _frames(name, n, 4)
    jstate = jphd.init_state(jm, jcfg, np.asarray(pose0), jdt)
    tstate = phd.init_state(tm, tcfg, pose0, tdt, "cpu")
    key = jax.random.PRNGKey(12)
    p, t_dim = CFG["num_particles"], jm.pose.odo_dim
    for true_pose, noisy, z, mask in frames:
        key, sub = jax.random.split(key)
        kmotion, kresample = jax.random.split(sub)
        normals = np_(jax.random.normal(kmotion, (p, t_dim), jdt))
        u = np_(jax.random.uniform(kresample, (), jdt))
        jstate = jstep(jp, jstate, jnp.asarray(noisy, jdt), jnp.asarray(z, jdt), jnp.asarray(mask),
                       sub, jnp.asarray(true_pose, jdt))
        tstate = tstep(tp, tstate, torch.tensor(noisy, dtype=tdt), torch.tensor(z, dtype=tdt),
                       torch.tensor(mask), torch.tensor(normals, dtype=tdt),
                       torch.tensor(u, dtype=tdt), true_pose=torch.tensor(true_pose, dtype=tdt))
        yield jstate, tstate


@pytest.mark.parametrize("name", MODELS)
def test_step_xla_semantics_matches_jax_f64(name):
    resampled = 0
    for frame, (jstate, tstate) in enumerate(
            _run_steps(name, True, jnp.float64, torch.float64, kernels=False)):
        np.testing.assert_allclose(tstate.pose.numpy(), np_(jstate.pose), rtol=0, atol=1e-9)
        np.testing.assert_allclose(tstate.logweight.numpy(), np_(jstate.logweight), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(tstate.ancestor.numpy(), np_(jstate.ancestor))
        # the first frame starts from empty maps: every particle weighs the
        # same up to rounding, and the best of equals is arbitrary
        assert frame == 0 or int(tstate.best) == int(jstate.best)
        _assert_maps(jstate.maps, tstate.maps, CFG["num_particles"], True)
        resampled += int(not np.array_equal(np_(jstate.ancestor), np.arange(CFG["num_particles"])))
    assert resampled > 0 and (tstate.maps.logw.numpy() > -1e29).sum() > 0


@pytest.mark.parametrize("name", ["Linear2D"])
def test_step_default_choice_is_xla_semantics_for_f64(name):
    """kernels=None on a float64 state takes the same functions as
    kernels=False: identical tensors."""
    for (_, a), (_, b) in zip(_run_steps(name, True, jnp.float64, torch.float64, None, n=2),
                              _run_steps(name, True, jnp.float64, torch.float64, False, n=2)):
        for x, y in zip(list(a.maps) + [a.pose, a.logweight], list(b.maps) + [b.pose, b.logweight]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("name,jdt,tdt,kernels", [
    ("PRM3D", jnp.float64, torch.float64, False), ("Linear2D", jnp.float64, torch.float64, False),
    ("Linear1D", jnp.float64, torch.float64, False), ("Linear1D", jnp.float32, torch.float32, False)])
def test_mapping_only_step(name, jdt, tdt, kernels):
    """slam=False: poses snap to the true pose, weights stay, best is 0, the
    ancestry is the identity; the map is the XLA path's (float64 1e-9,
    float32 the fused-stage tolerances)."""
    p = CFG["num_particles"]
    _, frames = _frames(name, 3, 4)
    for (jstate, tstate), (true_pose, _, _, _) in zip(_run_steps(name, False, jdt, tdt, kernels), frames):
        np.testing.assert_allclose(tstate.pose.numpy(), np.tile(true_pose, (p, 1)).astype(tstate.pose.numpy().dtype))
        np.testing.assert_allclose(tstate.logweight.numpy(), np.full(p, -np.log(p)), rtol=1e-6)
        np.testing.assert_array_equal(tstate.logweight.numpy(), np_(jstate.logweight))
        assert int(tstate.best) == int(jstate.best) == 0
        np.testing.assert_array_equal(tstate.ancestor.numpy(), np.arange(p))
        _assert_maps(jstate.maps, tstate.maps, p, tdt == torch.float64)
    assert (tstate.maps.logw.numpy() > -1e29).sum() >= p


def test_mapping_only_step_float32_takes_the_fused_stage():
    """kernels=None, float32, slam=False: the fused stage (its plain version
    on the CPU) builds the map and no particle is weighed."""
    p = CFG["num_particles"]
    for jstate, tstate in _run_steps("Linear2D", False, jnp.float32, torch.float32, None):
        assert tstate.pose.dtype == torch.float32 and int(tstate.best) == 0
        np.testing.assert_array_equal(tstate.logweight.numpy(), np_(jstate.logweight))
        np.testing.assert_array_equal((tstate.maps.logw.numpy() > -1e29).sum(-1),
                                      (np_(jstate.maps.logw) > -1e29).sum(-1))
    assert_sets_close(jstate.maps, tstate.maps, p)


def test_kernels_true_refuses_float64():
    tm = tget("Linear1D")
    tcfg = phd.PHDConfig(**CFG)
    _, tp = _params("Linear1D", jnp.float64, torch.float64)
    state = phd.init_state(tm, tcfg, np.zeros(1), torch.float64, "cpu")
    step = phd.make_slam_step(tm, tcfg, kernels=True)
    with pytest.raises(ValueError, match="float32 only"):
        step(tp, state, torch.zeros(1, dtype=torch.float64), torch.zeros((14, 1), dtype=torch.float64),
             torch.zeros(14, dtype=torch.bool), torch.zeros((5, 1), dtype=torch.float64),
             torch.tensor(0.5, dtype=torch.float64))
