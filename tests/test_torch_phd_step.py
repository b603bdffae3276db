"""Four frames of the port's SLAM step against monorfs_tpu's
make_slam_step(pallas_beam=False, pallas_correct=True) -- the fused Pallas
stage in interpret mode and the XLA beam, which is bit-identical to the
Pallas beam -- float32, P=6, K=32, 12 measurement slots compacted to 8, with
the same motion and resample draws (JAX's own key splits) handed to both.

Two modes:
  resync  every frame starts both steps from the JAX state (carried across
          by convert.phd_state): maps to the fused-stage tolerances of
          tests/test_fused_pallas.py (log-weights and means 1e-4,
          covariances rtol 1e-3 / atol 1e-5);
  free    each package runs on its own state for all four frames. Float32
          map means differ by ~1e-7 m, which the camera's 575 px/m
          Jacobian turns into ~1e-3 of pair-update log-weight the next
          frame, so maps are held to their component count and expected
          size (rtol 1e-3).
Both modes: poses atol 1e-5, particle log-weights atol 2e-3 (sums of set
likelihoods of magnitude ~30 in float32), ancestry exact, the best particle
exact after a resampling and else within the log-weights' tolerance of
JAX's (_check_best)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io.world import World as JWorld
from monorfs_tpu.models import get as get_model
from monorfs_tpu.sim import vehicle as jveh
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.slam import phd

from torch_parity import assert_sets_close, np_

CFG = dict(num_particles=6, max_components=32, max_measurements=12, gate_top=8,
           estimate_cap=16, beam_width=16, beam_meas_cap=8, beam_candidates=6,
           merge_rounds=4, meas_compact=8)


def _frames(n, seed):
    """(noisy odometry, z, z_mask) of n frames of the JAX vehicle on the
    first 10 landmarks of the 3D world, 2 clutter slots."""
    jw, jc = JWorld.from_file("assets/sim3d.world"), JConfig()
    model = get_model("PRM3D")
    f32 = jnp.float32
    vp = jveh.VehicleParams(
        jnp.asarray(jc.motion_covariance, f32), jnp.asarray(jc.measurement_covariance, f32),
        jnp.asarray(0.9, f32), jnp.asarray(0.3, f32), jnp.asarray(jc.visibility_ramp, f32),
        jnp.asarray(jc.measure_elapsed, f32), jnp.asarray(False),
    )
    lm = np.asarray(jw.landmarks[:10], np.float32)
    vs = jveh.VehicleState(jnp.asarray(jw.pose, f32), jnp.asarray(lm), jnp.ones(10, bool))
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, ku, km = jax.random.split(key, 3)
        vs, noisy = jveh.update(model, vp, vs, jnp.asarray([0.004, 0, 0, 0, 0.002, 0], f32), ku)
        z, mask, _, _, _ = jveh.measure(model, vp, vs, km, 2)
        out.append((np_(noisy), np_(z).astype(np.float32), np_(mask)))
    return jw.pose, out


@functools.cache
def _jax_step():
    return jax.jit(jphd.make_slam_step(
        get_model("PRM3D"), jphd.PHDConfig(**CFG), pallas_beam=False, pallas_correct=True
    ))


def _expected_size(maps):
    lw = np_(maps.logw)
    return np.where(lw > -0.25e30, np.exp(lw), 0.0).sum(-1)


def _check_best(tstate, jstate):
    """The best particle. After a resampling it is the last drawn slot whose
    source held the largest weight, exact. Without one it is the argmax of
    the log-weights, which float32 determines only to the 2e-3 the
    log-weights are held to: the first frame's increments are ~-72, where
    float32's spacing is 7.6e-6, and JAX's top two lie 1.5e-5 apart. The port's best is then its own
    argmax and one of the particles within 2e-3 of JAX's maximum."""
    jlw, tlw, best = np_(jstate.logweight), tstate.logweight.numpy(), int(tstate.best)
    if not np.array_equal(np_(jstate.ancestor), np.arange(len(jlw))):
        assert best == int(jstate.best)
        return
    assert tlw[best] == tlw.max()
    assert jlw[best] >= jlw.max() - 2e-3, (best, int(jstate.best), jlw)


# min_effective_particle 0.95 makes the ESS test resample
@pytest.mark.parametrize("mode,min_eff", [("resync", 0.95), ("free", 0.1)])
def test_step_matches_jax(mode, min_eff):
    model = get_model("PRM3D")
    jcfg, tcfg = jphd.PHDConfig(**CFG), phd.PHDConfig(**CFG)
    jc = JConfig()
    jc.min_effective_particle = min_eff
    jparams = jc.phd_params(jnp.float32)
    tparams = convert.phd_params({k: np_(v) for k, v in jparams._asdict().items()}, device="cpu")
    step, tstep = _jax_step(), phd.make_slam_step(PRM3D, tcfg)

    pose0, frames = _frames(4, seed=2)
    jstate = jphd.init_state(model, jcfg, np.asarray(pose0, np.float32), jnp.float32)
    tstate = phd.init_state(PRM3D, tcfg, pose0, torch.float32, "cpu")
    key = jax.random.PRNGKey(9)
    resampled = 0
    for noisy, z, mask in frames:
        if mode == "resync":
            tstate = convert.phd_state(
                np_(jstate.pose), np_(jstate.logweight), [np_(x) for x in jstate.maps],
                np_(jstate.best), np_(jstate.ancestor), device="cpu",
            )
        key, sub = jax.random.split(key)
        kmotion, kresample = jax.random.split(sub)
        normals = np_(jax.random.normal(kmotion, (CFG["num_particles"], 6), jnp.float32))
        u = np_(jax.random.uniform(kresample, (), jnp.float32))
        jstate = step(jparams, jstate, jnp.asarray(noisy), jnp.asarray(z), jnp.asarray(mask), sub)
        tstate = tstep(tparams, tstate, torch.tensor(noisy), torch.tensor(z), torch.tensor(mask),
                       torch.tensor(normals), torch.tensor(u))
        np.testing.assert_allclose(tstate.pose.numpy(), np_(jstate.pose), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tstate.logweight.numpy(), np_(jstate.logweight), rtol=0, atol=2e-3)
        np.testing.assert_array_equal(tstate.ancestor.numpy(), np_(jstate.ancestor))
        _check_best(tstate, jstate)
        if mode == "resync":
            assert_sets_close(jstate.maps, tstate.maps, CFG["num_particles"])
        else:
            np.testing.assert_array_equal((tstate.maps.logw.numpy() > -0.25e30).sum(-1),
                                          (np_(jstate.maps.logw) > -0.25e30).sum(-1))
            np.testing.assert_allclose(_expected_size(tstate.maps), _expected_size(jstate.maps),
                                       rtol=1e-3)
        resampled += int(not np.array_equal(np_(jstate.ancestor), np.arange(CFG["num_particles"])))
    assert (resampled > 0) == (min_eff > 0.5)
