"""The port's simulated vehicle against monorfs_tpu.sim.vehicle, float32,
with the draws taken from JAX's own key splits and handed to both; then the
port's FrameRunner (update + measure on fixed tensors, a CUDA-graph replay
on a card) on the CPU against update + measure."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io.world import World as JWorld
from monorfs_tpu.sim import vehicle as jveh
from monorfs_tpu.sim.simulation import model_for_config as j_model_for_config
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm.gaussian import sqrt_cov
from monorfs_tpu_torch.io.world import World, parse_commands
from monorfs_tpu_torch.sim import vehicle
from monorfs_tpu_torch.sim.simulation import Simulation, model_for_config

MAX_CLUTTER = 8


@pytest.mark.parametrize("field", ["motion_covariance", "measurement_covariance"])
def test_sqrt_cov_matches_jax_factor(field):
    """The host float64 factor equals the float32 eigh factor of both JAX
    call sites (vehicle._sqrt_cov and phd._sample_mvn), column signs
    included, for the default diagonal covariances (rtol 1e-6)."""
    cov = getattr(JConfig(), field)
    ours = sqrt_cov(cov).astype(np.float32)
    np.testing.assert_allclose(ours, np.asarray(jveh._sqrt_cov(jnp.asarray(cov, jnp.float32))),
                               rtol=1e-6, atol=1e-9)
    key = jax.random.PRNGKey(0)
    normals = np.asarray(jax.random.normal(key, (5, cov.shape[0]), jnp.float32))
    ref = jphd._sample_mvn(key, jnp.asarray(cov, jnp.float32), (5,), jnp.float32)
    np.testing.assert_allclose(normals @ ours.T, np.asarray(ref), rtol=1e-5, atol=1e-8)


def _setup():
    jw, w = JWorld.from_file("assets/sim3d.world"), World.from_file("assets/sim3d.world")
    jc, c = JConfig(), Config()
    jm, m = j_model_for_config(jc, jw), model_for_config(c, w)
    f32 = jnp.float32
    jparams = jveh.VehicleParams(
        motion_cov=jnp.asarray(jc.motion_covariance, f32),
        meas_cov=jnp.asarray(jc.measurement_covariance, f32),
        pd=jnp.asarray(jc.detection_probability, f32),
        clutter_count=jnp.asarray(jc.clutter_density * float(jm.volume(jm.params)), f32),
        visibility_ramp=jnp.asarray(jc.visibility_ramp, f32),
        dt=jnp.asarray(jc.measure_elapsed, f32),
        perfect_still=jnp.asarray(jc.perfect_still, bool),
    )
    tparams = vehicle.make_params(m, c, torch.float32, "cpu")
    lm = np.asarray(jw.landmarks, np.float32)
    mask = np.ones(len(lm), bool)
    jstate = jveh.VehicleState(jnp.asarray(jw.pose, f32), jnp.asarray(lm), jnp.asarray(mask))
    tstate = convert.vehicle_state(jw.pose, lm, mask, device="cpu")
    with open("assets/mov3d.in") as f:
        cmds = [c[:6] for c in parse_commands(f.read())]
    return jm, m, jparams, tparams, jstate, tstate, cmds


def test_vehicle_frames_match():
    jm, m, jparams, tparams, jstate, tstate, cmds = _setup()
    key = jax.random.PRNGKey(4)
    l, d = jstate.landmarks.shape[0], 3
    clutter_seen = 0
    for f in range(6):
        key, kupd, kmeas = jax.random.split(key, 3)
        reading = np.asarray(cmds[f], np.float32)
        jstate, jnoisy = jveh.update(jm, jparams, jstate, jnp.asarray(reading), kupd)
        normals = jax.random.normal(kupd, (6,), jnp.float32)
        tstate, tnoisy = vehicle.update(m, tparams, tstate, torch.tensor(reading),
                                        torch.tensor(np.asarray(normals)))
        np.testing.assert_allclose(tstate.pose.numpy(), np.asarray(jstate.pose), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tnoisy.numpy(), np.asarray(jnoisy), rtol=1e-4, atol=1e-6)

        # a clutter-heavy rate on odd frames exercises the 10-lambda cap
        cc = jnp.asarray(0.35 if f % 2 else float(jparams.clutter_count), jnp.float32)
        jp_f, tp_f = jparams._replace(clutter_count=cc), tparams._replace(
            clutter_count=torch.tensor(float(cc)))
        kdetect, knoise, kcount, kclutter = jax.random.split(kmeas, 4)
        jz, jmask, jlab, jvis, jdet = jveh.measure(jm, jp_f, jstate, kmeas, MAX_CLUTTER)
        draws = (
            torch.tensor(np.asarray(jax.random.uniform(kdetect, (l,)))),
            torch.tensor(np.asarray(jax.random.normal(knoise, (l, d), jnp.float32))),
            torch.tensor(np.asarray(jax.random.poisson(kcount, cc))),
            torch.tensor(np.asarray(jax.random.uniform(kclutter, (MAX_CLUTTER, 3)))),
        )
        tz, tmask, tlab, tvis, tdet = vehicle.measure(m, tp_f, tstate, *draws, MAX_CLUTTER)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
        np.testing.assert_array_equal(tdet.numpy(), np.asarray(jdet))
        live = np.asarray(jmask)
        np.testing.assert_allclose(tz.numpy()[live], np.asarray(jz)[live], rtol=1e-5, atol=1e-4)
        clutter_seen += int(live[l:].sum())
    assert clutter_seen > 0


# the asset world and commands of each simulated model
WORLDS = {"PRM3D": ("sim3d.world", "mov3d.in"), "Linear2D": ("linear2d.world", "mov2d.in"),
          "Linear1D": ("linear1d.world", "mov1d.in")}
RUNNER_FRAMES = 20


def _cpu_simulation(name):
    world_file, command_file = WORLDS[name]
    cfg = Config()
    cfg.set_model_defaults(name)
    with open(f"assets/{command_file}") as f:
        commands = parse_commands(f.read())[:RUNNER_FRAMES]
    sim = Simulation(cfg, World.from_file(f"assets/{world_file}"), commands, algorithm="odometry",
                     dtype=torch.float32, seed=3, device="cpu")
    return sim, commands


@pytest.mark.parametrize("name", list(WORLDS))
def test_frame_runner_cpu_route_equals_update_then_measure(name):
    """Over 20 frames of the model's asset world, the runner's CPU route hands
    out update's pose and reading and measure's five outputs bit for bit,
    from its own staged reading (equal to Simulation._tensor of the command);
    what it handed out for frame t still equals its copy after later frames."""
    sim, commands = _cpu_simulation(name)
    model, params, odo = sim.model, sim.vparams, sim.model.pose.odo_dim
    runner = vehicle.FrameRunner(model, params, sim.vstate, sim.draws.frame(0), sim.max_clutter)
    assert runner.graph is None and not runner.cuda
    state, pose, handed = sim.vstate, sim.vstate.pose, []
    for i, cmd in enumerate(commands):
        draws = sim.draws.frame(i)
        reading = sim._tensor(cmd[:odo])
        state, noisy = vehicle.update(model, params, state, reading, draws["odo_normals"])
        want = (state.pose, noisy) + vehicle.measure(
            model, params, state, draws["detect_u"], draws["meas_normals"], draws["clutter_draw"],
            draws["clutter_u"], sim.max_clutter)
        got = runner(pose, cmd[:odo], draws)
        assert torch.equal(runner.reading, reading)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        pose = got[0]
        handed.append((got, [t.clone() for t in got]))
    for got, copies in handed:
        assert all(torch.equal(g, c) for g, c in zip(got, copies))
