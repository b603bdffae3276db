"""The port's particle-sharded PHD step (monorfs_tpu_torch/parallel/mesh.py)
on N gloo ranks (tests/torch_dist_runner.py), against the port's
single-card step and the JAX package's sharded step on the 8 virtual CPU
devices of conftest.

Linear2D, float64, the fixture of tests/test_parallel.py (P=16), three steps
in a row with JAX's key-derived draws (kmotion, kresample = split(sub), as
tests/test_torch_phd_step.py derives them): poses rtol 1e-12, log-weights
and map weights rtol 1e-10, best and ancestors equal; with the default
ESS threshold (no resampling) and with 0.95 (resampling).
Then the PRM3D bench shapes in float32 (P=200, K=128, M=24 compacted to
the beam's 24) at N=2 against the single-card step: poses atol 1e-5,
log-weights atol 2e-3, ancestors equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu import models as jmodels
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.parallel import make_mesh as jmake_mesh
from monorfs_tpu.parallel import make_sharded_step as jmake_sharded_step
from monorfs_tpu.parallel import shard_state as jshard_state
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.parallel import mesh as pmesh
from monorfs_tpu_torch.parallel import multihost
from monorfs_tpu_torch.slam import phd

import torch_dist_runner
from torch_dist_runner import HERE, run_ranks

one_thread = pytest.fixture(autouse=True, scope="module")(torch_dist_runner.one_thread)

LINEAR2D = dict(num_particles=16, max_components=16, max_measurements=4, gate_top=4,
                estimate_cap=8, beam_width=16)
PRM3D = dict(num_particles=200, max_components=128, max_measurements=24, gate_top=8,
             estimate_cap=48, beam_width=32, beam_meas_cap=24, beam_candidates=6, merge_rounds=4)
STEPS = 3


def linear2d_case(min_eff=None, steps=STEPS):
    """(JAX params, spec, arrays) of the Linear2D fixture: the JAX key
    chain's draws for `steps` frames, odometry [0.1, 0] * (i + 1)."""
    jc = JConfig()
    jc.set_linear2d_defaults()
    if min_eff is not None:
        jc.min_effective_particle = min_eff
    jparams = jc.phd_params(np.float64)
    z = np.asarray([[0.5, 0.5], [1.0, -0.5], [0, 0], [0, 0]], np.float64)
    zmask = np.asarray([True, True, False, False])
    key, keys, normals, u = jax.random.PRNGKey(7), [], [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        kmotion, kresample = jax.random.split(sub)
        keys.append(sub)
        normals.append(np.asarray(jax.random.normal(kmotion, (16, 2), jnp.float64)))
        u.append(np.asarray(jax.random.uniform(kresample, (), jnp.float64)))
    arrays = dict(pose0=np.zeros(2), odo=np.asarray([[0.1, 0.0]]) * np.arange(1, steps + 1)[:, None],
                  z=np.stack([z] * steps), zmask=np.stack([zmask] * steps),
                  normals=np.stack(normals), u=np.asarray(u))
    arrays.update({"params__" + k: np.asarray(v) for k, v in jparams._asdict().items()})
    spec = dict(case="phd", model="Linear2D", dtype="float64", pcfg=LINEAR2D, steps=steps)
    return jparams, keys, spec, arrays


def prm3d_case(steps=STEPS):
    """The bench shapes of tests/multihost_runner.py's prm3d case: 12 of 24
    slots live, numpy draws from seed 3."""
    rng = np.random.default_rng(3)
    z = np.zeros((24, 3), np.float32)
    z[:12] = rng.uniform(-1, 1, (12, 3)) * [80, 60, 0.6] + [0, 0, 1.0]
    jparams = JConfig().phd_params(np.float32)
    arrays = dict(pose0=np.array([0, 0, 0, 1, 0, 0, 0.0]),
                  odo=np.asarray([[0.02, 0, 0, 0, 0, 0.01]], np.float32) * np.arange(1, steps + 1)[:, None],
                  z=np.stack([z] * steps), zmask=np.stack([np.arange(24) < 12] * steps),
                  normals=rng.normal(size=(steps, 200, 6)).astype(np.float32),
                  u=rng.uniform(size=steps).astype(np.float32))
    arrays.update({"params__" + k: np.asarray(v) for k, v in jparams._asdict().items()})
    spec = dict(case="phd", model="PRM3D", dtype="float32", pcfg=PRM3D, steps=steps)
    return spec, arrays


def single_card(spec, arrays):
    """The port's single-card step over the same inputs: per-step poses,
    log-weights, best and ancestors, and the final maps."""
    dtype = getattr(torch, spec["dtype"])
    model, pcfg = tget(spec["model"]), phd.PHDConfig(**spec["pcfg"])
    params = convert.phd_params({k[8:]: v for k, v in arrays.items() if k.startswith("params__")},
                                dtype=dtype, device="cpu")
    state = phd.init_state(model, pcfg, arrays["pose0"], dtype, "cpu")
    step = phd.make_slam_step(model, pcfg)
    t = lambda x: torch.as_tensor(x)
    out = {"pose": [], "logweight": [], "best": [], "ancestor": []}
    for i in range(spec["steps"]):
        state = step(params, state, t(arrays["odo"][i]).to(dtype), t(arrays["z"][i]).to(dtype),
                     t(arrays["zmask"][i]), t(arrays["normals"][i]).to(dtype),
                     t(arrays["u"][i]).to(dtype))
        for k in out:
            out[k].append(getattr(state, k).numpy())
    return {k: np.stack(v) for k, v in out.items()}, state


def _same_ranks(outs):
    for o in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("min_eff", [None, 0.95], ids=["no-resample", "resample"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_step_matches_single_card(tmp_path, world, min_eff):
    _, _, spec, arrays = linear2d_case(min_eff)
    outs = run_ranks(tmp_path, spec, arrays, world)
    _same_ranks(outs)
    got = outs[0]
    want, final = single_card(spec, arrays)
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=1e-12)
    np.testing.assert_allclose(got["logweight"], want["logweight"], rtol=1e-10)
    np.testing.assert_allclose(got["maps_logw"], final.maps.logw.numpy(), rtol=1e-10)
    np.testing.assert_array_equal(got["best"], want["best"])
    np.testing.assert_array_equal(got["ancestor"], want["ancestor"])
    # a resampling of near-equal weights may draw every slot from itself
    resampled = (want["ancestor"] != np.arange(16)).any(axis=1)
    assert resampled.any() if min_eff else not resampled.any()


def test_sharded_step_matches_jax_sharded(tmp_path):
    """Four gloo ranks against monorfs_tpu.parallel.make_sharded_step on the
    8-device virtual mesh, three steps on the same key chain."""
    jparams, keys, spec, arrays = linear2d_case()
    model, pcfg = jmodels.get("Linear2D"), jphd.PHDConfig(**LINEAR2D)
    mesh = jmake_mesh()
    assert mesh.shape["particles"] == 8
    state = jshard_state(jphd.init_state(model, pcfg, np.zeros(2), jnp.float64), mesh)
    step = jmake_sharded_step(model, pcfg, mesh, slam=True)
    poses, logweights, best = [], [], []
    for i, sub in enumerate(keys):
        state = step(jparams, state, jnp.asarray(arrays["odo"][i]), jnp.asarray(arrays["z"][i]),
                     jnp.asarray(arrays["zmask"][i]), sub)
        poses.append(np.asarray(state.pose))
        logweights.append(np.asarray(state.logweight))
        best.append(int(state.best))
    got = run_ranks(tmp_path, spec, arrays, 4)[0]
    np.testing.assert_allclose(got["pose"], np.stack(poses), rtol=1e-12)
    np.testing.assert_allclose(got["logweight"], np.stack(logweights), rtol=1e-10)
    np.testing.assert_allclose(got["maps_logw"], np.asarray(state.maps.logw), rtol=1e-10)
    np.testing.assert_array_equal(got["best"], best)


def test_prm3d_bench_shapes_two_ranks(tmp_path):
    spec, arrays = prm3d_case()
    outs = run_ranks(tmp_path, spec, arrays, 2)
    _same_ranks(outs)
    want, _ = single_card(spec, arrays)
    np.testing.assert_allclose(outs[0]["pose"], want["pose"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[0]["logweight"], want["logweight"], rtol=0, atol=2e-3)
    np.testing.assert_array_equal(outs[0]["ancestor"], want["ancestor"])
    assert np.isfinite(outs[0]["maps_mx"]).all() and (outs[0]["maps_logw"] > -1e29).any()


def test_shard_state_and_errors():
    """shard_state / local_rows on a stand-in mesh of 4 (no process group
    needed), and the errors: an axis that does not split, a step given the
    whole state, a mesh without torch.distributed."""
    model, pcfg = tget("Linear2D"), phd.PHDConfig(**LINEAR2D)
    whole = phd.init_state(model, pcfg, np.zeros(2), torch.float64, "cpu")
    whole = whole._replace(logweight=torch.arange(16, dtype=torch.float64))
    m = pmesh.Mesh(None, 4, 2, torch.device("cpu"))
    part = pmesh.shard_state(whole, m)
    assert part.pose.shape == (4, 2) and part.logweight.tolist() == [8, 9, 10, 11]
    assert part.maps.logw.shape == (4, 16) and part.ancestor.tolist() == [8, 9, 10, 11]
    with pytest.raises(ValueError, match="split"):
        pmesh.local_rows(m, 10)
    step = pmesh.make_sharded_step(model, pcfg, m)
    with pytest.raises(ValueError, match="shard"):
        step(None, whole, None, None, None, None, None)
    with pytest.raises(RuntimeError, match="initialise"):
        pmesh.make_mesh(device="cpu")


def test_bench_flagship_two_ranks_with_scaling():
    """bench_flagship at a small size on two gloo ranks with --scaling: the
    three lines, from rank 0 only, with the world of two and a ratio."""
    init = f"tcp://localhost:{multihost.free_port()}"
    argv = [sys.executable, "-m", "monorfs_tpu_torch.bench_flagship", "--particles", "16",
            "--landmarks", "32", "--poses", "4", "--steps", "1", "--device", "cpu", "--world", "2",
            "--init", init, "--scaling", "--rank"]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(argv + [str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=HERE.parent, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    assert outs[1][0].strip() == ""
    lines = [json.loads(ln) for ln in outs[0][0].strip().splitlines()]
    assert [ln["metric"] for ln in lines] == ["sharded PHD step", "distributed Schur BA",
                                              "strong-scaling efficiency"]
    assert all(ln["world"] == 2 and ln["card"] is None and ln["device"] == "cpu" for ln in lines)
    assert lines[0]["step_s"] > 0 and lines[1]["gn_iter_s"] > 0
    assert lines[2]["phd_efficiency"] > 0 and lines[2]["ba_efficiency"] > 0


def test_comm_volume_two_ranks(capsys):
    """tools/comm_volume on two gloo ranks: the chain's halos and gathers and
    the BA's one psum of (T O)^2 + T O floats, whatever the landmarks."""
    from monorfs_tpu_torch.tools import comm_volume

    assert comm_volume.main(["--ranks", "2", "--device", "cpu"]) == 0
    counts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["counts"]
    to = 64 * 6
    assert counts["ba"] == {"psum": [1, (to * to + to) * 4]}
    assert counts["chain"]["halo"][0] == 11 and counts["chain"]["all_gather"][0] == 8
    assert set(counts["phd"]) == {"pmax", "psum", "all_gather"}
