"""The port's block-sharded smoother sweep (monorfs_tpu_torch/parallel/
chain.py) on N gloo ranks (tests/torch_dist_runner.py), on the 12-node
Linear2D problem of the smoother tests (torch_parity.loopy_problem at
torch_parity.loopy_configs' test size, refit off so that the first sweep is
the causal one), float64, two sweeps (causal at temperature 5, then cavity
at 2.5, as LoopyPHDNavigator schedules them):

  * N=1 against the port's sequential sweep (loopy.make_sweep, then
    loopy.relinearize) to 1e-9: the halo is the block's own wrapped end;
  * N=2 and N=4 against monorfs_tpu.parallel.chain.make_sharded_sweep on as
    many virtual devices, to 1e-8 (the smoother tests' float64 tolerance):
    block-Jacobi staleness at the same boundaries in both packages."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.parallel import chain as jchain
from monorfs_tpu.slam.loopynav import LoopyPHDNavigator as JNavigator

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.slam import loopy

import torch_dist_runner
from torch_dist_runner import run_ranks

one_thread = pytest.fixture(autouse=True, scope="module")(torch_dist_runner.one_thread)
from torch_parity import fields, loopy_configs, loopy_problem

FRAMES = 12
SCHEDULE = [(True, 5.0), (False, 2.5)]
FIELDS = ("fused_mean", "fused_cov", "past_mean", "past_cov", "future_mean", "future_cov",
          "map_mean", "map_cov", "map_logw", "lp")


@pytest.fixture(scope="module")
def case():
    jm, jc, truth, readings, meas, est = loopy_problem("Linear2D", FRAMES)
    max_meas = max(len(zs) for zs in meas)
    jcfg, tcfg = loopy_configs(FRAMES, max_meas, refit=False)
    jnav = JNavigator(jm, jc, est, readings, meas, max_meas=max_meas, dtype=np.float64,
                      loopy_cfg=jcfg)
    state = convert.loopy_state(fields(jnav.state), dtype=torch.float64, device="cpu")
    params = {k: np.asarray(v) for k, v in jnav.params._asdict().items()}
    arrays = {"state_" + k: v.numpy() for k, v in state._asdict().items()}
    arrays.update({"params__" + k: v for k, v in params.items()})
    arrays.update(odometry=np.asarray(jnav.odometry), z=np.asarray(jnav.z),
                  z_mask=np.asarray(jnav.z_mask), grad_clip=np.asarray(jnav.grad_clip),
                  grad_rate=np.asarray(jnav.grad_rate), motion_cov=np.asarray(jnav.motion_cov))
    spec = dict(case="chain", model="Linear2D", dtype="float64", lcfg=dataclasses.asdict(tcfg),
                schedule=SCHEDULE)
    return dict(jm=jm, jcfg=jcfg, tcfg=tcfg, jnav=jnav, state=state, arrays=arrays, spec=spec,
                params=convert.phd_params(params, dtype=torch.float64, device="cpu"))


def _sequential(case):
    a, tm, cfg = case["arrays"], tget("Linear2D"), case["tcfg"]
    t = lambda k: torch.as_tensor(a[k])
    st = case["state"]
    for causal, temperature in SCHEDULE:
        st = loopy.make_sweep(tm, cfg, causal=causal)(
            case["params"], st, t("odometry"), t("z"), t("z_mask"),
            torch.tensor(temperature, dtype=torch.float64), t("grad_clip"), t("grad_rate"),
            t("motion_cov"))
        if cfg.relinearize:
            st = loopy.relinearize(tm, st)
    return st


def _jax_sharded(case, n):
    j = case["jnav"]
    mesh = jchain.make_chain_mesh(n)
    st, odo, z, zm = jchain.shard_loopy_inputs(mesh, j.state, j.odometry, j.z, j.z_mask)
    sweeps = {c: jchain.make_sharded_sweep(case["jm"], case["jcfg"], mesh, causal=c)
              for c in (False, True)}
    for causal, temperature in SCHEDULE:
        st = sweeps[causal](j.params, st, odo, z, zm, jnp.asarray(temperature, jnp.float64),
                            j.grad_clip, j.grad_rate, j.motion_cov)
    return st


def test_sharded_sweep_n1_matches_sequential(tmp_path, case):
    got = run_ranks(tmp_path, case["spec"], case["arrays"], 1)[0]
    want = _sequential(case)
    for name in FIELDS:
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=name)
    # the sweeps moved the linearisation points (relinearize zeroes fused_mean)
    assert np.abs(got["lp"] - case["arrays"]["state_lp"]).max() > 1e-4
    comm = json.loads(str(got["comm"]))
    assert "halo" not in comm  # no halo leaves a world of one
    assert comm["all_gather"][0] > 0 and comm["psum"][0] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sweep_matches_jax(tmp_path, case, world):
    outs = run_ranks(tmp_path, case["spec"], case["arrays"], world)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["fused_mean"], outs[0]["fused_mean"])
    want = _jax_sharded(case, world)
    for name in FIELDS:
        np.testing.assert_allclose(outs[0][name], np.asarray(getattr(want, name)), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    comm = json.loads(str(outs[0]["comm"]))
    # two sweeps: fused mean + cov, lp, future mean + cov, odometry from the
    # previous rank; fused mean + cov, lp, past mean + cov from the next
    assert comm["halo"][0] == 2 * 11
