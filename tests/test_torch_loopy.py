"""The port's smoother (monorfs_tpu_torch/slam/loopy.py) against
monorfs_tpu.slam.loopy, function by function, on a 12-node Linear2D problem
(tests/torch_parity.loopy_problem) at a test size
(torch_parity.loopy_configs); tests/test_torch_loopy3d.py runs the same
tests on an 8-node PRM3D problem. The port runs with kernels=False: the
inner filter with the XLA path's semantics and the plain beam, as the JAX
package runs on a CPU.

Both packages get the same inputs: the JAX navigator's and the port's
navigator's odometry, measurements, parameters and initial state, built
from the same lists (torch_parity.LoopyCase). Tolerance: float64 1e-8 (the
same arithmetic in other orders); float32 rtol 1e-3 / atol 5e-3 on poses,
messages and maps (a line-search candidate that wins by less than
float32's resolution in one package can lose in the other, moving a pose by
a fraction of the step) and 5e-3 relative on the objective terms (sums of
~100 set log-likelihoods). Maps are compared as component sets."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.slam import loopy as jloopy
from monorfs_tpu.slam.loopynav import LoopyPHDNavigator as JNavigator

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm import mixture as tmixture
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.slam import loopy
from monorfs_tpu_torch.slam.loopynav import LoopyPHDNavigator

from torch_parity import (FollowJaxPrune, LoopyCase, loopy_close, loopy_configs, loopy_problem,
                          maps_close, state_close)

CASES = [("Linear2D", 12, "float64"), ("Linear2D", 12, "float32")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def case(request):
    return LoopyCase(*request.param)


def test_loopy_state_conversion(case):
    """convert.loopy_state carries every field across unchanged: node_mask as
    bool, the rest cast to the requested dtype; and the JAX init_state equals the
    port's on the same trajectory."""
    want = case.jmapped
    got = case.port_state(want)
    assert got._fields == want._fields
    dtype = getattr(torch, case.dtype)
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == (torch.bool if name == "node_mask" else dtype), name
        assert a.device.type == "cpu" and tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype), err_msg=name)
    init = loopy.init_state(case.tm, case.tcfg, torch.as_tensor(case.jtraj, dtype=dtype), case.frames,
                            dtype, device="cpu")
    state_close(init, case.jstate, case.dtype)


def test_sequential_refit(case):
    traj = loopy.make_sequential_refit(case.tm, case.tcfg)(*case.targs)
    loopy_close(traj, case.jtraj, case.dtype)
    # the refit moved the jittered estimate
    assert np.abs(case.jtraj - np.asarray(case.jargs[1])).max() > 1e-3


def test_reversed_refit(case, monkeypatch):
    """The refit over the reversed trajectory, the inner filters' cut in
    JAX's order (torch_parity.FollowJaxPrune)."""
    follow = FollowJaxPrune(case.jcfg.inner.max_components, case.dtype)
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", follow.jax_top_k)
        want = case.jtraj_back()
    jax.effects_barrier()
    assert len(follow.frames) == case.frames
    monkeypatch.setattr(tmixture, "topk_stable", follow.port_topk)
    traj = case.tnav._reversed_refit(*case.targs)
    assert not follow.frames
    loopy_close(traj, want, case.dtype)


def test_map_sweep_and_fit_map_message(case):
    t = case.tnav
    st = case.port_state(case.jstate)
    got = loopy.map_sweep(case.tm, case.tcfg, t.params, st, t.z, t.z_mask,
                          torch.zeros((), dtype=t.dtype), t.grad_clip, t.grad_rate)
    state_close(got, case.jmapped, case.dtype)
    assert (np.asarray(case.jmapped.map_logw)[:, :-1] > -1e29).sum() >= case.jstate.lp.shape[0]


def test_forward_backward_sweeps(case):
    t = case.tnav
    fwd = loopy.forward_sweep(case.tm, case.port_state(case.jmapped), t.odometry, t.motion_cov)
    state_close(fwd, case.jfwd, case.dtype)
    back = loopy.backward_sweep(case.tm, case.port_state(case.jfwd), t.odometry, t.motion_cov)
    state_close(back, case.jback, case.dtype)


def test_relinearize_gauge_refuse(case):
    st, jm = case.port_state(case.jback), case.jm
    want = jax.jit(lambda s: (jloopy.relinearize(jm, s), jloopy.gauge_fix_shear(s),
                              jloopy.refuse_map(jm, s), jloopy.fused_trajectory(jm, s)))(case.jback)
    state_close(loopy.relinearize(case.tm, st), want[0], case.dtype)
    state_close(loopy.gauge_fix_shear(st), want[1], case.dtype)
    state_close(loopy.refuse_map(case.tm, st), want[2], case.dtype)
    loopy_close(loopy.fused_trajectory(case.tm, st), want[3], case.dtype)


def check_objective(case, jstate):
    want = case.jobjective(jstate)
    chain, meas = case.tnav._objective(case.port_state(jstate))
    rtol = 1e-8 if case.dtype == "float64" else 5e-3
    np.testing.assert_allclose([float(chain), float(meas)], want, rtol=rtol, atol=rtol)
    assert np.isfinite(want).all()


def check_final_map(case, jstate):
    t = case.tnav
    jfinal, jhist = case.jfinal_map(jstate)
    final, hist = loopy.final_map(case.tm, case.tcfg, t.params, case.port_state(jstate), t.z,
                                  t.z_mask, history=True)
    maps_close(final, jfinal, case.dtype)
    maps_close(hist, jhist, case.dtype)
    assert (np.asarray(jfinal.logw) > -1e29).sum() >= 3


def test_trajectory_objective(case):
    check_objective(case, case.jback)


def test_final_map_history(case):
    check_final_map(case, case.jback)


@pytest.mark.parametrize("contiguous", [False, True])
def test_cavity_and_causal_maps(contiguous):
    """All B passes as one mapping run of B particles with a [B, M] mask,
    against the JAX vmap of single passes; cavity_map_block alone; the
    causal maps (Linear2D, float64)."""
    jm, jc, truth, readings, meas, est = loopy_problem("Linear2D", 12)
    max_meas = max(len(zs) for zs in meas)
    jcfg, tcfg = loopy_configs(12, max_meas)
    jnav = JNavigator(jm, jc, est, readings, meas, max_meas=max_meas, dtype=np.float64, loopy_cfg=jcfg)
    tnav = LoopyPHDNavigator(tget("Linear2D"), convert.config(dataclasses.asdict(jc)), est, readings,
                             meas, max_meas=max_meas, dtype=torch.float64, loopy_cfg=tcfg, device="cpu")
    node_mask = np.arange(12) < 11  # a padded last node: skipped whole
    jposes, tposes = jnp.asarray(truth), torch.tensor(truth)
    want = jloopy.cavity_maps(jm, jcfg, jnav.params, jposes, jnav.z, jnav.z_mask,
                              jnp.asarray(node_mask), contiguous=contiguous)
    got = loopy.cavity_maps(tnav.model, tcfg, tnav.params, tposes, tnav.z, tnav.z_mask,
                            torch.tensor(node_mask), contiguous=contiguous)
    for g, w in zip(got, want):
        loopy_close(g.double() if g.dtype != torch.bool else g, w, "float64")
    one = loopy.cavity_map_block(tnav.model, tcfg, tnav.params, tposes, tnav.z, tnav.z_mask, 2,
                                 torch.tensor(node_mask), contiguous=contiguous)
    for g, w in zip(one, want):
        loopy_close(g.double() if g.dtype != torch.bool else g, np.asarray(w)[2], "float64")
    assert np.asarray(want[2]).sum() >= 4
    if not contiguous:
        want = jloopy.causal_maps(jm, jcfg, jnav.params, jposes, jnav.z, jnav.z_mask, jnp.asarray(node_mask))
        got = loopy.causal_maps(tnav.model, tcfg, tnav.params, tposes, tnav.z, tnav.z_mask,
                                torch.tensor(node_mask))
        for g, w in zip(got, want):
            loopy_close(g.double() if g.dtype != torch.bool else g, w, "float64")


def test_message_algebra():
    rng = np.random.default_rng(2)
    a_m, b_m = rng.normal(size=(2, 5, 6))
    ca, cb = rng.normal(size=(2, 5, 6, 6)) * 0.3
    a_c = ca @ ca.transpose(0, 2, 1) + 0.5 * np.eye(6)
    b_c = cb @ cb.transpose(0, 2, 1) + 0.7 * np.eye(6)
    t = torch.tensor
    f_m, f_c = loopy._fuse(t(a_m), t(a_c), t(b_m), t(b_c))
    jf_m, jf_c = jloopy._fuse(*map(jnp.asarray, (a_m, a_c, b_m, b_c)))
    loopy_close(f_m, jf_m, "float64")
    loopy_close(f_c, jf_c, "float64")
    u_m, u_c = loopy._unfuse(f_m, f_c, t(b_m), t(b_c))  # round trip
    loopy_close(u_m, a_m, "float64")
    loopy_close(u_c, a_c, "float64")
    # an indefinite division falls back to the uninformative prior
    bad_m, bad_c = loopy._unfuse(t(b_m), t(b_c), t(a_m), t(a_c) * 1e-3)
    jbad = jloopy._unfuse(*map(jnp.asarray, (b_m, b_c, a_m, a_c * 1e-3)))
    loopy_close(bad_m, jbad[0], "float64")
    loopy_close(bad_c, jbad[1], "float64")
    # a Gaussian fused with a (const + 3 components, one dead) mixture
    m_mean = rng.normal(size=(5, 3, 6))
    m_cov = np.broadcast_to(np.eye(6) * 0.4, (5, 3, 6, 6)).copy()
    m_logw = rng.normal(size=(5, 3))
    m_logw[:, 1] = -1e30
    m_const = rng.normal(size=5)
    got = loopy.fuse_with_mixture(t(a_m), t(a_c), t(m_const), t(m_mean), t(m_cov), t(m_logw))
    want = jloopy.fuse_with_mixture(*map(jnp.asarray, (a_m, a_c, m_const, m_mean, m_cov, m_logw)))
    for g, w in zip(got, want):
        loopy_close(g, w, "float64")


@pytest.mark.parametrize("kernels", [None, False])
def test_kernel_routing(monkeypatch, kernels):
    """float32 with kernels=None (the default, as on the card): every inner
    mapping frame goes through the fused stage's wrapper -- once a node in
    the refit, once a frame of each score's cavity run (all blocks in one
    call, a [B, M] mask) and of the final map -- and the value-only
    likelihoods through the beam kernel's wrapper, never with a gradient;
    kernels=False takes neither."""
    from monorfs_tpu_torch.slam import beam_kernel, fused_kernel

    calls = {"fused": [], "beam": []}
    fused, beam = fused_kernel.fused_stage, beam_kernel.beam_scan_batch

    def fused_spy(model, cfg, params, pose, maps, z, z_mask, *a, **k):
        calls["fused"].append(tuple(z_mask.shape))
        return fused(model, cfg, params, pose, maps, z, z_mask, *a, **k)

    def beam_spy(base, od, *a):
        assert not od.requires_grad
        calls["beam"].append(od.shape[0])
        return beam(base, od, *a)

    monkeypatch.setattr(fused_kernel, "fused_stage", fused_spy)
    monkeypatch.setattr(beam_kernel, "beam_scan_batch", beam_spy)
    jm, jc, truth, readings, meas, est = loopy_problem("Linear2D", 6)
    max_meas = max(len(zs) for zs in meas)
    tcfg = dataclasses.replace(loopy_configs(6, max_meas)[1], kernels=kernels)
    nav = LoopyPHDNavigator(tget("Linear2D"), convert.config(dataclasses.asdict(jc)), est, readings,
                            meas, max_meas=max_meas, dtype=torch.float32, loopy_cfg=tcfg, device="cpu")
    nav.sweep()
    nav.map_history()
    if kernels is False:
        assert calls == {"fused": [], "beam": []}
        return
    m, b = max_meas, tcfg.blocks
    # score of the initial state, refit, score of the refitted state, final map
    assert calls["fused"] == [(b, m)] * 6 + [(m,)] * 6 + [(b, m)] * 6 + [(m,)] * 6
    # a refitted node: its seeds, its guesses' start values, one fan an iteration; then 2 scores
    assert len(calls["beam"]) == 5 * (2 + tcfg.ga_iters) + 2
    assert 6 in calls["beam"] and max(calls["beam"]) == tcfg.jmap_cap * max_meas
