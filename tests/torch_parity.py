"""Shared helpers of the tests/test_torch_*.py parity tests: the same numpy
inputs go through monorfs_tpu (the reference, JAX on the CPU) and
monorfs_tpu_torch (device='cpu', the plain PyTorch paths)."""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.gm import mixture as jmixture
from monorfs_tpu.slam import loopy as jloopy
from monorfs_tpu.slam.loopynav import LoopyPHDNavigator as JNavigator

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm import mixture as tmixture
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.slam.loopynav import LoopyPHDNavigator

DEAD = -1.0e30


def np_(x):
    return np.asarray(x)


def t32(x):
    return torch.tensor(np.array(x), dtype=torch.float32)


def sgm_to_torch(sgm):
    return SGM(*[t32(leaf) for leaf in sgm])


def params_pair(cfg=None):
    """(JAX PHDParams float32, torch PHDParams float32 on the CPU)."""
    jp = (cfg or JConfig()).phd_params(jnp.float32)
    tp = convert.phd_params({k: np_(v) for k, v in jp._asdict().items()}, device="cpu")
    return jp, tp


def random_state(jmodel, k0, m, seed, p, n_lm=12, dtype=jnp.float32):
    """A warm random filter state (landmark-like components + noise), the
    construction of tests/test_fused_pallas.py::_random_state."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-0.8, 0.8, (n_lm, 3))
    lm[:, 2] = rng.uniform(0.4, 1.6, n_lm)
    mean = np.zeros((p, k0, 3))
    logw = np.full((p, k0), DEAD)
    cov = np.tile(np.eye(3) * 0.02, (p, k0, 1, 1))
    for i in range(p):
        idx = rng.permutation(k0)[:n_lm]
        mean[i, idx] = lm + rng.normal(0, 0.03, lm.shape)
        logw[i, idx] = rng.uniform(-1.2, 0.4, n_lm)
    gm = jmixture.GM(jnp.asarray(mean, dtype), jnp.asarray(cov, dtype), jnp.asarray(logw, dtype))
    maps = jmixture.soa_of(gm)
    pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0.0]), (p, 1))
    pose[:, :3] += rng.normal(0, 0.02, (p, 3))
    pose = jnp.asarray(pose, dtype)
    z = np.zeros((m, 3))
    n_live = min(n_lm, m - 2)
    zs = np.asarray(jmodel.measure(jmodel.params, pose[0][None, :], jnp.asarray(lm)))
    z[:n_live] = zs[:n_live] + rng.normal(0, 1.0, (n_live, 3)) * np.array([2.0, 2.0, 0.01])
    z[n_live] = [5.0, -10.0, 1.2]  # clutter
    z_mask = np.arange(m) < n_live + 1
    return pose, maps, jnp.asarray(z, dtype), jnp.asarray(z_mask)


def component_sets(sgm, p):
    """Per-particle alive components sorted by log-weight, descending."""
    leaves = [np_(leaf) for leaf in sgm]
    logw = leaves[9]
    mean = np.stack(leaves[0:3], axis=-1)
    cov6 = np.stack(leaves[3:9], axis=-1)
    out = []
    for i in range(p):
        al = logw[i] > -0.25e30
        order = np.argsort(-logw[i][al], kind="stable")
        out.append((logw[i][al][order], mean[i][al][order], cov6[i][al][order]))
    return out


def assert_sets_close(ref, got, p):
    """The fused-stage tolerances of tests/test_fused_pallas.py: same count,
    log-weights and means to 1e-4, covariances rtol 1e-3 / atol 1e-5;
    equal-weight components are paired greedily by mean distance."""
    for i, ((lw_r, mu_r, c_r), (lw_k, mu_k, c_k)) in enumerate(
        zip(component_sets(ref, p), component_sets(got, p))
    ):
        assert len(lw_r) == len(lw_k), (i, len(lw_r), len(lw_k))
        np.testing.assert_allclose(lw_k, lw_r, rtol=1e-4, atol=1e-4)
        used = np.zeros(len(lw_r), bool)
        for j in range(len(lw_k)):
            dist = np.linalg.norm(mu_r - mu_k[j], axis=-1) + np.where(used, 1e9, 0.0)
            jj = int(np.argmin(dist))
            used[jj] = True
            np.testing.assert_allclose(mu_k[j], mu_r[jj], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(c_k[j], c_r[jj], rtol=1e-3, atol=1e-5)


# -- graph backend ------------------------------------------------------------

def fields(named_tuple):
    """A JAX NamedTuple's fields as numpy, for monorfs_tpu_torch.convert."""
    return {k: np.asarray(v) for k, v in named_tuple._asdict().items()}


def graph_problem(name, n_poses=12, n_lm=8, seed=0, dtype=jnp.float64, duplicate=False):
    """A hand-built graph on model `name` (Linear2D or PRM3D): a noisy
    odometry chain, landmarks seen from ~70% of the poses, holes in the
    factor arrays and spare capacity everywhere. With `duplicate` one
    (pose, landmark) pair holds two factors. Returns (JAX model, JAX
    GraphConfig, JAX GraphState, motion_info, meas_info) with numpy
    informations."""
    from monorfs_tpu import models as jmodels
    from monorfs_tpu.geometry import pose3d as jpose3d
    from monorfs_tpu.slam import graph as jgraph

    rng = np.random.default_rng(seed)
    jm = jmodels.get(name)
    jcfg = jgraph.GraphConfig(max_poses=n_poses + 2, max_landmarks=n_lm + 2,
                              max_factors=(n_poses + 2) * n_lm)
    if name == "PRM3D":
        o, d = 6, 3
        poses = [np.array([0, 0, 0, 1, 0, 0, 0.0])]
        deltas = [rng.normal(size=6) * np.array([.03, .03, .03, .01, .01, .01])
                  for _ in range(n_poses - 1)]
        for dl in deltas:
            poses.append(np.asarray(jpose3d.add_odometry(jnp.asarray(poses[-1]), jnp.asarray(dl))))
        lms = np.column_stack([rng.uniform(-.3, .3, n_lm), rng.uniform(-.3, .3, n_lm),
                               rng.uniform(.8, 1.5, n_lm)])
        lm_noise = np.ones(3)
        meas_info = np.diag(1.0 / np.array([2.0, 2.0, 1e-3]))
    else:
        o, d = 2, 2
        poses = [np.zeros(2)]
        deltas = [np.array([.15, .02]) + rng.normal(size=2) * .01 for _ in range(n_poses - 1)]
        for dl in deltas:
            poses.append(poses[-1] + dl)
        lms = np.column_stack([rng.uniform(-1, 3, n_lm), rng.uniform(-1, 1, n_lm), np.zeros(n_lm)])
        lm_noise = np.array([1.0, 1.0, 0.0])
        meas_info = np.diag(np.full(2, 1.0 / 5e-4))
    motion_info = np.diag(np.full(o, 1e3))
    st = jgraph.empty_state(jm, jcfg, poses[0], jnp.float64)
    p, b, bm = np.array(st.poses), np.array(st.between), np.array(st.between_mask)
    for t in range(1, n_poses):
        p[t] = np.asarray(jm.pose.add(jnp.asarray(poses[t]), jnp.asarray(rng.normal(size=o) * .01)))
        b[t], bm[t] = deltas[t - 1], True
    lm, lmm = np.array(st.landmarks), np.array(st.lm_mask)
    lm[:n_lm] = lms + rng.normal(size=(n_lm, 3)) * .02 * lm_noise
    lmm[:n_lm] = True
    fp, fl, fz, fm = (np.array(x) for x in (st.f_pose, st.f_lm, st.f_z, st.f_mask))
    fi = 0
    for t in range(n_poses):
        for j in range(n_lm):
            if rng.random() < 0.7:
                z = np.asarray(jm.measure(jm.params, jnp.asarray(poses[t]), jnp.asarray(lms[j])))
                for _ in range(2 if duplicate and (t, j) == (3, 2) else 1):
                    fp[fi], fl[fi], fz[fi], fm[fi] = t, j, z + rng.normal(size=d) * 1e-3, True
                    fi += 1
                if rng.random() < 0.1:
                    fi += 1  # a hole
    st = jgraph.GraphState(
        jnp.asarray(p, dtype), jnp.int32(n_poses), jnp.asarray(lm, dtype), jnp.asarray(lmm),
        jnp.asarray(b, dtype), jnp.asarray(bm), st.pose_fixed, jnp.asarray(fp), jnp.asarray(fl),
        jnp.asarray(fz, dtype), jnp.asarray(fm),
    )
    return jm, jcfg, st, motion_info, meas_info


def jax_scan_draws(key, frames, n_landmarks, meas_dim, odo_dim, max_clutter, clutter_count, dtype):
    """The vehicle's draws as the JAX scan runners make them: the carry key
    split three ways per frame (isam2_scan.py:91), the measurement key four
    ways (sim/vehicle.py:67), stacked over frames for the port's runners."""
    import jax

    out = {k: [] for k in ("odo_normals", "detect_u", "meas_normals", "clutter_draw", "clutter_u")}
    for _ in range(frames):
        key, kupd, kmeas = jax.random.split(key, 3)
        kdetect, knoise, kcount, kclutter = jax.random.split(kmeas, 4)
        out["odo_normals"].append(np_(jax.random.normal(kupd, (odo_dim,), dtype)))
        out["detect_u"].append(np_(jax.random.uniform(key=kdetect, shape=(n_landmarks,))))
        out["meas_normals"].append(np_(jax.random.normal(knoise, (n_landmarks, meas_dim), dtype)))
        out["clutter_draw"].append(np_(jax.random.poisson(kcount, clutter_count)))
        out["clutter_u"].append(np_(jax.random.uniform(kclutter, (max_clutter, meas_dim))))
    return {k: torch.tensor(np.stack(v)) for k, v in out.items()}


# -- smoother -----------------------------------------------------------------

def loopy_problem(name, frames, seed=4):
    """A small smoothing problem on model `name` (Linear2D or PRM3D): the
    true path, odometry readings with noise, measurement lists (detections
    with noise, plus one clutter point a frame) and a jittered initial
    estimate. Returns (JAX model, JAX Config, truth, readings, measurements,
    estimate), as tests/test_loopy.py and tests/test_loopy3d.py build them."""
    from monorfs_tpu import models as jmodels

    rng = np.random.default_rng(seed)
    jm = jmodels.get(name)
    cfg = JConfig()
    if name == "PRM3D":
        cfg.motion_covariance = np.diag([4e-4] * 3 + [1e-4] * 3) / cfg.measure_elapsed ** 2
        lms = np.column_stack([rng.uniform(-0.5, 1.0, 10), rng.uniform(-0.5, 0.5, 10),
                               rng.uniform(0.8, 1.5, 10)])
        step = np.array([0.06, 0, 0, 0, 0, 0.0])
        link_std = np.concatenate([np.full(3, 0.02), np.full(3, 0.01)])
        truth = [np.array([0, 0, 0, 1, 0, 0, 0.0])]
        noise = np.array([1.0, 1.0, 0.01])
        jitter = np.concatenate([np.full(3, 0.05), np.full(3, 0.015)])
    else:
        cfg.set_linear2d_defaults()
        cfg.motion_covariance = np.diag([0.05 ** 2, 0.05 ** 2]) / cfg.measure_elapsed ** 2
        cfg.merge_threshold = 3.0
        cfg.min_weight = 0.01
        lms = np.column_stack([rng.uniform(-1.0, 2.5, 10), rng.uniform(-1.0, 1.5, 10), np.zeros(10)])
        step = np.array([0.12, 0.03])
        link_std = np.full(2, 0.05)
        truth = [np.zeros(2)]
        noise = np.full(2, 0.02)
        jitter = np.full(2, 0.06)
    readings = [np.zeros_like(step)]
    for _ in range(1, frames):
        truth.append(np.asarray(jm.pose.add_odometry(jnp.asarray(truth[-1]), jnp.asarray(step))))
        readings.append(step + rng.normal(size=step.shape) * link_std)
    measurements = []
    for t in range(frames):
        z = np.asarray(jm.measure(jm.params, jnp.asarray(truth[t])[None, :], jnp.asarray(lms)))
        vis = np.asarray(jm.visible(jm.params, jnp.asarray(z)))
        zs = [zi + rng.normal(size=zi.shape) * noise for zi, v in zip(z, vis) if v and rng.random() < 0.9]
        zs.append(zs[0] + rng.normal(size=zs[0].shape) * noise * 30 if zs else np.zeros(jm.meas_dim))
        measurements.append(zs)
    tang = rng.normal(size=(frames, step.size)) * jitter
    tang[0] = 0.0
    est = np.stack([np.asarray(jm.pose.add(jnp.asarray(p), jnp.asarray(d))) for p, d in zip(truth, tang)])
    return jm, cfg, np.array(truth), readings, measurements, est


def loopy_configs(frames, max_meas, **over):
    """(JAX LoopyConfig, port LoopyConfig) at a test size: 4 blocks, 8-slot
    jmaps and beams, 24-component inner maps, 2 x 2 gradient ascent."""
    from monorfs_tpu.slam import phd as jphd
    from monorfs_tpu_torch.slam import loopy as tloopy
    from monorfs_tpu_torch.slam import phd as tphd

    inner = dict(num_particles=1, max_components=24, max_measurements=max_meas, gate_top=4,
                 estimate_cap=8, beam_width=8)
    kw = dict(max_nodes=frames, max_meas=max_meas, mix_cap=4, blocks=4, ga_iters=2, ga_steps=2,
              jmap_cap=8, beam_width=8, refit_seeds=2, **over)
    return (jloopy.LoopyConfig(inner=jphd.PHDConfig(**inner), **kw),
            tloopy.LoopyConfig(inner=tphd.PHDConfig(**inner), kernels=False, **kw))


def _tol(dtype):
    """The smoother tests' tolerances (see tests/test_torch_loopy.py)."""
    return dict(rtol=1e-8, atol=1e-8) if dtype == "float64" else dict(rtol=1e-3, atol=5e-3)


def loopy_close(got, want, dtype, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **_tol(dtype))


def state_close(got, want, dtype):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if name == "node_mask":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            loopy_close(a, b, dtype, name)


def maps_close(got, want, dtype):
    """The same live components frame by frame, as sets: equal-weight
    components may sit in other slots (float32 merge order)."""
    k = got.logw.shape[-1]
    lw, mu, cv = (x.numpy().reshape((-1, k) + x.shape[got.logw.dim():]) for x in (got.logw, got.mean, got.cov))
    wl, wm, wc = (np.asarray(x).reshape(y.shape) for x, y in zip((want.logw, want.mean, want.cov), (lw, mu, cv)))
    for f in range(lw.shape[0]):
        a, b = lw[f] > -1e29, wl[f] > -1e29
        assert a.sum() == b.sum(), (f, a.sum(), b.sum())
        loopy_close(np.sort(lw[f][a]), np.sort(wl[f][b]), dtype, "logw")
        used = np.zeros(b.sum(), bool)
        for m, c in zip(mu[f][a], cv[f][a]):
            j = int(np.argmin(np.linalg.norm(wm[f][b] - m, axis=-1) + np.where(used, 1e9, 0.0)))
            used[j] = True
            loopy_close(m, wm[f][b][j], dtype, "mean")
            loopy_close(c, wc[f][b][j], dtype, "cov")


class LoopyCase:
    """Both packages' navigators over the same smoothing problem, and the
    JAX results of every function the smoother tests compare, each computed
    (and compiled) when first asked for."""

    def __init__(self, name, frames, dtype):
        jm, jc, self.truth, readings, meas, est = loopy_problem(name, frames)
        self.name, self.dtype, self.jm, self.tm = name, dtype, jm, tget(name)
        max_meas = max(len(zs) for zs in meas)
        jcfg, tcfg = loopy_configs(frames, max_meas)
        npd, tpd = getattr(np, dtype), getattr(torch, dtype)
        self.jnav = JNavigator(jm, jc, est, readings, meas, max_meas=max_meas, dtype=npd, loopy_cfg=jcfg)
        self.tnav = LoopyPHDNavigator(self.tm, convert.config(dataclasses.asdict(jc)), est, readings,
                                      meas, max_meas=max_meas, dtype=tpd, loopy_cfg=tcfg, device="cpu")
        self.jcfg, self.tcfg = jcfg, tcfg
        j, t = self.jnav, self.tnav
        self.jargs = (j.params, j.state.lp, j.state.node_mask, j.odometry, j.z, j.z_mask, j.motion_cov,
                      j.grad_clip, j.grad_rate)
        self.targs = (t.params, t.state.lp, t.state.node_mask, t.odometry, t.z, t.z_mask, t.motion_cov,
                      t.grad_clip, t.grad_rate)
        self.frames, self.npd = frames, npd

    @functools.cached_property
    def _jrefit(self):
        return jax.jit(jloopy.make_sequential_refit(self.jm, self.jcfg))

    @functools.cached_property
    def jtraj(self):
        return np.asarray(self._jrefit(*self.jargs))

    def jtraj_back(self):
        """The JAX refit over the reversed inputs, flipped back; jitted anew
        on every call, so that a patched jax.lax.top_k (FollowJaxPrune) is
        traced into it."""
        params, lp, node_mask, odometry, z, z_mask, *rest = self.jargs
        lp_r, odo_r, z_r, zm_r = jloopy.reverse_refit_inputs(lp, odometry, z, z_mask)
        refit = jax.jit(jloopy.make_sequential_refit(self.jm, self.jcfg))
        return np.flip(np.asarray(refit(params, lp_r, node_mask, odo_r, z_r, zm_r, *rest)), 0)

    @functools.cached_property
    def jstate(self):
        return jloopy.init_state(self.jm, self.jcfg, self.jtraj, self.frames, self.npd)

    @functools.cached_property
    def jmapped(self):
        """One map sweep after the refit: a state with real map messages."""
        j, jm, jcfg = self.jnav, self.jm, self.jcfg
        temp = jnp.asarray(0.0, self.npd)
        return jax.jit(lambda s: jloopy.map_sweep(
            jm, jcfg, j.params, s, j.z, j.z_mask, temp, j.grad_clip, j.grad_rate))(self.jstate)

    @functools.cached_property
    def jfwd(self):
        j = self.jnav
        return jax.jit(lambda s: jloopy.forward_sweep(self.jm, s, j.odometry, j.motion_cov))(self.jmapped)

    @functools.cached_property
    def jback(self):
        j = self.jnav
        return jax.jit(lambda s: jloopy.backward_sweep(self.jm, s, j.odometry, j.motion_cov))(self.jfwd)

    def jobjective(self, state):
        return [float(x) for x in self.jnav._objective(state)]

    def jfinal_map(self, state):
        j = self.jnav
        return jax.jit(lambda s: jloopy.final_map(self.jm, self.jcfg, j.params, s, j.z, j.z_mask,
                                                  history=True))(state)

    def port_state(self, jstate):
        """The JAX LoopyState as the port's (convert.loopy_state)."""
        return convert.loopy_state(fields(jstate), dtype=getattr(torch, self.dtype), device="cpu")


class FollowJaxPrune:
    """Runs the port's inner mapping filter on the JAX filter's order of its
    weight-sorted cut (the top-k of every frame's candidate log-weights,
    phd._correct_prune_soa in both packages): install jax_top_k as
    jax.lax.top_k while the JAX function is traced, and port_topk as the
    port's mixture.topk_stable while the port's runs.

    Candidates whose log-weights differ by less than float32 resolves come
    out of the cut in an order rounding decides: on the Linear2D reversed
    refit, three candidates with float64 log-weights -4.5718e-07,
    -4.3982e-07 and -4.3982e-07 (computed as differences of numbers near -5,
    where float32's spacing is 4.8e-07) are all -4.4703e-07 in JAX's float32
    and -4.4703e-07, -4.1723e-07, -4.1723e-07 in the port's, so the two
    filters keep the same components in other slots, and the next node's
    first jmap_cap map components differ. Each frame the port's log-weights
    are held to JAX's (rtol and atol 1e-4 in float32, 1e-10 in float64), where the
    two orders differ the values swapped must lie within 8 spacings of each
    other in the port's dtype, and the port then takes JAX's order."""

    def __init__(self, k, dtype):
        self.k, self.frames, self.flips = k, [], 0
        self.tol = 1e-4 if dtype == "float32" else 1e-10
        self.real_jax, self.real_port = jax.lax.top_k, tmixture.topk_stable

    def jax_top_k(self, x, k):
        if k == self.k:
            jax.debug.callback(lambda v: self.frames.append(np.asarray(v).reshape(-1)), x, ordered=True)
        return self.real_jax(x, k)

    def port_topk(self, x, k):
        if k != self.k:
            return self.real_port(x, k)
        want, got = self.frames.pop(0), x.reshape(-1).numpy()
        assert x.numel() == want.size
        live = (want > -1e29) | (got > -1e29)
        np.testing.assert_allclose(got[live], want[live], rtol=self.tol, atol=self.tol)
        order = np.argsort(-want, kind="stable")[:k]
        own = self.real_port(x, k)[1].reshape(-1).numpy()
        swapped = order != own
        if swapped.any():
            self.flips += 1
            a, b = got[order[swapped]], got[own[swapped]]
            assert (np.abs(a - b) <= 8 * np.spacing(np.maximum(np.abs(a), 1).astype(got.dtype))).all()
        idx = torch.as_tensor(order).reshape(x.shape[:-1] + (k,))
        return torch.gather(x, -1, idx), idx


# -- RGB-D frontend ---------------------------------------------------------

# A LATCH bit whose two patch SSDs tie within float32 rounding of a 49-term
# sum (twice its worst case, 49 x 2^-24 relative) may come out either way:
# the port sums in float32 in its own order, the JAX function in XLA's
# (float64 under x64, and differently jitted than eager).
LATCH_TIE_RTOL = 49 * 2.0 ** -23


class JaxDraws:
    """RANSAC's sample rows as the JAX KinectSource draws them: one key
    split a filtered frame, 64 hypothesis keys, jax.random.categorical over
    the matched rows (logits where(mask, 0, -1e9))."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, mask, iterations):
        self.key, sub = jax.random.split(self.key)
        logits = jnp.where(jnp.asarray(mask.cpu().numpy()), 0.0, -1e9)
        keys = jax.random.split(sub, iterations)
        idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(keys)
        return torch.tensor(np.asarray(idx), dtype=torch.long, device=mask.device)


def latch_ties(ssd_pairs, img, xy, desc, jdesc):
    """The number of bits where the port's descriptors `desc` differ from
    the JAX ones `jdesc`; raises unless each is a tie within LATCH_TIE_RTOL
    of the port's own SSDs."""
    diff = np.unpackbits(np.asarray(desc), axis=1) != np.unpackbits(np.asarray(jdesc), axis=1)
    rows, bits = np.nonzero(diff)
    if len(rows):
        a, c = (t.numpy()[rows, bits] for t in ssd_pairs(img, xy))
        gap = np.abs(a - c) / np.maximum(np.maximum(a, c), 1e-30)
        assert (gap <= LATCH_TIE_RTOL).all(), list(zip(rows, bits, a, c))
    return len(rows)


class FollowJaxTies:
    """Runs a port KinectSource on the JAX source's tie decisions: wraps the
    JAX source's measure to keep each frame's keypoints and descriptors, and
    replaces the port's latch.describe (install with monkeypatch) by one that
    checks its own descriptors against the JAX frame's (the same keypoints;
    differing bits only at ties) and then returns the JAX ones."""

    def __init__(self, jsrc, tlatch):
        self.frames, self.flips, self.real = [], 0, tlatch.describe
        self.tlatch = tlatch
        measure = jsrc.measure

        def recorded(i):
            out = measure(i)
            self.frames.append((np.asarray(jsrc.prev.xy), np.asarray(jsrc.prev.desc)))
            return out

        jsrc.measure = recorded

    def describe(self, img, xy, valid):
        desc = self.real(img, xy, valid)
        jxy, jdesc = self.frames.pop(0)
        np.testing.assert_array_equal(xy.cpu().numpy(), jxy)
        self.flips += latch_ties(self.tlatch.ssd_pairs, img, xy, desc.cpu().numpy(), jdesc)
        return torch.tensor(jdesc, device=desc.device)


def jax_ransac(src, dst, mask, idx, tolerance=3.0):
    """monorfs_tpu.frontend.matching.ransac_homography with the hypotheses'
    sample rows `idx` [I, 4] given instead of drawn from a key (the same
    functions, vmapped the same way). Returns (inlier mask, counts [I])."""
    from monorfs_tpu.frontend import matching as jm

    n_valid = jnp.maximum(jnp.sum(mask), 1)

    def hypothesis(i):
        err = jnp.linalg.norm(jm._project(jm._homography_dlt(src[i], dst[i]), src) - dst, axis=1)
        inliers = mask & (err < tolerance)
        return jnp.sum(inliers), inliers

    counts, sets = jax.vmap(hypothesis)(idx)
    best = jnp.argmax(counts)
    return jnp.where(counts[best] >= jnp.minimum(4, n_valid), sets[best], mask), counts


# a hypothesis whose DLT system's two smallest singular values are this close
# (relative to the largest, in float64) has no null vector that float32
# arithmetic determines: its homography depends on the SVD implementation
DLT_ILL_CONDITIONED = 1e-4


def _dlt_conditioning(src, dst):
    """sigma_8 / sigma_1 of the 8 x 9 DLT system of four point pairs."""
    rows = []
    for (x, y), (u, v) in zip(src, dst):
        rows += [[-x, -y, -1, 0, 0, 0, u * x, u * y, u], [0, 0, 0, -x, -y, -1, v * x, v * y, v]]
    s = np.linalg.svd(np.asarray(rows, np.float64), compute_uv=False)
    return s[-2] / s[0]


class FollowJaxRansac:
    """Runs the port's RANSAC on the JAX package's decisions (install over
    monorfs_tpu_torch.frontend.matching.ransac_homography with monkeypatch):
    each call computes the port's inlier mask and JAX's on the same sample
    rows, checks that every hypothesis on which their inlier counts differ
    is ill-conditioned in float32 (DLT_ILL_CONDITIONED: the unnormalised
    four-point DLT of both packages), and returns JAX's mask."""

    def __init__(self, tmatching):
        self.real, self.tm = tmatching.ransac_homography, tmatching
        self.calls, self.differ = 0, 0

    def __call__(self, src, dst, mask, idx, tolerance=3.0):
        mine = self.real(src, dst, mask, idx, tolerance).cpu().numpy()
        s, d, m, i = (np.asarray(t.cpu().numpy()) for t in (src, dst, mask, idx))
        theirs, jcounts = jax_ransac(jnp.asarray(s), jnp.asarray(d), jnp.asarray(m), jnp.asarray(i), tolerance)
        theirs = np.asarray(theirs)
        self.calls += 1
        if not np.array_equal(mine, theirs):
            self.differ += 1
            h = self.tm._homography_dlt(src[idx], dst[idx])
            err = torch.linalg.norm(self.tm._project(h, src) - dst[None], dim=-1)
            counts = (mask[None] & (err < tolerance)).sum(1).cpu().numpy()
            for k in np.nonzero(counts != np.asarray(jcounts))[0]:
                cond = _dlt_conditioning(s[i[k]], d[i[k]])
                assert cond < DLT_ILL_CONDITIONED, (k, i[k], counts[k], int(jcounts[k]), cond)
        return torch.tensor(theirs, device=src.device)


# ---- viewers: draw lists and windows ------------------------------------------------

class CallRecorder:
    """A stand-in matplotlib axes that records every method call (name,
    args, kwargs) and draws nothing: what a JAX viewer hands to ax.plot /
    ax.scatter / ax.set_xlim, in order."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args, **kw: self.calls.append((name, args, kw))

    def draws(self):
        return [c for c in self.calls if c[0] in ("plot", "scatter")]


def assert_draw_lists_equal(jax_draws, port_calls, atol=1e-12):
    """The JAX viewer's recorded plot / scatter calls against the port's
    draw list (render.axes.Call), call by call: kind, data to atol, format
    string and keyword arguments."""
    assert len(jax_draws) == len(port_calls), (len(jax_draws), len(port_calls))
    for i, ((kind, args, kw), call) in enumerate(zip(jax_draws, port_calls)):
        fmt = args[-1] if args and isinstance(args[-1], str) else ""
        data = args[:-1] if fmt else args
        assert (kind, fmt, kw) == (call.kind, call.fmt, call.kw), (i, kind, fmt, kw, call)
        assert len(data) == len(call.data), i
        for a, b in zip(data, call.data):
            np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64), rtol=0, atol=atol,
                                       err_msg=f"call {i}")


def asset_recording_3d(path, frames=10):
    """A short CPU recording of the 3D asset world (the port's command line,
    5 particles), for both packages' Recording.load."""
    from monorfs_tpu_torch.cli import main

    main(["-f", "assets/sim3d.world", "-c", "assets/mov3d.in", "-a", "phd", "-p", "5", "--frames",
          str(frames), "--device", "cpu", "-r", str(path)])
    return path


KEY_SEQUENCE = ["right"] * 3 + ["left", " "] + ["left"] * 6 + ["right"] * 2 + [" ", "right", "x"]


def drive_window(monkeypatch, fn, events=KEY_SEQUENCE, probe=None, where=None):
    """Run a viewer's window function under Agg with plt.show replaced by a
    function that sends `events` and reads probe(fig) after each (default:
    the frame slider's value); returns (readings, what fn returned).

    An event is a key (a key_press_event) or a tuple (kind, x, y, button),
    kind 'press', 'move' or 'release' (button_press_event,
    motion_notify_event, button_release_event), at the display point
    where(fig, x, y) (default (x, y)). The canvas draws before the first
    event and after each, as a window draws between two mouse events."""
    import matplotlib
    import matplotlib.pyplot as plt
    import matplotlib.widgets as widgets
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    monkeypatch.setattr(matplotlib, "use", lambda *a, **k: None)
    sliders, readings = [], []
    probe = probe or (lambda fig: int(sliders[-1].val))
    names = {"press": "button_press_event", "move": "motion_notify_event", "release": "button_release_event"}

    class Spy(widgets.Slider):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sliders.append(self)

    def show():
        fig = plt.gcf()
        fig.canvas.draw()
        for ev in events:
            if isinstance(ev, str):
                fig.canvas.callbacks.process("key_press_event", KeyEvent("key_press_event", fig.canvas, ev))
            else:
                kind, x, y, button = ev
                dx, dy = where(fig, x, y) if where else (x, y)
                name = names[kind]
                fig.canvas.callbacks.process(name, MouseEvent(name, fig.canvas, dx, dy, button=button))
            fig.canvas.draw()
            readings.append(probe(fig))
        plt.close(fig)

    monkeypatch.setattr(widgets, "Slider", Spy)
    monkeypatch.setattr(plt, "show", show)
    out = fn()
    return readings, out
