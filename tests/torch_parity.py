"""Shared helpers of the tests/test_torch_*.py parity tests: the same numpy
inputs go through monorfs_tpu (the reference, JAX on the CPU) and
monorfs_tpu_torch (device='cpu', the plain PyTorch paths)."""

import numpy as np
import torch

import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.gm import mixture as jmixture

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.gm.mixture import SGM

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
