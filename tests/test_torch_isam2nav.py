"""The port's graph navigator (slam/isam2nav.py) against the JAX package's,
driven frame by frame with the same odometry and measurement lists, made
from a seed with numpy: 25 frames on Linear2D and 15 on PRM3D, for
Mahalanobis, NN and Perfect association. Labels must be identical in every
frame; trajectory, map and covariances agree to 1e-7 (both work in
float64). The PRM3D cases give both navigators one solve bucket (their
full capacities): every new bucket costs the JAX navigator three
compilations of the PRM3D graph; the Linear2D cases grow through the
buckets as a run does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu import models as jmodels
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.slam import isam2nav as jisam2nav
from monorfs_tpu.slam.isam2nav import ISAM2Navigator as JNavigator

from monorfs_tpu_torch import models
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.slam import graph, isam2nav
from monorfs_tpu_torch.slam.isam2nav import CLUTTER, ISAM2Navigator

DA = ["Mahalanobis", "NN", "Perfect"]


def _configs(name):
    out = []
    for c in (JConfig(), Config()):
        if name == "Linear2D":
            c.set_linear2d_defaults()
            c.motion_covariance = np.diag([0.05, 0.05])
            c.measurement_covariance = np.diag([5e-4, 5e-4])
        out.append(c)
    return out


def _frames(name, n, seed=5):
    """(odometry, measurements, true labels) per frame: a few landmarks seen
    with noise, some missed, now and then a clutter point."""
    rng = np.random.default_rng(seed)
    jm = jmodels.get(name)
    if name == "Linear2D":
        lms = np.array([[1.0, 1.2, 0], [2.2, -0.8, 0], [3.0, 1.0, 0], [1.5, -1.0, 0]])
        pose, odo = np.zeros(2), np.array([0.15, 0.02])
        odo_noise, z_noise = 0.01, np.sqrt(5e-4)
        clutter = lambda: rng.uniform(-2, 2, 2)  # noqa: E731
        inside = lambda z: np.all(np.abs(z) < 2.0)  # noqa: E731
    else:
        lms = np.column_stack([rng.uniform(-.4, .4, 7), rng.uniform(-.3, .3, 7), rng.uniform(.7, 1.6, 7)])
        pose, odo = np.array([0, 0, 0, 1, 0, 0, 0.0]), np.array([0.01, 0.0, 0.02, 0.0, 0.01, 0.0])
        odo_noise, z_noise = np.array([2e-3] * 3 + [1e-3] * 3), np.array([1.0, 1.0, 0.01])
        clutter = lambda: np.array([rng.uniform(-300, 300), rng.uniform(-200, 200), rng.uniform(.2, 1.9)])  # noqa: E731
        inside = lambda z: bool(jm.visible(jm.params, jnp.asarray(z)))  # noqa: E731
    out = []
    for _ in range(n):
        pose = np.asarray(jm.pose.add_odometry(jnp.asarray(pose), jnp.asarray(odo)))
        zs, labs = [], []
        for i, lm in enumerate(lms):
            z = np.asarray(jm.measure(jm.params, jnp.asarray(pose), jnp.asarray(lm)))
            z = z + rng.normal(size=z.shape) * z_noise
            if inside(z) and rng.random() < 0.9:
                zs.append(z)
                labs.append(i)
        if rng.random() < 0.3:
            zs.append(clutter())
            labs.append(-2)
        out.append((odo + rng.normal(size=odo.shape) * odo_noise, zs, np.array(labs), pose))
    return out


def _navigators(name, da, **kw):
    jc, tc = _configs(name)
    init = np.zeros(2) if name == "Linear2D" else np.array([0, 0, 0, 1, 0, 0, 0.0])
    sizes = dict(max_poses=40, max_landmarks=16, meas_per_frame=8, da_algorithm=da, **kw)
    return (JNavigator(jmodels.get(name), jc, init, **sizes),
            ISAM2Navigator(models.get(name), tc, init, device="cpu", **sizes))


@pytest.mark.parametrize("da", DA)
@pytest.mark.parametrize("name,n", [("Linear2D", 25), ("PRM3D", 15)])
def test_navigator_matches_jax(name, n, da, monkeypatch):
    if name == "PRM3D":
        for module in (jisam2nav, isam2nav):
            monkeypatch.setattr(module, "_pow2_at_least", lambda n, lo, hi: hi)
    jnav, tnav = _navigators(name, da)
    tnav.debug_promotions = []
    seen = set()
    for odo, zs, labs, true_pose in _frames(name, n):
        jnav.predict(odo)
        tnav.predict(odo)
        np.testing.assert_allclose(tnav.pose, jnav.pose, rtol=0, atol=1e-7)
        true_labels = labs if da == "Perfect" else None
        want = jnav.slam_update(list(zs), true_labels)
        got = tnav.slam_update(list(zs), true_labels)
        assert got == want
        seen.update(lab for lab in got if lab >= 0)
    assert len(seen) >= 3 and tnav.next_label == jnav.next_label
    assert tnav.n_poses == jnav.n_poses == n + 1 and tnav.n_factors == jnav.n_factors
    np.testing.assert_allclose(tnav.trajectory, jnav.trajectory, rtol=0, atol=1e-7)
    (tm, tc), (jm, jc) = tnav.map_estimate, jnav.map_estimate
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tnav.pl_cov, jnav.pl_cov, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tnav.pose, true_pose, atol=0.1)  # and it tracks the truth
    assert [len(tnav.cand_mean), tnav.cand_count] == [len(jnav.cand_mean), jnav.cand_count]
    if da != "Perfect":
        assert len(tnav.debug_promotions) == tnav.next_label
    # the full-capacity view of the graph
    st, jst = tnav.state, jnav.state
    assert st.n_poses == int(jst.n_poses) and st.poses.dtype == torch.float64
    np.testing.assert_array_equal(st.f_lm.numpy()[st.f_mask.numpy()],
                                  np.asarray(jst.f_lm)[np.asarray(jst.f_mask)])
    # transfers are counted: the association, the solve and the marginals
    # each upload the mirrors and read their results back
    assert tnav.reads >= 3 * n and tnav.uploads >= 10 * n


def test_mapping_mode_pins_the_poses():
    jnav, tnav = _navigators("Linear2D", "Mahalanobis", onlymapping=True)
    for odo, zs, _, true_pose in _frames("Linear2D", 12):
        for nav in (jnav, tnav):
            nav.predict(odo, true_pose)
            nav.slam_update(list(zs))
    np.testing.assert_array_equal(tnav.trajectory[1:], np.array([f[3] for f in _frames("Linear2D", 12)]))
    np.testing.assert_allclose(tnav.map_estimate[0], jnav.map_estimate[0], rtol=0, atol=1e-7)
    assert tnav.pose_fixed_np[:13].all()


def test_duplicate_merge_matches_jax():
    """The opt-in co-observation merge relabels the later label's factors
    and re-solves; both packages merge the same pairs."""
    jnav, tnav = _navigators("Linear2D", "Perfect", dup_merge_radius=0.5, dup_min_obs=3)
    merges = []
    merge_pair = tnav._merge_pair
    tnav._merge_pair = lambda ia, ib: (merges.append((ia, ib)), merge_pair(ia, ib))
    frames = _frames("Linear2D", 16)
    for k, (odo, zs, labs, _) in enumerate(frames):
        # one physical landmark reported under two labels in alternate frames
        labs = np.where(labs == 0, 7 * (k % 2), labs)
        for nav in (jnav, tnav):
            nav.predict(odo)
            nav.slam_update(list(zs), labs)
    assert merges and all(ia < ib for ia, ib in merges)
    np.testing.assert_array_equal(tnav.lm_mask_np, jnav.lm_mask_np)
    np.testing.assert_array_equal(tnav.obs_count, jnav.obs_count)
    np.testing.assert_array_equal(tnav.coobs, jnav.coobs)
    np.testing.assert_array_equal(tnav.f_lm_np[: tnav.n_factors], jnav.f_lm_np[: jnav.n_factors])
    np.testing.assert_allclose(tnav.map_estimate[0], jnav.map_estimate[0], rtol=0, atol=1e-7)


def test_perfect_needs_labels_and_capacity_is_enforced():
    _, tnav = _navigators("Linear2D", "Perfect")
    tnav.predict(np.array([0.1, 0.0]))
    with pytest.raises(RuntimeError, match="perfect data association"):
        tnav.slam_update([np.array([0.5, 0.5])])
    assert tnav.find_labels([np.zeros(2)] * 2, np.array([3, -2])) == [3, CLUTTER]
    tc = _configs("Linear2D")[1]
    small = ISAM2Navigator(models.get("Linear2D"), tc, np.zeros(2), max_poses=3, max_landmarks=4,
                           meas_per_frame=4, device="cpu")
    for _ in range(2):
        small.predict(np.array([0.1, 0.0]))
        small.slam_update([])
    small.predict(np.array([0.1, 0.0]))
    with pytest.raises(RuntimeError, match="capacity"):
        small.slam_update([])


def test_navigator_needs_a_gpu_by_default_and_full_precision():
    tc = _configs("Linear2D")[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ISAM2Navigator(models.get("Linear2D"), tc, np.zeros(2))
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            ISAM2Navigator(models.get("Linear2D"), tc, np.zeros(2), device="cpu")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    graph.assert_full_precision()
