"""The port's landmark-sharded Schur BA (monorfs_tpu_torch/parallel/
dist_ba.py) on N gloo ranks (tests/torch_dist_runner.py), on the random 3D
pixel-range graph of tests/test_dist_ba.py (6 poses, 16 landmarks, float64):
poses and landmarks within 1e-8 of the port's dense graph.gauss_newton and
of the JAX package's make_dist_gauss_newton on an N-device mesh of the same
partition. partition_factors gives the JAX package's arrays exactly; the
ranks issue one psum a Gauss-Newton iteration, of (T O)^2 + T O floats."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.parallel import dist_ba as jdist_ba

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.parallel import dist_ba
from monorfs_tpu_torch.slam import graph

from test_dist_ba import _build_prm3d_problem
import torch_dist_runner
from torch_dist_runner import run_ranks

one_thread = pytest.fixture(autouse=True, scope="module")(torch_dist_runner.one_thread)


@pytest.fixture(scope="module")
def problem():
    model, gcfg, st, minfo, sinfo = _build_prm3d_problem(np.random.default_rng(3))
    fields = {k: np.asarray(v) for k, v in st._asdict().items()}
    dcfg = dict(max_poses=gcfg.max_poses, max_landmarks=gcfg.max_landmarks,
                max_factors=gcfg.max_factors, gn_iters=gcfg.gn_iters, damping=gcfg.damping)
    return model, gcfg, st, fields, np.asarray(minfo), np.asarray(sinfo), dcfg


def _jax_dist(problem, n):
    model, _, st, _, minfo, sinfo, dcfg = problem
    dcfg = jdist_ba.DistBAConfig(**dcfg)
    mesh = jdist_ba.make_landmark_mesh(n)
    fp, fl, fz, fm = jdist_ba.partition_factors(dcfg, n, st.f_pose, st.f_lm, st.f_z, st.f_mask)
    lms, lmask, fp, fl, fz, fm = jdist_ba.shard_ba_inputs(mesh, "landmarks", st.landmarks,
                                                          st.lm_mask, fp, fl, jnp.asarray(fz), fm)
    solve = jdist_ba.make_dist_gauss_newton(model, dcfg, mesh)
    poses, landmarks = solve(st.poses, st.n_poses, st.pose_fixed, st.between, st.between_mask,
                             lms, lmask, fp, fl, fz, fm, jnp.asarray(minfo), jnp.asarray(sinfo))
    return np.asarray(poses), np.asarray(landmarks)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dist_ba_matches_dense_and_jax(tmp_path, problem, world):
    _, gcfg, _, fields, minfo, sinfo, dcfg = problem
    arrays = {k: fields[k] for k in ("poses", "n_poses", "pose_fixed", "between", "between_mask",
                                     "landmarks", "lm_mask", "f_pose", "f_lm", "f_z", "f_mask")}
    arrays.update(minfo=minfo, sinfo=sinfo)
    spec = dict(case="ba", model="PRM3D", dtype="float64", dcfg=dcfg)
    outs = run_ranks(tmp_path, spec, arrays, world)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["poses"], outs[0]["poses"])
    got = outs[0]

    dense = graph.gauss_newton(tget("PRM3D"), graph.GraphConfig(**dcfg),
                               convert.graph_state(fields, device="cpu"),
                               torch.tensor(minfo), torch.tensor(sinfo))
    np.testing.assert_allclose(got["poses"], dense.poses.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["landmarks"], dense.landmarks.numpy(), rtol=0, atol=1e-8)

    jposes, jlandmarks = _jax_dist(problem, world)
    np.testing.assert_allclose(got["poses"], jposes, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["landmarks"], jlandmarks, rtol=0, atol=1e-8)
    assert np.abs(got["landmarks"] - fields["landmarks"]).max() > 1e-3  # the solve moved them

    to = gcfg.max_poses * 6
    comm = json.loads(str(got["comm"]))
    assert comm == {"psum": [gcfg.gn_iters, gcfg.gn_iters * (to * to + to) * 8]}


def test_partition_factors_matches_jax(problem):
    _, _, st, fields, _, _, dcfg = problem
    for n in (1, 2, 4, 8):
        got = dist_ba.partition_factors(dist_ba.DistBAConfig(**dcfg), n, fields["f_pose"],
                                        fields["f_lm"], fields["f_z"], fields["f_mask"])
        want = jdist_ba.partition_factors(jdist_ba.DistBAConfig(**dcfg), n, st.f_pose, st.f_lm,
                                          st.f_z, st.f_mask)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    small = dist_ba.DistBAConfig(max_poses=4, max_landmarks=8, max_factors=4)
    with pytest.raises(ValueError, match="overflows"):
        dist_ba.partition_factors(small, 4, np.zeros(2, np.int32), np.zeros(2, np.int32),
                                  np.ones((2, 3)), np.ones(2, bool))
