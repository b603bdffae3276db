"""The port's quaternion and pose3d algebra against monorfs_tpu.geometry on
the same numpy inputs, float64 (atol 1e-12) and float32 (atol 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.geometry import pose3d as jpose
from monorfs_tpu.geometry import quaternion as jquat

from monorfs_tpu_torch.geometry import pose3d, quaternion as quat

RNG = np.random.default_rng(23)
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def random_pose(n):
    s = RNG.normal(size=(n, 7))
    s[:, 3:7] /= np.linalg.norm(s[:, 3:7], axis=-1, keepdims=True)
    return s


def both(fn_t, fn_j, *args, dtype):
    got = fn_t(*[torch.tensor(a.astype(dtype)) for a in args]).numpy()
    ref = np.asarray(fn_j(*[jnp.asarray(a.astype(dtype)) for a in args]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["mul", "sub"])
def test_quaternion_binary(name, dtype):
    a, b = random_pose(16)[:, 3:], random_pose(16)[:, 3:]
    both(getattr(quat, name), getattr(jquat, name), a, b, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["conj", "normalize", "log", "sqrt", "to_matrix"])
def test_quaternion_unary(name, dtype):
    q = random_pose(16)[:, 3:]
    q[0] = [1, 0, 0, 0]  # identity: the small-angle branches
    both(getattr(quat, name), getattr(jquat, name), q, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quaternion_exp_add_rotate(dtype):
    q = random_pose(16)[:, 3:]
    v = RNG.normal(size=(16, 3))
    v[0] = 0.0
    both(quat.exp, jquat.exp, v, dtype=dtype)
    both(quat.add, jquat.add, q, v, dtype=dtype)
    both(quat.rotate, jquat.rotate, q, v, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["add", "add_global", "add_odometry", "add_jacobian",
                                  "add_odometry_jacobian"])
def test_pose_with_delta(name, dtype):
    p = random_pose(16)
    d = RNG.normal(size=(16, 6)) * 0.5
    both(getattr(pose3d, name), getattr(jpose, name), p, d, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["subtract", "subtract_global", "diff_odometry",
                                  "subtract_jacobian"])
def test_pose_difference(name, dtype):
    a, b = random_pose(16), random_pose(16)
    both(getattr(pose3d, name), getattr(jpose, name), a, b, dtype=dtype)


def test_identity_and_broadcast():
    assert pose3d.identity(torch.float64).tolist() == np.asarray(jpose.identity(jnp.float64)).tolist()
    p = random_pose(5)
    u = RNG.normal(size=6) * 0.3  # one reading applied to every particle
    both(lambda a, b: pose3d.add_odometry(a, b[None, :]),
         lambda a, b: jpose.add_odometry(a, b[None, :]), p, u, dtype=np.float64)


def test_add_odometry_inverse_is_negation():
    """q = p (+) u implies p = q (+) (-u), as tests/test_pose3d.py demands
    of the JAX package (float64, 1e-6)."""
    for _ in range(10):
        p = torch.tensor(random_pose(1)[0])
        u = torch.tensor(RNG.normal(size=6) * 0.7)
        back = pose3d.add_odometry(pose3d.add_odometry(p, u), -u).numpy()
        a = p.numpy()
        np.testing.assert_allclose(back[:3], a[:3], atol=1e-6)
        qerr = min(np.linalg.norm(back[3:] - a[3:]), np.linalg.norm(back[3:] + a[3:]))
        assert qerr < 1e-6, qerr
