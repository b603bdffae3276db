"""The port's copy of the post-analysis metrics against the JAX package's on
the same numpy inputs. Exact (==): the code is a NumPy copy."""

import numpy as np
import pytest

from monorfs_tpu.metrics import errors as jerr

from monorfs_tpu_torch.metrics import errors as terr


def _traj(rng, n, dim):
    out = []
    for i in range(n):
        s = rng.normal(size=dim)
        if dim == 7:
            s[3:] /= np.linalg.norm(s[3:])
        out.append((0.1 * (i + 1), s))
    return out


@pytest.mark.parametrize("shape", [(4, 4), (3, 6), (7, 2), (1, 1)])
def test_hungarian(shape):
    cost = np.random.default_rng(sum(shape)).uniform(size=shape)
    np.testing.assert_array_equal(terr.hungarian(cost), jerr.hungarian(cost))


@pytest.mark.parametrize("n,m", [(0, 0), (0, 3), (4, 0), (3, 5), (6, 2), (4, 4)])
@pytest.mark.parametrize("p", [1.0, 2.0])
def test_ospa(n, m, p):
    rng = np.random.default_rng(10 * n + m)
    est, tru = rng.normal(size=(n, 3)), rng.normal(size=(m, 3))
    assert terr.ospa(est, tru, 1.0, p) == jerr.ospa(est, tru, 1.0, p)
    if n and m:  # a distance table handed in gives the same answer
        dist = np.linalg.norm(est[:, None, :] - tru[None, :, :], axis=-1)
        assert terr.ospa(est, tru, 1.0, p, dist=dist) == jerr.ospa(est, tru, 1.0, p)


@pytest.mark.parametrize("dim", [1, 2, 7])
@pytest.mark.parametrize("reftime", [None, 0.2])
def test_ate_and_alignment(dim, reftime):
    rng = np.random.default_rng(dim)
    est, tru = _traj(rng, 9, dim), _traj(rng, 9, dim)
    assert terr.ate_location(est, tru, reftime) == jerr.ate_location(est, tru, reftime)
    assert terr.ate_rotation(est, tru, reftime) == jerr.ate_rotation(est, tru, reftime)
    for (ta, sa), (tb, sb) in zip(terr.align_at(est, tru, 0.3), jerr.align_at(est, tru, 0.3)):
        assert ta == tb
        np.testing.assert_array_equal(sa, sb)
    assert terr.rmse(terr.ate_location(est, tru)) == jerr.rmse(jerr.ate_location(est, tru))
    assert terr.path_length(tru) == jerr.path_length(tru)
    assert terr.rmse([]) == 0.0 and terr.path_length(tru[:1]) == 0.0
