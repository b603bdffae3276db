"""The systematic draws on a cumulative sum added in an order fixed by the
particle count (phd.fixed_cumsum: blocks of SCAN_BLOCK, then the blocks'
offsets). CUDA's one-pass scan over 100,000 weights adds in an order that
varies between runs; the blocked sum is the same sum, so the draws are the
wheel's on the same weights: in slot order, every particle's offspring
within one of P times its weight, and equal to the JAX package's resample
on the same log-weights and key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch.slam import phd


@pytest.mark.parametrize("n", [1, 7, phd.SCAN_BLOCK, phd.SCAN_BLOCK + 1, 5000, 100_000, 2 * phd.SCAN_BLOCK ** 2 + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_blocked_sum_is_the_cumulative_sum(n, dtype):
    x = torch.rand(n, generator=torch.Generator().manual_seed(n), dtype=dtype)
    got, want = phd.fixed_cumsum(x), torch.cumsum(x, dim=0)
    assert got.shape == want.shape and got.dtype == dtype
    if n <= phd.SCAN_BLOCK:
        assert torch.equal(got, want)
    exact = np.cumsum(x.numpy().astype(np.longdouble))
    # the rounding of a blocked sum: a block's running sum, then the offsets' (a sequential sum's is n eps)
    tol = (phd.SCAN_BLOCK + n / phd.SCAN_BLOCK) * torch.finfo(dtype).eps * float(exact[-1])
    assert float(np.abs(got.numpy().astype(np.longdouble) - exact).max()) <= tol


@pytest.mark.parametrize("p", [64, 3000, 100_000])
def test_the_draws_are_the_wheels(p):
    g = torch.Generator().manual_seed(p)
    logweight = 4.0 * torch.randn(p, generator=g, dtype=torch.float64)
    u = torch.rand((), generator=g, dtype=torch.float64)
    src, best = phd.systematic_draws(logweight, u)
    w = torch.softmax(logweight, 0)
    assert bool((src[1:] >= src[:-1]).all())
    n = torch.bincount(src, minlength=p)
    assert float((n - p * w).abs().max()) < 1.0 + 1e-9
    assert w[src[best]] == w[src].max()


@pytest.mark.parametrize("p", [3000, 100_000])
def test_the_draws_are_the_jax_packages(p):
    """Past SCAN_BLOCK particles the port sums in blocks; its ancestors and
    best particle equal monorfs_tpu.slam.phd.resample's on the same
    log-weights, its uniform drawn from the same key."""
    logweight = 4.0 * jax.random.normal(jax.random.PRNGKey(p), (p,), jnp.float64)
    key = jax.random.PRNGKey(p + 1)
    state = jphd.PHDState(pose=jnp.zeros((p, 1)), logweight=logweight, maps=(), best=jnp.int32(0),
                          ancestor=jnp.arange(p, dtype=jnp.int32))
    want = jphd.resample(state, key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (), jnp.float64)))
    src, best = phd.systematic_draws(torch.tensor(np.asarray(logweight)), u)
    np.testing.assert_array_equal(src.numpy(), np.asarray(want.ancestor))
    assert int(best) == int(want.best)
