"""The port's auction assignment (slam/assignment.py) and combinatorics
(utils/combinatorics.py) against the JAX package's.

The auction runs on the inputs of tests/test_assignment.py and on tie-heavy
matrices: the assignment must be IDENTICAL to the JAX auction's (the same
algorithm, ties to the lowest index), a permutation, and within S x eps of
the Hungarian's value. connected_components_jax against the JAX function;
the NumPy parts against the JAX package's own NumPy parts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.slam.assignment import auction_assign as jauction
from monorfs_tpu.utils import combinatorics as jcomb

from monorfs_tpu_torch.metrics.errors import hungarian
from monorfs_tpu_torch.slam import assignment
from monorfs_tpu_torch.slam.assignment import NEG, auction_assign
from monorfs_tpu_torch.utils import combinatorics as comb


def _random_dense():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(s, s)) for s in (3, 7, 16) for _ in range(5)]


def _association_shaped():
    """FindLabels-shaped blocks: a few gated entries, miss diagonal, clutter
    diagonal, NEG elsewhere (tests/test_assignment.py)."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(8):
        n, m = rng.integers(2, 10), rng.integers(1, 8)
        s = n + m
        profit = np.full((s, s), NEG)
        for i in range(n):
            for j in range(m):
                if rng.random() < 0.3:
                    profit[i, j] = rng.normal() * 3
            profit[i, m + i] = np.log(0.9)
        for j in range(m):
            profit[n + j, j] = np.log(1e-5)
        profit[n:, m:] = 0.0
        out.append(profit)
    return out


def _masked_clutter():
    """The scan-da shape with forced seats for masked-off measurement slots."""
    rng = np.random.default_rng(3)
    l_cap, c, m, n_valid = 40, 8, 24, 7
    n = l_cap + c
    s = n + m
    profit = np.full((s, s), NEG)
    for i in range(6):
        profit[i, i] = 3.0 + rng.normal() * 0.1
        profit[i, (i + 1) % n_valid] = -5.0
    profit[np.arange(n), m + np.arange(n)] = np.log(0.9)
    profit[n + np.arange(m), np.arange(m)] = np.where(np.arange(m) < n_valid, np.log(2e-4), 1.0)
    profit[n:, m:] = 0.0
    return profit, n, n_valid, m


def _tie_heavy():
    rng = np.random.default_rng(7)
    return [np.round(rng.normal(size=(s, s))) for s in (4, 9, 12)] + [np.zeros((5, 5)), np.ones((6, 6))]


CONTESTED = np.array([
    [5.0, NEG, np.log(0.9), NEG],
    [4.9, NEG, NEG, np.log(0.9)],
    [np.log(1e-5), NEG, 0.0, 0.0],
    [NEG, np.log(1e-5), 0.0, 0.0],
])

CASES = (
    [("small", np.array([[3.0, 1.0], [1.0, 2.0]]), 1e-3)]
    + [(f"dense{i}", p, 1e-4) for i, p in enumerate(_random_dense())]
    + [(f"assoc{i}", p, 1e-4) for i, p in enumerate(_association_shaped())]
    + [("masked-clutter", _masked_clutter()[0], 0.2), ("contested", CONTESTED, 1e-4)]
    + [(f"ties{i}", p, 1e-2) for i, p in enumerate(_tie_heavy())]
    + [("single", np.array([[2.0]]), 1e-3)]
)


@pytest.mark.parametrize("name,profit,eps", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_auction_matches_jax_and_hungarian(name, profit, eps, dtype):
    profit = profit.astype(dtype)
    s = profit.shape[0]
    stats = {"iterations": [], "reads": 0}
    col = auction_assign(torch.tensor(profit), eps=eps, stats=stats).numpy()
    np.testing.assert_array_equal(col, np.asarray(jauction(jnp.asarray(profit), eps=eps)))
    assert sorted(col.tolist()) == list(range(s))  # a permutation, no row left out
    ref = hungarian(-profit.astype(np.float64))
    total = lambda a: sum(float(profit[i, c]) for i, c in enumerate(a))  # noqa: E731
    slack = 1e-9 if dtype == np.float64 else 1e-3 * s
    assert total(col) >= total(ref) - s * eps - slack
    # one flag read per iteration and one per phase that ended on the flag
    assert len(stats["iterations"]) >= 1 and all(it < 400 for it in stats["iterations"])
    assert sum(stats["iterations"]) <= stats["reads"] <= sum(stats["iterations"]) + len(stats["iterations"])


def test_small_exact_and_forced_seats():
    assert auction_assign(torch.tensor([[3.0, 1.0], [1.0, 2.0]])).tolist() == [0, 1]
    profit, n, n_valid, m = _masked_clutter()
    col = auction_assign(torch.tensor(profit), eps=0.2).numpy()
    for j in range(n_valid, m):
        assert col[n + j] == j


def test_iteration_cap_leaves_rows_unassigned():
    """At the cap a phase stops; rows without a column come back as -1."""
    profit = torch.tensor(np.random.default_rng(2).normal(size=(12, 12)))
    col = auction_assign(profit, eps=1e-4, max_iters=1, scale_from=1e-4).numpy()
    np.testing.assert_array_equal(
        col, np.asarray(jauction(jnp.asarray(profit.numpy()), eps=1e-4, max_iters=1, scale_from=1e-4)))
    assert (col < 0).any()
    assigned = col[col >= 0]
    assert len(set(assigned.tolist())) == len(assigned)


def test_first_argmax_takes_the_lowest_index():
    v = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0], [-np.inf, -np.inf, -np.inf, -np.inf]])
    vmax, idx = assignment.first_argmax(v, 1)
    assert idx.tolist() == [1, 0, 0] and vmax.tolist() == [3.0, 5.0, -np.inf]
    vmax, idx = assignment.first_argmax(v, 0)
    assert idx.tolist() == [1, 1, 1, 1] and vmax.tolist() == [5.0] * 4


@pytest.mark.parametrize("n,seed", [(5, 0), (12, 1), (33, 2)])
def test_connected_components_tensor(n, seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 1.5 / n
    adj = adj | adj.T
    got = comb.connected_components_jax(torch.tensor(adj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcomb.connected_components_jax(jnp.asarray(adj))))
    # labels are the least index of each component
    for i in range(n):
        assert got[i] <= i and got[got[i]] == got[i]
    one = comb.connected_components_jax(torch.tensor(adj), iterations=1)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jcomb.connected_components_jax(jnp.asarray(adj), iterations=1)))


def test_numpy_combinatorics_match():
    rng = np.random.default_rng(4)
    profit = rng.normal(size=(5, 5))
    for (a, va), (b, vb) in zip(comb.murty(profit, k=6), jcomb.murty(profit, k=6), strict=True):
        np.testing.assert_array_equal(a, b)
        assert va == vb
    best = next(iter(comb.murty(profit, k=1)))
    assert best[1] == pytest.approx(comb.assignment_value(profit, hungarian(-profit)))
    small = rng.normal(size=(4, 4))
    ours = list(comb.lexicographical_pairing(small, 4))
    theirs = list(jcomb.lexicographical_pairing(small, 4))
    assert len(ours) == len(theirs) == 24
    assert max(v for _, v in ours) == pytest.approx(best_value(small))
    sparse = np.full((5, 6), comb.NEG)
    sparse[0, 0] = sparse[1, 0] = sparse[1, 1] = sparse[3, 4] = sparse[4, 5] = 1.0
    ours, theirs = comb.connected_components(sparse), jcomb.connected_components(sparse)
    assert len(ours) == len(theirs) == 3
    for (ra, ca), (rb, cb) in zip(ours, theirs):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ca, cb)
    assert comb.hungarian is hungarian


def best_value(profit):
    return comb.assignment_value(profit, hungarian(-profit))
