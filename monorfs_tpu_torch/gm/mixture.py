"""Masked fixed-capacity Gaussian-mixture maps (Map.cs:41-327): the torch
twin of monorfs_tpu.gm.mixture.

The step runs on the structure-of-arrays form: every leaf of an SGM is a
plain [..., K] tensor, dead slots carry log-weight DEAD, and covariances are
symmetric, stored as their 6 unique entries. The array-of-structures GM
(mean [..., K, 3], cov [..., K, 3, 3]) serves the specification path, the
recording and the estimates."""

from typing import NamedTuple

import torch

from . import gaussian, smallmat

# Finite stand-in for log(0): keeps arithmetic NaN-free.
DEAD = -1.0e30
ALIVE_THRESHOLD = -0.5e30


class GM(NamedTuple):
    """A batched Gaussian mixture in array-of-structures form. Leading dims
    broadcast; K is the component axis, D the state dim (3 for maps)."""

    mean: torch.Tensor  # [..., K, D]
    cov: torch.Tensor  # [..., K, D, D]
    logw: torch.Tensor  # [..., K]

    @property
    def capacity(self):
        return self.logw.shape[-1]

    @property
    def dim(self):
        return self.mean.shape[-1]


def empty(k, dim=3, dtype=torch.float32, batch=(), device=None):
    batch = tuple(batch)
    eye = torch.eye(dim, dtype=dtype, device=device)
    return GM(
        mean=torch.zeros(batch + (k, dim), dtype=dtype, device=device),
        cov=eye.expand(batch + (k, dim, dim)).clone(),
        logw=torch.full(batch + (k,), DEAD, dtype=dtype, device=device),
    )


def alive(gm):
    return gm.logw > ALIVE_THRESHOLD


def count(gm):
    return torch.sum(alive(gm), dim=-1)


def concat(a: GM, b: GM) -> GM:
    return GM(
        mean=torch.cat([a.mean, b.mean], dim=-2),
        cov=torch.cat([a.cov, b.cov], dim=-3),
        logw=torch.cat([a.logw, b.logw], dim=-1),
    )


def evaluate(gm: GM, x, radius=None):
    """Mixture density at point x [..., D] (Map.cs:192-220). With `radius`,
    only components whose mean lies within the Euclidean ball contribute."""
    logp = gaussian.logpdf(x[..., None, :], gm.mean, gm.cov)
    mask = alive(gm)
    if radius is not None:
        dist2 = torch.sum((gm.mean - x[..., None, :]) ** 2, dim=-1)
        mask = mask & (dist2 <= radius * radius)
    vals = torch.exp(gm.logw + logp)
    return torch.sum(torch.where(mask, vals, torch.zeros_like(vals)), dim=-1)


def evaluate_many(gm: GM, points, radius=None):
    """Mixture density at many points [E, D] -> [E]; component inverses and
    normalisers are computed once, not per point."""
    inv = gaussian.inv(gm.cov)  # [K, D, D]
    logmult = gaussian.log_multiplier(gm.cov)  # [K]
    diff = points[:, None, :] - gm.mean[None, :, :]  # [E, K, D]
    m2 = torch.einsum("ekd,kdc,ekc->ek", diff, inv, diff)
    logp = logmult[None, :] - 0.5 * m2
    mask = alive(gm)[None, :]
    if radius is not None:
        mask = mask & (torch.sum(diff * diff, dim=-1) <= radius * radius)
    vals = torch.exp(gm.logw[None, :] + logp)
    return torch.sum(torch.where(mask, vals, torch.zeros_like(vals)), dim=-1)


class SGM(NamedTuple):
    """Structure-of-arrays Gaussian mixture, leaves [..., K]."""

    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    cxx: torch.Tensor
    cxy: torch.Tensor
    cxz: torch.Tensor
    cyy: torch.Tensor
    cyz: torch.Tensor
    czz: torch.Tensor
    logw: torch.Tensor

    @property
    def capacity(self):
        return self.logw.shape[-1]

    def mean_list(self):
        return [self.mx, self.my, self.mz]

    def cov6(self):
        return (self.cxx, self.cxy, self.cxz, self.cyy, self.cyz, self.czz)

    def cov_mat(self):
        """Symmetric covariance as a smallmat list-of-lists (aliases)."""
        return smallmat.sym_to_mat(self.cov6())

    # array-of-structures views for consumers off the step (estimates,
    # recording)
    @property
    def mean(self):
        return torch.stack(self.mean_list(), dim=-1)

    @property
    def cov(self):
        return smallmat.to_tensor(self.cov_mat())


def soa_of(gm: GM) -> SGM:
    m, c = gm.mean, gm.cov
    return SGM(
        m[..., 0], m[..., 1], m[..., 2],
        c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
        c[..., 1, 1], c[..., 1, 2], c[..., 2, 2],
        gm.logw,
    )


def aos_of(sgm: SGM) -> GM:
    return GM(sgm.mean, sgm.cov, sgm.logw)


def take_soa(sgm: SGM, idx, axis=0) -> SGM:
    """Gather components / particles along `axis` of every leaf."""
    return map_soa(lambda x: torch.index_select(x, axis, idx), sgm)


def map_soa(fn, *sgms):
    """Apply fn leaf-wise across SGMs (the tree.map of the JAX twin)."""
    return SGM(*[fn(*leaves) for leaves in zip(*sgms)])


def sgm_make(mean_list, cov_mat, logw) -> SGM:
    """SGM from a mean 3-list + symmetric smallmat, leaves broadcast to
    logw's shape."""
    c6 = smallmat.mat_to_sym(cov_mat)

    def bc(a):
        a = torch.as_tensor(a, dtype=logw.dtype, device=logw.device)
        return a.expand(logw.shape).clone()

    return SGM(*[bc(m) for m in mean_list], *[bc(c) for c in c6], logw)


def empty_soa(k, dtype=torch.float32, batch=(), device=None):
    shape = tuple(batch) + (k,)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    one = torch.ones(shape, dtype=dtype, device=device)
    return SGM(
        zero, zero.clone(), zero.clone(),
        one, zero.clone(), zero.clone(), one.clone(), zero.clone(), one.clone(),
        torch.full(shape, DEAD, dtype=dtype, device=device),
    )


def concat_soa(a: SGM, b: SGM) -> SGM:
    return map_soa(lambda x, y: torch.cat([x, y], dim=-1), a, b)


def _pairwise(sgm: SGM, points):
    """Per-(point, component) Gaussian log-density and squared distance.
    points: 3-list of [..., E]; returns ([..., E, K] logp, dist2)."""
    cov = sgm.cov_mat()
    dt = smallmat.det(cov)
    inv = smallmat.inv(cov, dt)
    logmult = smallmat.log_multiplier(cov, dt)
    diff = [p[..., :, None] - m[..., None, :] for p, m in zip(points, sgm.mean_list())]
    inv_e = [[entry[..., None, :] for entry in row] for row in inv]
    m2 = smallmat.quadform(diff, inv_e)
    logp = logmult[..., None, :] - 0.5 * m2
    dist2 = sum(d * d for d in diff)
    return logp, dist2


def _mask(sgm, dist2, radius):
    mask = (sgm.logw > ALIVE_THRESHOLD)[..., None, :]
    if radius is not None:
        mask = mask & (dist2 <= radius * radius)
    return mask


def evaluate_many_soa(sgm: SGM, points, radius=None):
    """Mixture density at many points -> [..., E] (Map.cs:192-220); with
    `radius`, only components within the Euclidean ball contribute."""
    logp, dist2 = _pairwise(sgm, points)
    mask = _mask(sgm, dist2, radius)
    vals = torch.exp(sgm.logw[..., None, :] + logp)
    return torch.sum(torch.where(mask, vals, torch.zeros_like(vals)), dim=-1)


def log_evaluate_many_soa(sgm: SGM, points, radius=None):
    """Log mixture density at many points, fully in log space (no float32
    underflow to log(0)); DEAD-order negative where nothing contributes."""
    logp, dist2 = _pairwise(sgm, points)
    logp = torch.where(torch.isfinite(logp), logp, torch.full_like(logp, DEAD))
    mask = _mask(sgm, dist2, radius)
    scores = torch.where(
        mask, sgm.logw[..., None, :] + logp, torch.full_like(logp, DEAD)
    )
    peak = torch.amax(scores, dim=-1)
    out = peak + torch.log(torch.sum(torch.exp(scores - peak[..., None]), dim=-1))
    return torch.clamp(out, min=DEAD)


def weights(sgm):
    w = torch.exp(sgm.logw)
    return torch.where(sgm.logw > ALIVE_THRESHOLD, w, torch.zeros_like(w))


def expected_size(sgm):
    """Sum of weights (Map.cs:61-71)."""
    return torch.sum(weights(sgm), dim=-1)


def topk_stable(x, k):
    """Top-k along the last axis, sorted descending, ties to the lower index
    first (lax.top_k's order; torch.topk does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def best_map_indices(logw, cap=None, max_multiplicity=4):
    """Marginal multi-object (MAP) estimate selection (Map.cs:119-142):
    floor(sum w) greedy picks by weight, each pick decrementing the chosen
    weight by 1 -- the top-n of the flattened {w_i - c} matrix.

    Returns (indices [..., cap] int64, valid [..., cap] bool)."""
    k = logw.shape[-1]
    cap = k if cap is None else cap
    w0 = torch.exp(logw)
    w0 = torch.where(logw > ALIVE_THRESHOLD, w0, torch.zeros_like(w0))
    n = torch.floor(torch.sum(w0, dim=-1)).to(torch.int64)
    copies = torch.arange(max_multiplicity, dtype=w0.dtype, device=w0.device)
    flat = (w0[..., :, None] - copies).reshape(w0.shape[:-1] + (k * max_multiplicity,))
    _, fidx = topk_stable(flat, cap)
    idx = torch.div(fidx, max_multiplicity, rounding_mode="floor")
    ar = torch.arange(cap, device=logw.device)
    valid = ar < torch.clamp(n, max=cap)[..., None]
    return idx, valid


def prune_merge(gm: GM, max_quantity, min_weight, merge_threshold, rounds=8):
    """Prune + merge (PHDNavigator.cs:913-948): sort by weight descending,
    cut at `max_quantity` / the first weight below `min_weight`, then merge
    later components greedily into the heaviest earlier component within
    `merge_threshold` Mahalanobis distance (in the leader's metric).

    Unbatched over particles. Returns a GM with capacity `max_quantity`."""
    k_out = max_quantity
    logw, order = topk_stable(gm.logw, k_out)
    mean = gm.mean[order]
    cov = gm.cov[order]
    live = (logw > ALIVE_THRESHOLD) & (logw >= torch.log(torch.as_tensor(min_weight, dtype=logw.dtype)))

    cov_inv = gaussian.inv(cov)  # [K, D, D], the leader metric
    diff = mean[None, :, :] - mean[:, None, :]  # [i leader, k candidate, D]
    m2 = torch.einsum("ikd,ide,ike->ik", diff, cov_inv, diff)
    close = m2 < merge_threshold * merge_threshold

    idx = torch.arange(k_out, device=logw.device)
    # is_leader[k] = live[k] and no earlier leader i < k with close(i, k):
    # a fixed-round synchronous fixed point of the sequential greedy
    lower = (idx[:, None] < idx[None, :]) & close & live[None, :] & live[:, None]
    is_leader = live
    for _ in range(rounds):
        is_leader = live & ~torch.any(lower & is_leader[:, None], dim=0)
    eligible = lower & is_leader[:, None]
    has = torch.any(eligible, dim=0)
    leader = torch.where(has, torch.argmax(eligible.to(torch.uint8), dim=0), idx)

    assign = (leader[None, :] == idx[:, None]) & live[None, :]
    w = torch.where(live, torch.exp(logw), torch.zeros_like(logw))
    cw = assign * w[None, :]
    wsum = torch.sum(cw, dim=1)
    safe = torch.clamp(wsum, min=1e-30)
    m = torch.einsum("ik,kd->id", cw, mean) / safe[:, None]
    second = cov + mean[:, :, None] * mean[:, None, :]
    p = torch.einsum("ik,kde->ide", cw, second) / safe[:, None, None]
    p = p - m[:, :, None] * m[:, None, :]

    out_alive = is_leader & (wsum > 0)
    eye = torch.eye(gm.dim, dtype=p.dtype, device=p.device)
    return GM(
        torch.where(out_alive[:, None], m, torch.zeros_like(m)),
        torch.where(out_alive[:, None, None], p, eye),
        torch.where(out_alive, torch.log(safe), torch.full_like(logw, DEAD)),
    )
