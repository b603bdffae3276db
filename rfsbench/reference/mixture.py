"""Masked fixed-capacity Gaussian-mixture maps (Map.cs:41-327), the parts
the frame's reference takes: a frozen copy of the port's gm/mixture.py.

The step runs on the structure-of-arrays form: every leaf of an SGM is a
plain [..., K] tensor, dead slots carry log-weight DEAD, and covariances are
symmetric, stored as their 6 unique entries."""

from typing import NamedTuple

import torch

from . import smallmat

# Finite stand-in for log(0): keeps arithmetic NaN-free.
DEAD = -1.0e30
ALIVE_THRESHOLD = -0.5e30


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


def empty_soa(k, dtype=torch.float32, batch=(), device=None):
    shape = tuple(batch) + (k,)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    one = torch.ones(shape, dtype=dtype, device=device)
    return SGM(
        zero, zero.clone(), zero.clone(),
        one, zero.clone(), zero.clone(), one.clone(), zero.clone(), one.clone(),
        torch.full(shape, DEAD, dtype=dtype, device=device),
    )


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


def map_margin(logw, cap=None, max_multiplicity=4):
    """How far best_map_indices' choice lies from another, per row: the gap
    between the last chosen key of {w_i - c} and the first one left, and,
    where one pick more or fewer changes the choice, the distance of sum w
    to the nearest whole number. Not a copy of the port: the benchmark's
    measure of a near-tie that float32 and float64 can settle apart."""
    k = logw.shape[-1]
    cap = k if cap is None else cap
    w0 = torch.exp(logw)
    w0 = torch.where(logw > ALIVE_THRESHOLD, w0, torch.zeros_like(w0))
    total = torch.sum(w0, dim=-1)
    n = torch.clamp(torch.floor(total).to(torch.int64), max=cap)
    copies = torch.arange(max_multiplicity, dtype=w0.dtype, device=w0.device)
    flat = (w0[..., :, None] - copies).reshape(w0.shape[:-1] + (k * max_multiplicity,))
    keys, _ = topk_stable(flat, min(cap + 1, k * max_multiplicity))
    inf = torch.full_like(total, float("inf"))
    at = torch.clamp(n, min=1, max=keys.shape[-1] - 1)[..., None]
    gap = torch.gather(keys, -1, at - 1)[..., 0] - torch.gather(keys, -1, at)[..., 0]
    gap = torch.where((n >= 1) & (n < keys.shape[-1]), gap, inf)
    whole = torch.round(total)
    count = torch.where(whole <= cap, torch.abs(total - whole), inf)
    return torch.minimum(gap, count)
