"""Set log-likelihood by beam enumeration over data associations
(PHDNavigator.cs:415-713, GraphCombinatorics.cs:42-792): the torch twin of
monorfs_tpu.slam.association.

A beam element is a partial association: each measurement so far maps to
clutter or to a distinct landmark (injective through a packed used-set
bitmask). Summing the top-B assignment scores gives the truncated set
likelihood; with B above the number of reachable assignments it is exact.
The whole computation is differentiable in the pose through the plain beam
(the sort that selects each step's top-B carries the gradient, as lax.top_k
does), so torch.autograd gives the smoother its gradients and Hessians.

The used-set words are uint32 in JAX. Here they are int32 with the same bit
patterns: bit 31 is the sign bit, and `&`, `|` and `!= 0` behave exactly as
on uint32."""

import collections

import torch

from ..gm import gaussian
from ..gm.mixture import topk_stable

NEG = -1.0e30


def bit_of(idx):
    """1 << (idx % 32) as int32 bit patterns (bit 31 -> INT32_MIN)."""
    shift = torch.remainder(idx, 32).to(torch.int64)
    bits = torch.bitwise_left_shift(torch.ones_like(shift), shift)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def prepare_options(ll, log_miss, log_clutter, n_mask, m_mask, max_candidates=8):
    """Per-measurement option vectors for the beam scan, batched over any
    leading dims.

    ll [..., N, M], log_miss [..., N], n_mask [..., N], m_mask [..., M].
    Returns (base [...], opt_delta [..., M, C+1], word_k [..., M, C] int32,
    bit_k [..., M, C] int32, n_words): slot 0 = clutter, slot 1+j = the j-th
    best gated landmark (ties to the lower landmark index, as lax.top_k)."""
    n, m = ll.shape[-2], ll.shape[-1]
    c = min(max_candidates, n)
    dtype = ll.dtype
    base = torch.sum(torch.where(n_mask, log_miss, torch.zeros_like(log_miss)), dim=-1)
    ok = (ll > NEG / 2) & n_mask[..., :, None]
    delta = torch.where(ok, ll - log_miss[..., :, None], torch.full_like(ll, NEG))
    cand_delta, cand_idx = topk_stable(delta.transpose(-1, -2), c)  # [..., M, C]

    clutter = torch.as_tensor(log_clutter, dtype=dtype, device=ll.device)
    opt_delta = torch.cat(
        [clutter.expand(cand_delta.shape[:-1] + (1,)), cand_delta], dim=-1
    )
    inactive = torch.cat([  # built on the device: no host-to-device copy
        torch.zeros(1, dtype=dtype, device=ll.device),
        torch.full((c,), NEG, dtype=dtype, device=ll.device),
    ])
    opt_delta = torch.where(m_mask[..., :, None], opt_delta, inactive)

    n_words = (n + 31) // 32
    word_k = torch.div(cand_idx, 32, rounding_mode="floor").to(torch.int32)
    return base, opt_delta, word_k, bit_of(cand_idx), n_words


def beam_scan(base, opt_delta, word_k, bit_k, beam_width, n_words):
    """Sequential beam over measurements, batched over a leading particle
    axis. base [P], opt_delta [P, M, C+1], word_k / bit_k [P, M, C] int32.
    Returns the final top-`beam_width` scores [P, B] (NEG = empty slot),
    sorted descending with ties to the lower flat index.

    Differentiable in base and opt_delta: each kept score is base plus the
    option deltas along its path, so with a gradient wanted the scan runs
    without autograd, records every kept hypothesis' choices, and the
    scores carry the gradient of base + sum(picked deltas) -- what autograd
    through the scan's top-B selections gives (the selection is piecewise
    constant), at the cost of one gather instead of M steps of graph.
    On CUDA tensors the scan is one replay of a CUDA graph (_scan_graphed)."""
    scan = _scan_graphed if opt_delta.device.type == "cuda" else _scan
    if torch.is_grad_enabled() and (base.requires_grad or opt_delta.requires_grad):
        with torch.no_grad():
            scores, path = scan(base, opt_delta, word_k, bit_k, beam_width, n_words, paths=True)
        picked = torch.gather(opt_delta[:, None].expand(-1, beam_width, -1, -1), 3, path[..., None])
        tied = base[:, None] + torch.sum(picked[..., 0], dim=-1)
        return scores + (tied - tied.detach())  # the scan's values, the paths' gradient
    return scan(base, opt_delta, word_k, bit_k, beam_width, n_words)


def _scan(base, opt_delta, word_k, bit_k, beam_width, n_words, paths=False):
    """The beam scan proper (see beam_scan); with paths=True it also returns
    each kept hypothesis' option index at every step, [P, B, M]."""
    p, m, c1 = opt_delta.shape
    b = beam_width
    dev = opt_delta.device
    scores = torch.full((p, b), NEG, dtype=opt_delta.dtype, device=dev)
    scores[:, 0] = base
    words = torch.zeros((p, b, n_words), dtype=torch.int32, device=dev)
    # a candidate whose word lies outside the used set is never used: its bit
    # reads as 0
    in_range = (word_k >= 0) & (word_k < n_words)
    widx = torch.where(in_range, word_k, 0).long()
    bits = torch.where(in_range, bit_k, 0)
    w_iota = torch.arange(n_words, device=dev)
    srcs, choices = [], []
    for step in range(m):
        dk, wk, bk = opt_delta[:, step], word_k[:, step], bit_k[:, step]
        # membership: each candidate's word of each hypothesis, AND its bit
        uw = torch.gather(words, 2, widx[:, None, step].expand(-1, b, -1))
        used = (uw & bits[:, None, step]) != 0  # [P, B, C]
        opts = torch.cat([dk[:, None, 0:1].expand(-1, b, 1), torch.where(used, NEG, dk[:, None, 1:])], 2)
        vals, order = torch.sort((scores[:, :, None] + opts).reshape(p, b * c1), dim=-1,
                                 descending=True, stable=True)
        scores, flat = vals[:, :b], order[:, :b]
        src = torch.div(flat, c1, rounding_mode="floor")
        choice = flat % c1  # 0 = clutter, 1 + j = candidate j
        # the picked candidate's (word, bit); clutter adds nothing
        pick = torch.clamp(choice - 1, min=0)
        pw = torch.where(choice > 0, torch.gather(wk, 1, pick), 0)
        pb = torch.where(choice > 0, torch.gather(bk, 1, pick), 0)
        g = torch.gather(words, 1, src[:, :, None].expand(-1, -1, n_words))
        words = g | torch.where(pw[:, :, None] == w_iota, pb[:, :, None], 0)
        if paths:
            srcs.append(src)
            choices.append(choice)
    if not paths:
        return scores
    slot, path = torch.arange(b, device=dev).expand(p, b), [None] * m
    for step in range(m - 1, -1, -1):  # walk each kept hypothesis back to the start
        path[step] = torch.gather(choices[step], 1, slot)
        slot = torch.gather(srcs[step], 1, slot)
    return scores, torch.stack(path, dim=-1)


# CUDA graphs of _scan, by device, dtype, shape, width, words and paths; past
# GRAPH_CAP shapes the least recently used goes, with its memory pool (a
# smoother run replays a few shapes).
_GRAPHS = collections.OrderedDict()
GRAPH_CAP = 32


def _scan_graphed(base, opt_delta, word_k, bit_k, beam_width, n_words, paths=False):
    """_scan on CUDA tensors as one replay of a CUDA graph captured at the
    first call of each shape: eager, the scan is ~20 small launches a step
    and bound by the host. Same kernels, same results."""
    key = (opt_delta.device, opt_delta.dtype, tuple(opt_delta.shape), beam_width, n_words, paths)
    if key in _GRAPHS:
        _GRAPHS.move_to_end(key)
    else:
        with torch.cuda.device(opt_delta.device):
            static = [x.clone() for x in (base, opt_delta, word_k, bit_k)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up outside the capture
                _scan(*static, beam_width, n_words, paths)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _scan(*static, beam_width, n_words, paths)
        _GRAPHS[key] = graph, static, out
        if len(_GRAPHS) > GRAPH_CAP:
            _GRAPHS.popitem(last=False)
    graph, static, out = _GRAPHS[key]
    for dst, src in zip(static, (base, opt_delta, word_k, bit_k)):
        dst.copy_(src)
    graph.replay()
    return tuple(o.clone() for o in out) if paths else out.clone()


def logsumexp_scores(scores):
    """logsumexp over the live beam slots (NEG slots are empty)."""
    live = torch.where(scores > NEG / 2, scores, torch.full_like(scores, -float("inf")))
    return torch.logsumexp(live, dim=-1)


def set_log_likelihood(ll, log_miss, log_clutter, n_mask, m_mask, beam_width,
                       max_candidates=8):
    """Truncated sum over data associations (batched over a leading particle
    axis): logsumexp over the top-`beam_width` assignments. Each assignment
    maps every measurement to clutter or a distinct landmark; unassigned
    landmarks contribute log_miss."""
    base, od, wk, bk, n_words = prepare_options(
        ll, log_miss, log_clutter, n_mask, m_mask, max_candidates
    )
    return logsumexp_scores(beam_scan(base, od, wk, bk, beam_width, n_words))


def association_matrices(model, pose, map_means, meas_cov, pd, fuzzy_pd=False, ramp=None,
                         depth_map=None):
    """Association pieces (SetLogLikeMatrix, PHDNavigator.cs:415-453 / the
    quasi variant :567-635). pose [..., S] broadcasts against map_means
    [..., N, 3] through a singleton landmark axis. With fuzzy_pd=False
    (the quasi variant, every caller in the port) PD is the constant pd;
    with fuzzy_pd=True it is the model's fuzzy visibility of each predicted
    measurement under `ramp`, times pd, a depth-occlusion model (Kinect)
    seeing through `depth_map` (model.fuzzy_visible_fn). Returns
    (mu [..., N, D], log_pd [..., N], log_miss [..., N], r_inv [D, D], logmult)."""
    mu = model.measure(model.params, pose[..., None, :], map_means)
    if fuzzy_pd:
        pdv = model.fuzzy_visible_fn(depth_map)(model.params, mu, ramp) * pd
    else:
        pdv = torch.as_tensor(pd, dtype=mu.dtype, device=mu.device).expand(mu.shape[:-1])
    pdv = torch.clamp(pdv, 1e-30, 1.0 - 1e-7)
    return mu, torch.log(pdv), torch.log1p(-pdv), gaussian.inv(meas_cov), gaussian.log_multiplier(meas_cov)


def likelihood_matrix(mu, log_pd, logmult, r_inv, z, gate):
    """ll[..., i, k] = log PD_i + log mult - 0.5 d^2 where the Mahalanobis
    distance d < gate, else NEG (PHDNavigator.cs:433-442). mu [..., N, D],
    z [..., M, D]."""
    diff = z[..., None, :, :] - mu[..., :, None, :]  # [..., N, M, D]
    d2 = torch.einsum("...nmd,de,...nme->...nm", diff, r_inv, diff)
    ll = log_pd[..., None] + logmult - 0.5 * d2
    return torch.where(d2 < gate * gate, ll, torch.full_like(ll, NEG))


def quasi_set_log_likelihood(model, meas_cov, pd, log_clutter, pose, map_means, map_mask, z,
                             z_mask, beam_width=200, lm_cov=None, beam=None):
    """QuasiSetLogLikelihood (PHDNavigator.cs:526-713): constant PD, gate
    12, visibility ignored; batched over the leading dims, which broadcast:
    pose [..., S], map_means [..., N, 3], map_mask [..., N], z [..., M, D],
    z_mask [..., M], lm_cov [..., N, 3, 3]. Returns [...].

    With `lm_cov` the innovation covariance of landmark i is
    S_i = J_i P_i J_i^T + R, and a two-sided gate (0 <= d^2 < 144) keeps an
    indefinite S from scoring astronomically high.

    beam: the beam scan of a call that needs no gradient (phd.route's
    `beam`: the kernel's wrapper for float32, one launch for every row);
    None takes the plain beam. Gradients and Hessians always go through the
    plain beam under torch.autograd."""
    lead = [pose.shape[:-1], map_means.shape[:-2], map_mask.shape[:-1], z.shape[:-2],
            z_mask.shape[:-1]] + ([lm_cov.shape[:-3]] if lm_cov is not None else [])
    batch = torch.broadcast_shapes(*lead)
    n, m = map_means.shape[-2], z.shape[-2]
    pose = pose.expand(batch + pose.shape[-1:]).reshape(-1, pose.shape[-1])
    map_means = map_means.expand(batch + (n, 3)).reshape(-1, n, 3)
    map_mask = map_mask.expand(batch + (n,)).reshape(-1, n)
    z = z.expand(batch + z.shape[-2:]).reshape(-1, m, z.shape[-1])
    z_mask = z_mask.expand(batch + (m,)).reshape(-1, m)
    mu, log_pd, log_miss, r_inv, logmult = association_matrices(model, pose, map_means, meas_cov, pd)
    if lm_cov is not None:
        lm_cov = lm_cov.expand(batch + (n, 3, 3)).reshape(-1, n, 3, 3)
        jl = model.jac_landmark(model.params, pose[:, None, :], map_means)
        jl = jl.expand(mu.shape + (3,))  # [P, N, D, 3]
        s = torch.einsum("pnda,pnab,pneb->pnde", jl, lm_cov, jl) + meas_cov
        diff = z[:, None, :, :] - mu[:, :, None, :]
        d2 = torch.einsum("pnmd,pnde,pnme->pnm", diff, gaussian.inv(s), diff)
        ll = log_pd[..., None] + gaussian.log_multiplier(s)[..., None] - 0.5 * d2
        ll = torch.where((d2 >= 0.0) & (d2 < 144.0), ll, torch.full_like(ll, NEG))
    else:
        ll = likelihood_matrix(mu, log_pd, logmult, r_inv, z, 12.0)
    ll = torch.where(z_mask[:, None, :], ll, torch.full_like(ll, NEG))
    base, od, wk, bk, n_words = prepare_options(ll, log_miss, log_clutter, map_mask, z_mask)
    if beam is None or (torch.is_grad_enabled() and pose.requires_grad):
        beam = beam_scan
    return logsumexp_scores(beam(base, od, wk, bk, beam_width, n_words)).reshape(batch)
