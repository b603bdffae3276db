"""Set log-likelihood by beam enumeration over data associations
(PHDNavigator.cs:415-713, GraphCombinatorics.cs:42-792): the torch twin of
monorfs_tpu.slam.association.

A beam element is a partial association: each measurement so far maps to
clutter or to a distinct landmark (injective through a packed used-set
bitmask). Summing the top-B assignment scores gives the truncated set
likelihood; with B above the number of reachable assignments it is exact.

The used-set words are uint32 in JAX. Here they are int32 with the same bit
patterns: bit 31 is the sign bit, and `&`, `|` and `!= 0` behave exactly as
on uint32."""

import torch

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
    sorted descending with ties to the lower flat index."""
    p, m, c1 = opt_delta.shape
    c = c1 - 1
    b = beam_width
    dev = opt_delta.device
    scores = torch.full((p, b), NEG, dtype=opt_delta.dtype, device=dev)
    scores[:, 0] = base
    words = torch.zeros((p, b, n_words), dtype=torch.int32, device=dev)
    cand_j = torch.arange(1, c + 1, device=dev)
    for step in range(m):
        dk, wk, bk = opt_delta[:, step], word_k[:, step], bit_k[:, step]
        # membership: each candidate's word of each hypothesis, AND its bit
        in_range = (wk >= 0) & (wk < n_words)
        widx = torch.where(in_range, wk, torch.zeros_like(wk)).long()
        uw = torch.gather(words, 2, widx[:, None, :].expand(p, b, c))
        uw = torch.where(in_range[:, None, :], uw, torch.zeros_like(uw))
        used = (uw & bk[:, None, :]) != 0  # [P, B, C]
        neg = torch.full(used.shape, NEG, dtype=dk.dtype, device=dev)
        land = scores[:, :, None] + torch.where(used, neg, dk[:, None, 1:])
        clut = scores[:, :, None] + dk[:, None, 0:1]
        cand = torch.cat([clut, land], dim=2).reshape(p, b * c1)
        scores, flat = topk_stable(cand, b)
        src = torch.div(flat, c1, rounding_mode="floor")
        choice = flat % c1  # 0 = clutter, 1 + j = candidate j
        onehot = choice[:, :, None] == cand_j  # [P, B, C]
        pw = torch.sum(torch.where(onehot, wk[:, None, :], torch.zeros_like(wk[:, None, :])), dim=2)
        pb = torch.sum(torch.where(onehot, bk[:, None, :], torch.zeros_like(bk[:, None, :])), dim=2)
        g = torch.gather(words, 1, src[:, :, None].expand(p, b, n_words))
        w_iota = torch.arange(n_words, device=dev)
        words = g | torch.where(
            pw[:, :, None] == w_iota, pb[:, :, None], torch.zeros_like(g)
        ).to(torch.int32)
    return scores


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
