"""The association beam of the PHD weight update, plain PyTorch: a frozen
copy of the port's plain beam (slam/association.py: prepare_options, the
sequential scan and the logsumexp over its scores), which the port's beam
kernel (csrc/beam_scan.cu) equals bit for bit.

A beam element is a partial association: each measurement so far maps to
clutter or to a distinct landmark (injective through a packed used-set
bitmask, int32 words with uint32 bit patterns). Summing the top-B
assignment scores gives the truncated set likelihood."""

import torch

from .mixture import topk_stable

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
    return scores


def logsumexp_scores(scores):
    """logsumexp over the live beam slots (NEG slots are empty)."""
    live = torch.where(scores > NEG / 2, scores, torch.full_like(scores, -float("inf")))
    return torch.logsumexp(live, dim=-1)
