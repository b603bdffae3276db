"""Bytes and fp32 operations of one launch of each hand-written kernel: a
frozen copy of the port's kernel_bounds.beam_work and fused_work (the tests
hold them equal at small shapes), and the least time of a launch at the
peaks of peaks.json."""

import numpy as np
import torch

DEAD = -1.0e30


def least_ms(nbytes, ops, peaks):
    """(ms, "bytes" or "operations"): the larger of the two times at the
    published peaks."""
    t_bytes = nbytes / peaks["hbm_bytes_s"] * 1e3
    t_ops = ops / peaks["fp32_ops_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def beam_work(p, m, c, b, n_words):
    """(bytes, fp32 operations) of one beam launch on option tensors base
    [P], opt_delta [P, M, C+1], word_k / bit_k [P, M, C] with beam width b:
    each input read once, the [P, B] scores written once; per step what a
    top-B selection needs (nc candidate sums, B*C used-set ANDs, nc +
    B*log2(nc) compares)."""
    c1 = c + 1
    nbytes = 4 * (p + p * m * c1 + 2 * p * m * c + p * b)
    nc = b * c1
    ops = p * m * (nc + b * c + nc + b * int(np.ceil(np.log2(nc))))
    return nbytes, ops


def fused_ops(maps, pred, z_mask, cor, density_radius, m):
    """fp32 operations this data needs (a lower count): density terms of the
    live map components, the EKF of live predicted components, every gate
    test and the likelihood of in-gate pairs, the cut's counts (one, or 31
    when the cap may bind), the merge relation over surviving pairs. maps
    [P, K0], pred [P, K0+M] and cor [P, K0]: SGM-ordered leaves (logw
    last)."""
    k0 = maps[-1].shape[1]
    kp = k0 + m
    alive0 = (maps[-1] > DEAD / 2).sum(1)
    alive = pred[-1] > DEAD / 2
    bp = [leaf[:, k0:] for leaf in pred[:3]]
    d2 = sum((b[:, :, None] - mm[:, None, :]) ** 2 for b, mm in zip(bp, pred[:3]))
    rows = z_mask if z_mask.dim() == 2 else z_mask[None, :]
    in_gate = (d2 <= density_radius ** 2) & alive[:, None, :] & rows[:, :, None]
    n_gate = in_gate.sum((1, 2))
    counts = torch.where(alive.sum(1) + n_gate > k0, 31, 1)
    n_out = (cor[-1] > DEAD / 2).sum(1)
    ops = (alive0 * m * 30 + alive.sum(1) * 250 + m * kp * 8 + n_gate * 35
           + counts * (kp + m * kp) + n_out * (n_out - 1) // 2 * 25)
    return int(ops.sum().item())


def fused_work(p, k0, m, d, s_dim, maps, pred, z_mask, cor, density_radius):
    """(bytes, fp32 operations) of one fused launch: every input read once
    and every output written once, against this data's operation count."""
    kp = k0 + m
    nbytes = 4 * (10 * p * k0 + s_dim * p + d * m + z_mask.numel() + 16 + d + d * d + 10 * p * kp
                  + 10 * p * k0)
    return nbytes, fused_ops(maps, pred, z_mask, cor, density_radius, m)
