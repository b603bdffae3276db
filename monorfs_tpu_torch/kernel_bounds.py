"""The least time one H100 could take for a launch of each hand-written
kernel: the bytes the launch must move (each input read once, each output
written once) over the card's memory rate, and the fp32 operations its data
needs over the card's fp32 rate, whichever is larger.

The rates are NVIDIA's published peaks of the SXM part at its 700 W limit
(HBM 3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores); `bound` takes
other rates, such as ceilings measured on the card (tools/roofline_phd.py).
chip_smoke.py and tools/roofline_phd.py both count work with these
functions."""

import numpy as np
import torch

from .gm.mixture import DEAD

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_S = 67e12  # H100 SXM fp32 outside the tensor cores


def bound(nbytes, ops, bytes_s=HBM_BYTES_S, ops_s=FP32_OPS_S):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / bytes_s * 1e3, ops / ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def beam_work(inputs, b):
    """(bytes, fp32 operations) of one beam launch on these option tensors
    (base [P], opt_delta [P, M, C+1], word_k / bit_k [P, M, C]) with beam
    width b."""
    base, od, wk, bk = inputs
    p, m, c1 = od.shape
    c = c1 - 1
    nbytes = 4 * (base.numel() + od.numel() + wk.numel() + bk.numel() + p * b)
    nc = b * c1
    # per step, what a top-B selection needs: nc candidate sums, B*C used-set
    # ANDs, and nc + B*log2(nc) compares to pick the best B in order
    ops = p * m * (nc + b * c + nc + b * int(np.ceil(np.log2(nc))))
    return nbytes, ops


def beam_bound(inputs, b, **rates):
    """(bound ms, bound by) of one beam launch on these inputs."""
    return bound(*beam_work(inputs, b), **rates)


def fused_ops(maps, pred, z_mask, cor, params, m):
    """fp32 operations this data needs (a lower count): density terms of the
    live map components, the EKF of live predicted components, every gate
    test and the likelihood of in-gate pairs, the cut's counts (one, or 31
    when the cap may bind), the merge relation over surviving pairs."""
    k0 = maps.logw.shape[1]
    kp = k0 + m
    alive0 = (maps.logw > DEAD / 2).sum(1)
    alive = pred.logw > DEAD / 2
    bp = [leaf[:, k0:] for leaf in pred[:3]]
    d2 = sum((b[:, :, None] - mm[:, None, :]) ** 2 for b, mm in zip(bp, pred[:3]))
    rows = z_mask if z_mask.dim() == 2 else z_mask[None, :]  # [M] or one mask per particle
    in_gate = (d2 <= params.density_radius ** 2) & alive[:, None, :] & rows[:, :, None]
    n_gate = in_gate.sum((1, 2))
    counts = torch.where(alive.sum(1) + n_gate > k0, 31, 1)
    n_out = (cor.logw > DEAD / 2).sum(1)
    ops = (alive0 * m * 30 + alive.sum(1) * 250 + m * kp * 8 + n_gate * 35
           + counts * (kp + m * kp) + n_out * (n_out - 1) // 2 * 25)
    return int(ops.sum().item())


def fused_work(p, k0, m, d, s_dim, maps, pred, z_mask, cor, params):
    """(bytes, fp32 operations) of one fused launch: every input read once
    and every output written once, against this data's operation count."""
    kp = k0 + m
    nbytes = 4 * (10 * p * k0 + s_dim * p + d * m + z_mask.numel() + 16 + d + d * d + 10 * p * kp
                  + 10 * p * k0)
    return nbytes, fused_ops(maps, pred, z_mask, cor, params, m)


def fused_bound(p, k0, m, d, s_dim, maps, pred, z_mask, cor, params, **rates):
    """(bound ms, bound by) of one fused launch."""
    return bound(*fused_work(p, k0, m, d, s_dim, maps, pred, z_mask, cor, params), **rates)


def mixture_work(predicted, corrected, jmeans, jvalid):
    """(bytes, fp32 operations) of one launch of the mixture likelihood
    kernel: both maps' leaves, the MAP means and their valid rows read once
    and rest [P] written once; per live component its inverse and
    log-multiplier (~45 operations with the weight's exp), per (valid row,
    live component) pair its score and its term of the log-sum-exp (~35)."""
    p, e = jvalid.shape
    kp, kc = predicted.logw.shape[1], corrected.logw.shape[1]
    nbytes = 4 * (10 * p * (kp + kc) + 3 * p * e + p) + p * e
    live = (predicted.logw > DEAD / 2).sum(1) + (corrected.logw > DEAD / 2).sum(1)
    ops = (45 * live + 35 * jvalid.sum(1) * live).sum()
    return nbytes, int(ops.item())


def mixture_bound(predicted, corrected, jmeans, jvalid, **rates):
    """(bound ms, bound by) of one mixture likelihood launch."""
    return bound(*mixture_work(predicted, corrected, jmeans, jvalid), **rates)


def assoc_work(p, e, m, mz, c, d, s_dim, live_rows):
    """(bytes, fp32 operations) of one launch of the association kernel:
    the poses, the MAP means and their valid rows, the slots and their mask
    read once, base, opt_delta, word_k and bit_k written once; per (particle,
    MAP row) its predicted measurement, visibility and logs (~60
    operations), per (particle, MAP row, live measurement row) pair its
    difference, quadratic form, log-likelihood and delta (D + 3 D^2 + 4)."""
    nbytes = 4 * (p * s_dim + 3 * p * e + mz * d + 3 + d + d * d + p + p * m * (c + 1) + 2 * p * m * c) + p * e + mz
    return nbytes, p * e * 60 + p * e * live_rows * (d + 3 * d * d + 4)


def assoc_bound(p, e, m, mz, c, d, s_dim, live_rows, **rates):
    """(bound ms, bound by) of one association options launch."""
    return bound(*assoc_work(p, e, m, mz, c, d, s_dim, live_rows), **rates)
