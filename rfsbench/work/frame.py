"""fp32 operations of one SLAM frame, stage by stage, from its shapes and
the live counts of its data. The count belongs to the stage, not to what
implements it: a stage later fused into a kernel keeps its count, and the
correct stage is counted alike for the fused kernel and the depth-model
stage. Where the data decides the work (live components, live
measurements, the MAP estimate's size) it counts what these inputs need.

  predict    per particle two pose compositions (odometry, then the noise;
             ~60 operations each: a quaternion product and a rotation) and
             the T x T noise product;
  correct    births, the EKF of live components, the gate tests and pair
             likelihoods, the cut and the merge relation (kernels.fused_ops);
  weight     the MAP estimate's selection (4 copies of K), the predicted and
             corrected mixtures' log density at each of the E estimate
             points over their live components (~30 operations a term),
             the gated likelihood of each (point, live measurement) pair
             (~25) and the per-measurement candidate selection (E);
  beam       kernels.beam_work's operations;
  resample   logsumexp, ESS, cumulative sum and the wheel (~10 a particle)."""

import torch

from .kernels import DEAD, beam_work, fused_ops

POSE_COMPOSE = 60
TERM = 30
PAIR = 25
RESAMPLE = 10


def _alive(logw):
    return logw > DEAD / 2


def map_estimate_size(cor_logw, cap):
    """The MAP estimate's size per particle: floor(sum of weights), at most
    cap."""
    w = torch.where(_alive(cor_logw), torch.exp(cor_logw.double()), torch.zeros_like(cor_logw.double()))
    return torch.clamp(torch.floor(w.sum(1)), max=cap).to(torch.int64)


def stage_ops(p, t_dim, maps, pred, z_mask, cor, density_radius, m, estimate_cap, beam_width,
              beam_candidates, n_words):
    """{stage: fp32 operations} of one frame. maps / pred / cor: SGM-ordered
    leaves [P, K0], [P, K0+M], [P, K0]; z_mask [M]."""
    k0 = maps[-1].shape[1]
    e = map_estimate_size(cor[-1], estimate_cap)
    m_live = int(z_mask.sum())
    live_pred = _alive(pred[-1]).sum(1)
    live_cor = _alive(cor[-1]).sum(1)
    weight = (4 * k0 + TERM * e * (live_pred + live_cor) + PAIR * e * m_live + estimate_cap * m).sum()
    c = min(beam_candidates, estimate_cap)
    return {
        "predict": p * (2 * POSE_COMPOSE + 2 * t_dim * t_dim),
        "correct": fused_ops(maps, pred, z_mask, cor, density_radius, m),
        "weight": int(weight),
        "beam": beam_work(p, m, c, beam_width, n_words)[1],
        "resample": p * RESAMPLE,
    }
