"""Rao-Blackwellized PHD SLAM step (PHDNavigator.cs:48-983): the torch twin
of the SoA step of monorfs_tpu.slam.phd.

State is fixed-shape tensors: poses [P, 7], log-weights [P] and per-particle
SoA mixture maps [P, K] with dead-slot masking. One step runs, as
make_slam_step wires it on the TPU (phd.py:574-635):

  predict   every particle moves by the odometry plus motion noise;
  compact   measurements are gathered live-first (stable) into meas_compact
            slots, shared by all particles;
  fused     births + EKF correct + prune/merge (slam/fused_kernel.py);
  weight    the MAP-estimate weight inputs per particle, then the
            association beam over all particles (slam/beam_kernel.py);
  normalise logsumexp with a NaN guard, then the ESS test and systematic
            resampling, selected with torch.where so a frame needs no host
            sync.

Randomness is injected: the step takes the motion normals [P, 6] and the
resample uniform [] as tensors.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..gm import mixture, smallmat
from ..gm.gaussian import sqrt_cov
from ..gm.mixture import SGM
from . import association, beam_kernel, fused_kernel

# log(1e-300): the reference's float64 density floor, pinned in log space so
# float32 runs keep the float64 semantics (phd.py:52-56 of the JAX package).
LOG_EVAL_FLOOR = -690.77552789821368


@dataclasses.dataclass(frozen=True)
class PHDConfig:
    """Static shape/algorithm configuration (field for field the JAX one)."""

    num_particles: int = 200
    max_components: int = 600  # MaxQuantity (Config.cs:83)
    max_measurements: int = 32
    gate_top: int = 16  # per-measurement survivor cap of the fused stage
    estimate_cap: int = 128  # cap on the MAP map estimate size
    beam_width: int = 200  # association hypotheses (PHDNavigator.cs:469)
    beam_meas_cap: int = 0  # beam scan length; 0 = max_measurements
    beam_candidates: int = 8  # gated landmarks enumerated per measurement
    merge_rounds: int = 8  # prune-merge leader fixed-point iterations
    meas_compact: int = 0  # live-first measurement slots for the step; 0 = off


class PHDParams(NamedTuple):
    """Navigator parameters as tensors (Config.cs:63-103)."""

    motion_cov: torch.Tensor  # [T, T] navigator motion covariance
    motion_sqrt: torch.Tensor  # [T, T] its eigen factor (gm.gaussian.sqrt_cov)
    meas_cov: torch.Tensor  # [D, D]
    pd: torch.Tensor
    clutter_density: torch.Tensor
    birth_weight: torch.Tensor
    birth_cov: torch.Tensor  # [3, 3]
    min_weight: torch.Tensor
    merge_threshold: torch.Tensor
    exploration_threshold: torch.Tensor
    density_radius: torch.Tensor
    min_effective_particle: torch.Tensor
    visibility_ramp: torch.Tensor  # [D]
    dt: torch.Tensor  # frame time (scales motion noise)


def make_params(*, dtype=torch.float32, device="cuda", **fields):
    """PHDParams from numbers or arrays; the motion factor is computed on the
    host in float64 from motion_cov."""
    dev = resolve_device(device)
    vals = {
        name: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=dev)
        for name, v in fields.items()
    }
    vals["motion_sqrt"] = torch.as_tensor(
        sqrt_cov(fields["motion_cov"]), dtype=dtype, device=dev
    )
    return PHDParams(**vals)


class PHDState(NamedTuple):
    pose: torch.Tensor  # [P, S]
    logweight: torch.Tensor  # [P]
    maps: SGM  # leaves [P, K]
    best: torch.Tensor  # [] int64
    ancestor: torch.Tensor  # [P] int64: source slot of each particle at the
    # last step (identity when no resample fired)


def init_state(model, cfg: PHDConfig, init_pose, dtype=torch.float32, device="cuda"):
    dev = resolve_device(device)
    p = cfg.num_particles
    pose = torch.as_tensor(np.asarray(init_pose, np.float64), dtype=dtype, device=dev)
    return PHDState(
        pose=pose.expand(p, pose.shape[0]).clone(),
        logweight=torch.full((p,), -float(np.log(p)), dtype=dtype, device=dev),
        maps=mixture.empty_soa(cfg.max_components, dtype, batch=(p,), device=dev),
        best=torch.zeros((), dtype=torch.int64, device=dev),
        ancestor=torch.arange(p, device=dev),
    )


def predict_poses(model, params: PHDParams, state: PHDState, odometry, normals):
    """Motion update (PHDNavigator.cs:295-314): each particle moves by the
    odometry plus dt * L n, L the motion factor, n ~ normals [P, T]."""
    moved = model.pose.add_odometry(state.pose, odometry[None, :])
    noise = params.dt * torch.sum(params.motion_sqrt[None, :, :] * normals[:, None, :], dim=-1)
    return state._replace(pose=model.pose.add_odometry(moved, noise))


def live_first(z_mask, n):
    """Indices of the first n slots in live-first stable order."""
    return torch.argsort((~z_mask).to(torch.uint8), stable=True)[:n]


def weight_inputs(model, cfg, params, pose, predicted: SGM, corrected: SGM, z, z_mask):
    """Per-particle weight-stage inputs (WeightAlpha, PHDNavigator.cs:373-453):
    rest = (plog - n_pred) - (clog - n_corr) on the MAP estimate of the
    corrected map, and the association beam's option tensors.

    Returns (rest [P], base [P], opt_delta [P, M, C+1], word_k, bit_k)."""
    mp = model.params
    jidx, jvalid = mixture.best_map_indices(corrected.logw, cfg.estimate_cap)  # [P, E]
    mfeat = torch.stack(corrected.mean_list(), dim=-1)
    mfeat = torch.where(torch.isfinite(mfeat), mfeat, torch.zeros_like(mfeat))
    jm = torch.gather(mfeat, 1, jidx[..., None].expand(-1, -1, 3))
    jmeans = [jm[..., i] for i in range(3)]

    def mixture_loglike(gm):
        lv = torch.clamp(mixture.log_evaluate_many_soa(gm, jmeans), min=LOG_EVAL_FLOOR)
        return torch.sum(torch.where(jvalid, lv, torch.zeros_like(lv)), dim=-1)

    rest = (mixture_loglike(predicted) - mixture.expected_size(predicted)) - (
        mixture_loglike(corrected) - mixture.expected_size(corrected)
    )

    # valid measurements first, capped at the beam length
    order = live_first(z_mask, cfg.beam_meas_cap or z.shape[0])
    zc = torch.where(torch.isfinite(z), z, torch.zeros_like(z))[order]
    zc_mask = z_mask[order]

    # gated association log-likelihood [P, E, M] (PHDNavigator.cs:415-453)
    mu = model.measure_soa(mp, pose, jmeans)
    pdv = model.fuzzy_visible_soa(mp, mu, params.visibility_ramp) * params.pd
    pdv = torch.clamp(pdv, 1e-30, 1.0 - 1e-7)
    log_pd, log_miss = torch.log(pdv), torch.log1p(-pdv)
    r = smallmat.from_tensor(params.meas_cov)
    det_r = smallmat.det(r)
    r_inv = smallmat.inv(r, det_r)
    logmult = smallmat.log_multiplier(r, det_r)
    diffz = [zc[:, i][None, None, :] - mi[:, :, None] for i, mi in enumerate(mu)]
    d2 = smallmat.quadform(diffz, r_inv)
    ll = log_pd[..., None] + logmult - 0.5 * d2
    neg = torch.full_like(ll, association.NEG)
    ll = torch.where(d2 < 25.0, ll, neg)  # Mahalanobis gate 5
    ll = torch.where(zc_mask[None, None, :], ll, neg)
    base, od, wk, bk, _ = association.prepare_options(
        ll, log_miss, torch.log(params.clutter_density), jvalid, zc_mask,
        cfg.beam_candidates,
    )
    return rest, base, od, wk, bk


def resample(state: PHDState, u):
    """Systematic (wheel) resampling (PHDNavigator.cs:724-760); u is one
    uniform in [0, 1)."""
    p = state.logweight.shape[0]
    lw = state.logweight
    w = torch.exp(lw - torch.logsumexp(lw, dim=0))
    cum = torch.cumsum(w, dim=0)
    positions = u / p + torch.arange(p, dtype=lw.dtype, device=lw.device) / p
    src = torch.clamp(torch.searchsorted(cum, positions, side="left"), 0, p - 1)
    # BestParticle: the last drawn slot whose source holds the max weight
    sel_w = w[src]
    best = p - 1 - torch.argmax(torch.flip(sel_w, dims=(0,)))
    return PHDState(
        pose=state.pose[src],
        logweight=torch.full_like(lw, -float(np.log(p))),
        maps=mixture.map_soa(lambda a: a[src], state.maps),
        best=best,
        ancestor=src,
    )


def _normalise_resample(params, state, corrected, scores, rest, resample_u):
    """Weight update, NaN-guarded normalisation and the ESS test with
    systematic resampling; both ESS branches are computed and selected with
    torch.where, so no value goes to the host."""
    logweight = state.logweight + (association.logsumexp_scores(scores) + rest)
    norm = torch.logsumexp(logweight, dim=0)
    logweight = torch.where(torch.isfinite(norm), logweight - norm, state.logweight)
    p = logweight.shape[0]
    state = PHDState(
        state.pose, logweight, corrected, torch.argmax(logweight),
        torch.arange(p, device=logweight.device),
    )
    # ESS check (ParticleDepleted, :768-777)
    w = torch.exp(logweight)
    ess = 1.0 / torch.clamp(torch.sum(w * w), min=1e-30)
    depleted = ess < params.min_effective_particle * p
    rs = resample(state, resample_u)
    return PHDState(
        pose=torch.where(depleted, rs.pose, state.pose),
        logweight=torch.where(depleted, rs.logweight, state.logweight),
        maps=mixture.map_soa(lambda a, b: torch.where(depleted, a, b), rs.maps, state.maps),
        best=torch.where(depleted, rs.best, state.best),
        ancestor=torch.where(depleted, rs.ancestor, state.ancestor),
    )


def make_slam_step(model, cfg: PHDConfig):
    """The SLAM step: (params, state, odometry [T], z [M, D], z_mask [M],
    motion_normals [P, T], resample_u []) -> state."""
    n_words = (cfg.estimate_cap + 31) // 32
    packed = [None, None]  # the last params seen and their fused-kernel vector

    def step(params, state, odometry, z, z_mask, motion_normals, resample_u):
        if packed[0] is not params:
            packed[:] = params, fused_kernel.pack_params(params)
        with record_function("phd.predict"):
            state = predict_poses(model, params, state, odometry, motion_normals)
            if cfg.meas_compact and cfg.meas_compact < cfg.max_measurements:
                order = live_first(z_mask, cfg.meas_compact)
                z, z_mask = z[order], z_mask[order]
        with record_function("phd.fused_stage"):
            predicted, corrected = fused_kernel.fused_stage(
                model, cfg, params, state.pose, state.maps, z, z_mask, packed[1]
            )
        with record_function("phd.weight_inputs"):
            rest, base, od, wk, bk = weight_inputs(
                model, cfg, params, state.pose, predicted, corrected, z, z_mask
            )
        with record_function("phd.beam_scan"):
            scores = beam_kernel.beam_scan_batch(base, od, wk, bk, cfg.beam_width, n_words)
        with record_function("phd.normalise_resample"):
            return _normalise_resample(params, state, corrected, scores, rest, resample_u)

    return step
