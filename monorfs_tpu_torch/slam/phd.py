"""Rao-Blackwellized PHD SLAM step (PHDNavigator.cs:48-983): the torch twin
of monorfs_tpu.slam.phd, generic over the model family (pose width 1, 2 or
7, measurement dimension 1-3).

State is fixed-shape tensors: poses [P, S], log-weights [P] and per-particle
SoA mixture maps [P, K] with dead-slot masking. One step runs, as
make_slam_step wires it in the JAX package (phd.py:574-635):

  predict   every particle moves by the odometry plus motion noise (mapping
            only: snaps to the true pose);
  compact   measurements are gathered live-first (stable) into meas_compact
            slots, shared by all particles;
  correct   births + EKF correct + prune/merge: the fused stage with the
            kernel's semantics (slam/fused_kernel.py) for float32 and a
            model the kernels take, or the XLA path's semantics
            (xla_stage: one global top-K cut, no gate_top cap, survivors in
            weight order) for float64 and the Kinect model (route);
  weight    the MAP-estimate weight inputs per particle (the two mixture
            likelihoods: slam/mixture_kernel.py; the association options:
            slam/assoc_kernel.py), then the association beam over all
            particles (slam/beam_kernel.py);
  normalise logsumexp with a NaN guard, then the ESS test and systematic
            resampling, selected with torch.where so a frame needs no host
            sync.

Randomness is injected: the step takes the motion normals [P, T] and the
resample uniform [] as tensors. The AoS _births / _correct at the end are
the executable specification the SoA paths are tested against.
"""

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..gm import gaussian, mixture, smallmat
from ..gm.gaussian import sqrt_cov
from ..gm.mixture import ALIVE_THRESHOLD, DEAD, GM, SGM
from ..spans import nested
from . import assoc_kernel, association, beam_kernel, fused_kernel, mixture_kernel
from .assoc_kernel import live_first
from .assignment import first_argmax


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
    depth_map: torch.Tensor  # [H, W] live depth for Kinect visibility (a
    # [1, 1] +inf map for models without depth occlusion)


def make_params(*, dtype=torch.float32, device="cuda", **fields):
    """PHDParams from numbers or arrays; the motion factor is computed on the
    host in float64 from motion_cov; depth_map defaults to a [1, 1] +inf
    map."""
    dev = resolve_device(device)
    fields.setdefault("depth_map", np.full((1, 1), np.inf))
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


def predict_poses(model, params: PHDParams, state: PHDState, odometry, normals,
                  slam=True, true_pose=None):
    """Motion update (PHDNavigator.cs:295-314): each particle moves by the
    odometry plus dt * L n, L the motion factor, n ~ normals [P, T]. In
    mapping-only mode every particle snaps to the reference pose."""
    if not slam:
        return state._replace(pose=true_pose.expand(state.pose.shape).clone())
    moved = model.pose.add_odometry(state.pose, odometry[None, :])
    noise = params.dt * torch.sum(params.motion_sqrt[None, :, :] * normals[:, None, :], dim=-1)
    return state._replace(pose=model.pose.add_odometry(moved, noise))


# =============================================================================
# SoA path with the XLA step's semantics (float64 runs, and the tests' oracle
# for the fused stage's kernel semantics)
# =============================================================================

def _rows(z_mask):
    """A measurement mask as rows that broadcast over particles: [M] -> [1, M];
    [P, M] (one mask per particle) stays."""
    return z_mask if z_mask.dim() == 2 else z_mask[None, :]


def _births_soa(model, params, pose, maps: SGM, zl, z_mask):
    """Birth components at unexplored back-projections (PredictConditional,
    PHDNavigator.cs:793-819 + Explored :956-959), for all particles.

    pose [P, S]; maps leaves [P, K]; zl: D-list of [M]; z_mask [M] or [P, M].
    Returns SGM [P, M]."""
    cand = model.to_map_soa(model.params, pose, [zi[None, :] for zi in zl])  # 3 x [P, M]
    density = mixture.evaluate_many_soa(maps, cand, radius=3.0 * params.density_radius)
    unexplored = _rows(z_mask) & (density < params.exploration_threshold)
    logw = torch.where(
        unexplored, torch.log(params.birth_weight), torch.full_like(density, DEAD)
    )
    return mixture.sgm_make(cand, smallmat.from_tensor(params.birth_cov), logw)


def _correct_prune_soa(model, cfg, params, pose, pred: SGM, zl, z_mask):
    """Measurement update + prune + merge on SoA state for all particles
    (CorrectConditional + PruneModel, PHDNavigator.cs:829-948), with the
    semantics of the JAX package's XLA path:

    1. per-component EKF precompute (h, S, gain, (I-KH)P), unrolled;
    2. dense scalar association scores over all gated (z, component) pairs
       with the exact per-measurement normaliser (:884-899);
    3. one global top-K cut over {misdetections} u {pair updates}, ties to
       the lower index (:921-929); survivors stay in weight order;
    4. the EKF mean / covariance update for survivors only;
    5. greedy weight-ordered Mahalanobis merge (:930-948).

    pose [P, S]; pred leaves [P, K']; zl: D-list of [M]; z_mask [M] or
    [P, M]. Returns SGM [P, max_components]."""
    p, kp = pred.logw.shape
    k_out = cfg.max_components
    m = zl[0].shape[0]
    mp = model.params
    dt, dev = pred.logw.dtype, pred.logw.device
    zero = torch.zeros((), dtype=dt, device=dev)
    dead = torch.full((), DEAD, dtype=dt, device=dev)
    alive = pred.logw > ALIVE_THRESHOLD

    mean = pred.mean_list()  # 3 x [P, K']
    cov = pred.cov_mat()

    # --- per-component EKF precompute (:857-870) -----------------------------
    h = model.measure_soa(mp, pose, mean)  # D x [P, K']
    nd = len(h)
    fuzzy = model.fuzzy_visible_soa_fn(params.depth_map)
    pd_k = torch.where(alive, fuzzy(mp, h, params.visibility_ramp) * params.pd, zero)
    pd_k = torch.clamp(pd_k, 0.0, 1.0 - 1e-7)
    miss_logw = torch.where(alive, pred.logw + torch.log1p(-pd_k), dead)

    hj = model.jac_landmark_soa(mp, pose, mean)  # D x 3 of [P, K']
    hj = [[e.expand(p, kp).to(dt) for e in row] for row in hj]
    pht = smallmat.matmul(cov, smallmat.transpose(hj))  # 3 x D
    s = smallmat.add(smallmat.matmul(hj, pht), smallmat.from_tensor(params.meas_cov))
    det_s = smallmat.det(s)
    s_inv = smallmat.inv(s, det_s)
    s_logmult = smallmat.log_multiplier(s, det_s)
    gain = smallmat.matmul(pht, s_inv)  # 3 x D
    ikh = smallmat.sub(smallmat.identity_like(3, pred.logw), smallmat.matmul(gain, hj))
    cov_upd = smallmat.mat_to_sym(smallmat.symmetrize(smallmat.matmul(ikh, cov)))
    cov_orig = smallmat.mat_to_sym(cov)

    # --- dense pair scores [P, M, K'] (:881-903) -----------------------------
    backproj = model.to_map_soa(mp, pose, [zi[None, :] for zi in zl])  # 3 x [P, M]
    diffp = [b[:, :, None] - mi[:, None, :] for b, mi in zip(backproj, mean)]
    dist2 = sum(dd * dd for dd in diffp)
    r2 = params.density_radius * params.density_radius
    in_gate = (dist2 <= r2) & alive[:, None, :] & _rows(z_mask)[:, :, None]
    innov = [zi[None, :, None] - hi[:, None, :] for zi, hi in zip(zl, h)]
    q_log = s_logmult[:, None, :] - 0.5 * smallmat.quadform(
        innov, [[e[:, None, :] for e in row] for row in s_inv]
    )
    # degenerate components can give non-finite scores: gated out
    q_log = torch.where(torch.isfinite(q_log), q_log, dead)
    log_pd_k = torch.log(torch.clamp(pd_k, min=1e-30))
    log_num = torch.where(in_gate, log_pd_k[:, None, :] + pred.logw[:, None, :] + q_log, dead)
    wsum = torch.sum(torch.where(in_gate, torch.exp(log_num), zero), dim=-1)  # [P, M]
    upd_logw = log_num - torch.log(params.clutter_density + wsum)[:, :, None]
    upd_logw = torch.where(in_gate, upd_logw, dead)

    # --- global weight-sorted cut (PruneModel :921-929) ----------------------
    all_logw = torch.cat([miss_logw, upd_logw.reshape(p, m * kp)], dim=-1)
    top_logw, top_idx = mixture.topk_stable(all_logw, k_out)
    is_miss = top_idx < kp
    pair = torch.clamp(top_idx - kp, min=0)
    comp = torch.where(is_miss, top_idx, pair % kp)
    midx = torch.where(is_miss, torch.zeros_like(pair), torch.div(pair, kp, rounding_mode="floor"))

    # --- survivor channels: exact gathers by index ----------------------------
    chans = list(h) + [e for row in gain for e in row] + list(mean) + list(cov_orig) + list(cov_upd)
    feat = torch.stack([c.expand(p, kp) for c in chans], dim=-1)  # [P, K', C]
    feat = torch.where(torch.isfinite(feat) & alive[..., None], feat, zero)
    gathered = torch.gather(feat, 1, comp[..., None].expand(-1, -1, feat.shape[-1]))
    cols = [gathered[..., i] for i in range(feat.shape[-1])]
    h_s = cols[:nd]
    gain_s = [[cols[nd + i_ * nd + j_] for j_ in range(nd)] for i_ in range(3)]
    base = nd + 3 * nd
    mean_g = cols[base : base + 3]
    cov_g = cols[base + 3 : base + 9]
    covu_g = cols[base + 9 : base + 15]
    z_s = torch.stack(zl, dim=-1)[midx]  # [P, K_out, D]

    # --- survivor mean / covariance update (:893-898) -------------------------
    innov_s = [z_s[..., i] - h_s[i] for i in range(nd)]
    delta = smallmat.matvec(gain_s, innov_s)
    mean_s = [mg + torch.where(is_miss, zero, di) for mg, di in zip(mean_g, delta)]
    cov_s = [torch.where(is_miss, co, cu) for co, cu in zip(cov_g, covu_g)]
    live = (top_logw > ALIVE_THRESHOLD) & (top_logw >= torch.log(params.min_weight))

    # --- greedy weight-ordered merge (:930-948) ------------------------------
    # Survivors arrive weight-sorted; later components merge into the
    # heaviest earlier component within merge_threshold, in the leader's metric.
    covm = smallmat.sym_to_mat(cov_s)
    inv_c = smallmat.inv(covm, smallmat.det(covm))
    diff = [mi[:, None, :] - mi[:, :, None] for mi in mean_s]  # [P, i leader, k]
    m2 = smallmat.quadform(diff, [[e[:, :, None] for e in row] for row in inv_c])
    close = m2 < params.merge_threshold * params.merge_threshold
    idx = torch.arange(k_out, device=dev)
    lower = (idx[:, None] < idx[None, :]) & close & live[:, None, :] & live[:, :, None]
    is_leader = live
    for _ in range(cfg.merge_rounds):
        is_leader = live & ~torch.any(lower & is_leader[:, :, None], dim=1)
    eligible = lower & is_leader[:, :, None]
    has = torch.any(eligible, dim=1)
    leader = torch.where(has, torch.argmax(eligible.to(torch.uint8), dim=1), idx)

    # moments pooled about each member's leader mean (Gaussian.cs:297-347)
    assign = ((leader[:, None, :] == idx[None, :, None]) & live[:, None, :]).to(dt)
    w = torch.where(live, torch.exp(top_logw), zero)
    mean_feat = torch.stack(mean_s, dim=-1)  # [P, K, 3]
    dvec = mean_feat - torch.bmm(assign.transpose(1, 2), mean_feat)
    dv = [dvec[..., a] for a in range(3)]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    pool = (
        [w]
        + [w * dv[a] for a in range(3)]
        + [w * dv[a] * dv[b] for a, b in pairs]
        + [w * cov_s[i] for i in range(6)]
    )
    pooled = torch.bmm(assign, torch.stack(pool, dim=-1))  # [P, K, 16]
    wsum_l = pooled[..., 0]
    safe = torch.clamp(wsum_l, min=1e-30)
    delta_m = [pooled[..., 1 + a] / safe for a in range(3)]
    mean_m = [mi + dm for mi, dm in zip(mean_s, delta_m)]
    spread = [pooled[..., 4 + i] / safe - delta_m[a] * delta_m[b] for i, (a, b) in enumerate(pairs)]
    cov_m = [pooled[..., 10 + i] / safe + spread[i] for i in range(6)]

    out_alive = is_leader & (wsum_l > 0)
    one = torch.ones((), dtype=dt, device=dev)
    return SGM(
        *[torch.where(out_alive, mi, zero) for mi in mean_m],
        *[torch.where(out_alive, ci, ei) for ci, ei in zip(cov_m, (one, zero, zero, one, zero, one))],
        torch.where(out_alive, torch.log(safe), dead),
    )


def xla_stage(model, cfg, params, pose, maps: SGM, z, z_mask, packed=None):
    """Births + correct + prune with the XLA path's semantics
    (_births_soa, then _correct_prune_soa over the maps and the births),
    with fused_kernel.fused_stage's signature; packed is not read. Returns
    (predicted SGM [P, K0+M], corrected SGM [P, max_components])."""
    zl = [z[:, i] for i in range(model.meas_dim)]
    predicted = mixture.concat_soa(maps, _births_soa(model, params, pose, maps, zl, z_mask))
    return predicted, _correct_prune_soa(model, cfg, params, pose, predicted, zl, z_mask)


class Route(NamedTuple):
    """The functions a step of one model and dtype runs for its stages."""

    correct: Callable  # fused_kernel.fused_stage or xla_stage
    mixture: Callable  # (predicted, corrected, jmeans, jvalid) -> rest [P]
    assoc: Callable  # (model, cfg, params, pose, jmeans, jvalid, z, z_mask, packed) -> options
    beam: Callable  # (base, opt_delta, word_k, bit_k, beam_width, n_words) -> scores [P, B]
    packed: bool  # correct and assoc read the packed parameter vectors


def route(model, dtype, kernels=None):
    """The stage functions of a step of this model and dtype: the only code
    that knows which model and dtype each hand-written kernel takes, as the
    JAX step's pallas_correct / pallas_beam defaults choose (phd.py:521-534).

      None   float32 takes the mixture likelihood and beam kernels' wrappers,
             and, for a model with a kernel instantiation
             (model.kernel_params: PRM3D, Linear2D, Linear1D), the fused
             stage's and the association kernel's; the rest take the
             XLA-semantics stage and the plain versions (the Kinect model
             in float32: the mixture and beam kernels only; float64: none);
      False  the XLA-semantics stage and the plain versions for any dtype
             and model (the tests' oracle);
      True   the four kernels; float64 or a model without a kernel
             instantiation raises.

    A wrapper launches its CUDA kernel for CUDA tensors and runs its plain
    version for CPU tensors. The module attributes are read at each call,
    so a step built after a test replaces one runs the replacement."""
    f32, takes = dtype == torch.float32, model.kernel_params is not None
    if kernels and not (f32 and takes):
        raise ValueError(f"the kernels are float32 only and take the models with a kernel instantiation, "
                         f"not the depth-occlusion model: this step has {dtype} and the {model.name} model")
    fast = f32 if kernels is None else bool(kernels)
    return Route(
        correct=fused_kernel.fused_stage if fast and takes else xla_stage,
        mixture=mixture_kernel.mixture_rest if fast else mixture_kernel.mixture_rest_plain,
        assoc=assoc_kernel.assoc_options if fast and takes else assoc_kernel.assoc_options_plain,
        beam=beam_kernel.beam_scan_batch if fast else beam_kernel.beam_scan_plain,
        packed=fast and takes,
    )


def weight_inputs(model, cfg, params, pose, predicted: SGM, corrected: SGM, z, z_mask, fns: Route,
                  packed=None):
    """Per-particle weight-stage inputs (WeightAlpha, PHDNavigator.cs:373-453):
    rest = (plog - n_pred) - (clog - n_corr) on the MAP estimate of the
    corrected map, and the association beam's option tensors, by the
    route's mixture likelihoods and association options (`fns`); packed
    is assoc_kernel.pack_params(model, params) where the caller keeps it.

    Returns (rest [P], base [P], opt_delta [P, M, C+1], word_k, bit_k)."""
    with nested("phd.weight_inputs.map_estimate"):
        jidx, jvalid = mixture.best_map_indices(corrected.logw, cfg.estimate_cap)  # [P, E]
        mfeat = torch.stack(corrected.mean_list(), dim=-1)
        mfeat = torch.where(torch.isfinite(mfeat), mfeat, torch.zeros_like(mfeat))
        jm = torch.gather(mfeat, 1, jidx[..., None].expand(-1, -1, 3))
        jmeans = [jm[..., i] for i in range(3)]

    with nested("phd.weight_inputs.mixture_ll"):
        rest = fns.mixture(predicted, corrected, jmeans, jvalid)

    with nested("phd.weight_inputs.assoc"):
        base, od, wk, bk = fns.assoc(model, cfg, params, pose, jmeans, jvalid, z, z_mask, packed)
    return rest, base, od, wk, bk


SCAN_BLOCK = 1024  # cumulative sums longer than this are taken in blocks (fixed_cumsum)


def fixed_cumsum(x):
    """The inclusive cumulative sum of x [N], added in an order fixed by N
    alone: within blocks of SCAN_BLOCK, then each block's offset from the
    blocks' totals. CUDA's one-pass scan over a vector longer than one tile
    adds in an order that varies from run to run, so its float sums, and the
    draws taken on them, would differ in their last bits between runs of one
    seed (100,000 particles)."""
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return torch.cumsum(x, dim=0)
    blocks = -(-n // SCAN_BLOCK)
    inner = torch.cumsum(torch.nn.functional.pad(x, (0, blocks * SCAN_BLOCK - n)).reshape(blocks, SCAN_BLOCK), dim=1)
    totals = inner[:, -1]
    return (inner + (fixed_cumsum(totals) - totals)[:, None]).reshape(-1)[:n]


def systematic_draws(logweight, u):
    """The draws of systematic (wheel) resampling (PHDNavigator.cs:724-760)
    from the log-weights [P] of all particles and one uniform u in [0, 1):
    (source slot of every particle [P], BestParticle [])."""
    p = logweight.shape[0]
    w = torch.exp(logweight - torch.logsumexp(logweight, dim=0))
    with nested("phd.normalise_resample.draws"):
        cum = fixed_cumsum(w)
        positions = u / p + torch.arange(p, dtype=logweight.dtype, device=logweight.device) / p
        src = torch.clamp(torch.searchsorted(cum, positions, side="left"), 0, p - 1)
        # BestParticle: the last drawn slot whose source holds the max weight
        # (PHDNavigator.cs:745-748)
        best = p - 1 - first_argmax(torch.flip(w[src], dims=(0,)), 0)[1]
    return src, best


class Reductions(NamedTuple):
    """The reductions over the particle axis that the weight update takes:
    over the particles of the tensors it is given (LOCAL), or over every
    rank's particles as collectives (parallel/mesh.py)."""

    max: Callable  # a scalar of the particles held here -> over all particles
    sum: Callable
    gather: Callable  # [p, ...] held here -> [P, ...] of all particles
    gather_maps: Callable  # SGM of the p particles held here -> of all P
    offset: int = 0  # the global slot of the first particle held here


def _held(x):
    return x


LOCAL = Reductions(_held, _held, _held, _held)


def _normalise_resample(params, state, corrected, increment, resample_u, reduce=LOCAL):
    """Weight update by the per-particle log-likelihood `increment` [p],
    NaN-guarded normalisation and the ESS test with systematic resampling
    (PHDNavigator.cs:724-760) over all P particles, the reductions taken by
    `reduce`; both ESS branches are computed and selected with torch.where,
    so no value goes to the host."""
    lw = state.logweight + increment
    rows = slice(reduce.offset, reduce.offset + lw.shape[0])
    # log-sum-exp as torch.logsumexp takes it: an infinite max shifts by 0
    top = reduce.max(lw.max())
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    norm = torch.log(reduce.sum(torch.sum(torch.exp(lw - top)))) + top
    lw = torch.where(torch.isfinite(norm), lw - norm, state.logweight)
    everyone = reduce.gather(lw)
    p = everyone.shape[0]
    # ESS check (ParticleDepleted, :768-777)
    w = torch.exp(lw)
    ess = 1.0 / torch.clamp(reduce.sum(torch.sum(w * w)), min=1e-30)
    depleted = ess < params.min_effective_particle * p
    src, rs_best = systematic_draws(everyone, resample_u)
    mine = src[rows]
    maps = mixture.map_soa(lambda a: a[mine], reduce.gather_maps(corrected))
    keep = lambda a, b: torch.where(depleted, a, b)
    return PHDState(
        pose=keep(reduce.gather(state.pose)[mine], state.pose),
        logweight=keep(torch.full_like(lw, -float(np.log(p))), lw),
        maps=mixture.map_soa(keep, maps, corrected),
        best=keep(rs_best, first_argmax(everyone, 0)[1]),
        ancestor=keep(mine, torch.arange(rows.start, rows.stop, device=lw.device)),
    )


def make_slam_step(model, cfg: PHDConfig, slam: bool = True, kernels=None, stages=None):
    """The step: (params, state, odometry [T], z [M, D], z_mask [M],
    motion_normals [P, T], resample_u [], true_pose [S] = None) -> state.

    slam=False runs mapping-only: poses snap to `true_pose`, particle weights
    stay and best is 0 (PHDNavigator.cs:192-208, :297-300, :334-336). The
    draws are not read, and z_mask may be [P, M]: one measurement mask per
    particle, as the JAX step receives it under the smoother's vmap over
    leave-block-out passes (loopy.cavity_maps).

    kernels chooses the births + correct + prune stage, the mixture
    likelihoods and the association options of the weight inputs and the
    beam, as route(model, dtype, kernels) says, resolved once per dtype.

    stages replaces a stage with another function, as tools/ablate.py takes
    stages out (the JAX tool patches the module instead):
      "correct"  (pose, maps, z, z_mask) -> (predicted, corrected), in place
                 of births + correct + prune;
      "weight"   (pose, predicted, corrected, z, z_mask) -> the log-weight
                 increment [P], in place of the weight inputs and the beam;
      "normalise" (params, state, corrected, increment, resample_u) -> the
                 next state, in place of _normalise_resample (the sharded
                 step passes it its reductions over all ranks,
                 parallel/mesh.py)."""
    stages = stages or {}
    normalise = stages.get("normalise", _normalise_resample)
    n_words = (cfg.estimate_cap + 31) // 32
    routes = {}  # dtype -> its Route
    packed = [None, None, None]  # the params seen last, their fused and association vectors

    def pack(params, i):
        # kept while every field but the depth map is the same tensor: the
        # vectors hold no depth, and a params re-bound with a new depth map
        # only is not packed again
        last = packed[0]
        if last is None or any(x is not y for x, y in zip(params[:-1], last[:-1])):
            packed[:] = params, fused_kernel.pack_params(model, params), assoc_kernel.pack_params(model, params)
        return packed[i]

    def step(params, state, odometry, z, z_mask, motion_normals, resample_u, true_pose=None):
        fns = routes.get(state.pose.dtype)
        if fns is None:
            fns = routes[state.pose.dtype] = route(model, state.pose.dtype, kernels)
        with record_function("phd.predict"):
            state = predict_poses(model, params, state, odometry, motion_normals, slam, true_pose)
            if cfg.meas_compact and cfg.meas_compact < cfg.max_measurements:
                if z_mask.dim() != 1:
                    raise ValueError("measurement compaction takes one mask for every particle")
                order = live_first(z_mask, cfg.meas_compact)
                z, z_mask = z[order], z_mask[order]
        with record_function("phd.fused_stage"):
            if "correct" in stages:
                predicted, corrected = stages["correct"](state.pose, state.maps, z, z_mask)
            else:
                predicted, corrected = fns.correct(model, cfg, params, state.pose, state.maps, z, z_mask,
                                                   pack(params, 1) if fns.packed else None)
        if not slam:
            p = state.logweight.shape[0]
            return PHDState(
                state.pose, state.logweight, corrected,
                torch.zeros((), dtype=torch.int64, device=state.pose.device),
                torch.arange(p, device=state.pose.device),
            )
        if "weight" in stages:
            increment = stages["weight"](state.pose, predicted, corrected, z, z_mask)
        else:
            with record_function("phd.weight_inputs"):
                rest, base, od, wk, bk = weight_inputs(
                    model, cfg, params, state.pose, predicted, corrected, z, z_mask, fns,
                    pack(params, 2) if fns.packed else None,
                )
            with record_function("phd.beam_scan"):
                scores = fns.beam(base, od, wk, bk, cfg.beam_width, n_words)
            increment = association.logsumexp_scores(scores) + rest
        with record_function("phd.normalise_resample"):
            return normalise(params, state, corrected, increment, resample_u)

    return step


# =============================================================================
# AoS specification path (the oracle the SoA paths are held to; one particle)
# =============================================================================

def _births(model, params, pose, maps: GM, z, z_mask):
    """Birth components at unexplored back-projections (PredictConditional,
    PHDNavigator.cs:793-819 + Explored :956-959). pose [S], z [M, D]."""
    cand = model.to_map(model.params, pose[None, :], z)  # [M, 3]
    density = mixture.evaluate_many(maps, cand, radius=3.0 * params.density_radius)
    unexplored = z_mask & (density < params.exploration_threshold)
    logw = torch.where(
        unexplored, torch.log(params.birth_weight), torch.full_like(density, DEAD)
    )
    cov = params.birth_cov.expand(z.shape[0], 3, 3)
    return GM(cand, cov, logw.to(maps.logw.dtype))


def _correct(model, cfg, params, pose, predicted: GM, z, z_mask):
    """PHD measurement update (CorrectConditional, PHDNavigator.cs:829-906):
    dense per-component EKF precompute + per-measurement top-G gated update.
    Returns the un-pruned corrected candidate mixture
    [K' misdetections + M * G updates]."""
    kp = predicted.capacity
    d = model.meas_dim
    dt, dev = predicted.logw.dtype, predicted.logw.device
    zero = torch.zeros((), dtype=dt, device=dev)
    dead = torch.full((), DEAD, dtype=dt, device=dev)
    alive = mixture.alive(predicted)

    h = model.measure(model.params, pose[None, :], predicted.mean)  # [K', D]
    pd_k = torch.where(
        alive,
        model.fuzzy_visible_fn(params.depth_map)(model.params, h, params.visibility_ramp) * params.pd,
        zero,
    )
    pd_k = torch.clamp(pd_k, 0.0, 1.0 - 1e-7)

    # misdetection branch: w *= (1 - PD)
    miss_logw = torch.where(alive, predicted.logw + torch.log1p(-pd_k), dead)
    miss = GM(predicted.mean, predicted.cov, miss_logw)

    # EKF precompute (:857-870)
    hjac = model.jac_landmark(model.params, pose[None, :], predicted.mean).expand(kp, d, 3)
    ph = torch.einsum("kab,kcb->kac", predicted.cov, hjac)  # P H^T [K', 3, D]
    s = torch.einsum("kab,kbc->kac", hjac, ph) + params.meas_cov  # [K', D, D]
    s_inv = gaussian.inv(s)
    s_logmult = gaussian.log_multiplier(s)
    gain = torch.einsum("kad,kde->kae", ph, s_inv)  # [K', 3, D]
    i_kh = torch.eye(3, dtype=dt, device=dev) - torch.einsum("kad,kdb->kab", gain, hjac)
    cov_upd = torch.einsum("kab,kbc->kac", i_kh, predicted.cov)

    # gating: components near each measurement's back-projection (:881-882)
    backproj = model.to_map(model.params, pose[None, :], z)  # [M, 3]
    dist2 = torch.sum((backproj[:, None, :] - predicted.mean[None, :, :]) ** 2, dim=-1)
    r2 = params.density_radius * params.density_radius
    in_gate = (dist2 <= r2) & alive[None, :] & z_mask[:, None]
    gate_score = torch.where(in_gate, -dist2, torch.full_like(dist2, -float("inf")))
    _, gidx = mixture.topk_stable(gate_score, cfg.gate_top)  # [M, G]
    gvalid = torch.gather(in_gate, 1, gidx)

    # per-(measurement, gated component) update terms
    zg = z[:, None, :]
    h_g = h[gidx]  # [M, G, D]
    q_log = s_logmult[gidx] - 0.5 * torch.einsum(
        "mgd,mgde,mge->mg", zg - h_g, s_inv[gidx], zg - h_g
    )
    log_pd_g = torch.log(torch.clamp(pd_k[gidx], min=1e-30))
    log_num = torch.where(gvalid, log_pd_g + predicted.logw[gidx] + q_log, dead)
    wsum = torch.sum(torch.where(gvalid, torch.exp(log_num), zero), dim=1)  # (:884-890)
    upd_logw = log_num - torch.log(params.clutter_density + wsum)[:, None]

    mean_g = predicted.mean[gidx] + torch.einsum("mgad,mgd->mga", gain[gidx], zg - h_g)
    mg = z.shape[0] * cfg.gate_top
    updates = GM(
        mean_g.reshape(mg, 3),
        cov_upd[gidx].reshape(mg, 3, 3),
        torch.where(gvalid, upd_logw, dead).reshape(mg),
    )
    return mixture.concat(miss, updates)
