"""The PHD SLAM frame in plain PyTorch: a frozen copy of the port's plain
functions (slam/phd.py: the XLA-semantics births and
correct / prune / merge, weight_inputs; slam/fused_kernel.py:
fused_stage_plain, the fused kernel's semantics; slam/assignment.py:
first_argmax), run by the benchmark in float64 to judge what the port's
timed step produced. The correct stage is `fused_stage_plain`, which the
port's hand-written fused kernel (csrc/fused_stage.cu) follows."""

import dataclasses
from typing import NamedTuple

import torch

from . import association, smallmat
from .mixture import ALIVE_THRESHOLD, DEAD, SGM, topk_stable
from . import mixture

# log(1e-300): the reference's float64 density floor, pinned in log space
LOG_EVAL_FLOOR = -690.77552789821368
BISECT = 30
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


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
    depth_map: torch.Tensor  # [1, 1] of inf: PRM3D has no depth occlusion


def live_first(z_mask, n):
    """Indices of the first n slots in live-first stable order."""
    return torch.argsort((~z_mask).to(torch.uint8), stable=True)[:n]


def weight_inputs(model, cfg, params, pose, predicted: SGM, corrected: SGM, z, z_mask,
                  selection=None):
    """Per-particle weight-stage inputs (WeightAlpha, PHDNavigator.cs:373-453):
    rest = (plog - n_pred) - (clog - n_corr) on the MAP estimate of the
    corrected map, and the association beam's option tensors. `selection`
    (indices [P, E], valid [P, E]) gives the MAP estimate in place of
    best_map_indices of the corrected map (the benchmark's addition).

    Returns (rest [P], base [P], opt_delta [P, M, C+1], word_k, bit_k)."""
    mp = model.params
    jidx, jvalid = selection or mixture.best_map_indices(corrected.logw, cfg.estimate_cap)  # [P, E]
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
    pdv = model.fuzzy_visible_soa_fn(params.depth_map)(mp, mu, params.visibility_ramp) * params.pd
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


def fused_stage_plain(model, cfg, params, pose, maps: SGM, z, z_mask):
    """pose [P, S]; maps leaves [P, K0]; z [M, D]; z_mask bool, [M] for every
    particle or [P, M] one row per particle. Returns (predicted SGM
    [P, K0+M], corrected SGM [P, K0])."""
    p = pose.shape[0]
    k0 = maps.capacity
    m = z.shape[0]
    k_out = cfg.max_components
    gate_top = min(cfg.gate_top, k0 + m)
    mp = model.params
    dt, dev = maps.logw.dtype, maps.logw.device
    dead = torch.tensor(DEAD, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    zl = [z[:, i][None, :] for i in range(model.meas_dim)]  # D x [1, M]
    z_live = z_mask if z_mask.dim() == 2 else z_mask[None, :]

    # ---- births (PredictConditional, PHDNavigator.cs:793-819) --------------
    cand = [c.expand(p, m) for c in model.to_map_soa(mp, pose, zl)]  # 3 x [P, M]
    mean0, cov0, logw0 = maps.mean_list(), maps.cov6(), maps.logw
    cov0m = smallmat.sym_to_mat(cov0)
    det0 = smallmat.det(cov0m)
    inv0 = smallmat.inv(cov0m, det0)
    logmult0 = smallmat.log_multiplier(cov0m, det0)
    diff0 = [c[:, :, None] - mm[:, None, :] for c, mm in zip(cand, mean0)]
    m2_0 = smallmat.quadform(diff0, [[e[:, None, :] for e in row] for row in inv0])
    logp0 = logmult0[:, None, :] - 0.5 * m2_0
    dist2_0 = sum(dd * dd for dd in diff0)
    r3 = 3.0 * params.density_radius
    bmask = (logw0 > ALIVE_THRESHOLD)[:, None, :] & (dist2_0 <= r3 * r3)
    density = torch.sum(
        torch.where(bmask, torch.exp(logw0[:, None, :] + logp0), zero), dim=-1
    )
    unexplored = z_live & (density < params.exploration_threshold)
    birth_logw = torch.where(unexplored, torch.log(params.birth_weight), dead)

    mean = [torch.cat([mm, c], dim=-1) for mm, c in zip(mean0, cand)]
    bc6 = smallmat.mat_to_sym(smallmat.from_tensor(params.birth_cov))
    cov6 = tuple(
        torch.cat([c0, b6.to(dt).expand(p, m)], dim=-1) for c0, b6 in zip(cov0, bc6)
    )
    logw = torch.cat([logw0, birth_logw], dim=-1)
    predicted = SGM(*mean, *cov6, logw)

    # ---- EKF precompute (CorrectConditional, :857-870) ---------------------
    alive = logw > ALIVE_THRESHOLD
    cov = smallmat.sym_to_mat(cov6)
    h = model.measure_soa(mp, pose, mean)  # D x [P, KP]
    pd_k = torch.where(alive, model.fuzzy_visible_soa(mp, h, params.visibility_ramp) * params.pd, zero)
    pd_k = torch.clamp(pd_k, 0.0, 1.0 - 1e-7)
    miss_logw = torch.where(alive, logw + torch.log1p(-pd_k), dead)
    hj = model.jac_landmark_soa(mp, pose, mean)  # D x 3
    pht = smallmat.matmul(cov, smallmat.transpose(hj))
    s = smallmat.add(smallmat.matmul(hj, pht), smallmat.from_tensor(params.meas_cov))
    det_s = smallmat.det(s)
    s_inv = smallmat.inv(s, det_s)
    s_logmult = smallmat.log_multiplier(s, det_s)
    gain = smallmat.matmul(pht, s_inv)
    ikh = smallmat.sub(smallmat.identity_like(3, logw), smallmat.matmul(gain, hj))
    cov_upd = smallmat.mat_to_sym(smallmat.symmetrize(smallmat.matmul(ikh, cov)))

    # ---- dense pair scores [P, M, KP] (:881-903) ----------------------------
    diffp = [b[:, :, None] - mm[:, None, :] for b, mm in zip(cand, mean)]
    dist2 = sum(dd * dd for dd in diffp)
    r2 = params.density_radius * params.density_radius
    in_gate = (dist2 <= r2) & alive[:, None, :] & z_live[:, :, None]
    innov = [zi[:, :, None] - hi[:, None, :] for zi, hi in zip(zl, h)]
    q_log = s_logmult[:, None, :] - 0.5 * smallmat.quadform(
        innov, [[e[:, None, :] for e in row] for row in s_inv]
    )
    q_log = torch.where(torch.isfinite(q_log), q_log, dead)
    log_pd_k = torch.log(torch.clamp(pd_k, min=1e-30))
    log_num = torch.where(in_gate, log_pd_k[:, None, :] + logw[:, None, :] + q_log, dead)
    wsum = torch.sum(torch.where(in_gate, torch.exp(log_num), zero), dim=-1)
    upd_logw = torch.where(
        in_gate, log_num - torch.log(params.clutter_density + wsum)[:, :, None], dead
    )
    gdot = smallmat.matvec([[e[:, None, :] for e in row] for row in gain], innov)
    mean_upd = [mm[:, None, :] + gd for mm, gd in zip(mean, gdot)]
    mean_upd = [torch.where(torch.isfinite(c), c, zero) for c in mean_upd]
    cov_upd = [torch.where(torch.isfinite(c), c, zero) for c in cov_upd]

    # ---- MaxQuantity cut: bisect the K-th largest weight (:921-929) ---------
    lminw = torch.clamp(torch.log(params.min_weight), min=-80.0)
    cand_miss = torch.where(miss_logw >= lminw, miss_logw, dead)
    cand_pair = torch.where(upd_logw >= lminw, upd_logw, dead)
    hi = torch.maximum(torch.amax(cand_miss, dim=-1), torch.amax(cand_pair, dim=(-2, -1)))
    lo = (torch.zeros(p, dtype=dt, device=dev) + lminw) - 1.0
    hi = torch.maximum(hi, lo + 1e-3)

    def count_above(t):
        return torch.sum(cand_miss > t[:, None], dim=-1) + torch.sum(
            cand_pair > t[:, None, None], dim=(-2, -1)
        )

    all_fit = count_above(lo) <= k_out
    lo_b, hi_b = lo, hi
    for _ in range(BISECT):
        mid = 0.5 * (lo_b + hi_b)
        over = count_above(mid) > k_out
        lo_b, hi_b = torch.where(over, mid, lo_b), torch.where(over, hi_b, mid)
    tau = torch.where(all_fit, lo, hi_b)
    keep_miss = cand_miss > tau[:, None]
    keep_pair = cand_pair > tau[:, None, None]

    # ---- compaction: misses in component order, then each row's pairs ------
    km = keep_miss.to(torch.int64)
    rank_miss = torch.cumsum(km, dim=-1) - km
    n_miss = torch.sum(km, dim=-1)
    rowcount = torch.clamp(torch.sum(keep_pair, dim=-1), max=gate_top)  # [P, M]
    row_off = torch.cumsum(rowcount, dim=-1) - rowcount
    work = torch.where(keep_pair, cand_pair, torch.full_like(cand_pair, -float("inf")))
    mx, idx = topk_stable(work, gate_top)  # [P, M, G]
    g = torch.arange(gate_top, device=dev)
    valid = (g < rowcount[..., None]) & torch.isfinite(mx)
    slot_p = n_miss[:, None, None] + row_off[..., None] + g

    def san(c, keep):
        return torch.where(keep & torch.isfinite(c), c, zero)

    miss_feat = torch.stack(
        [san(c, keep_miss) for c in list(mean) + list(cov6) + [miss_logw]], dim=-1
    )  # [P, KP, 10]
    idx_flat = idx.reshape(p, m * gate_top)
    pair_feat = torch.stack(
        [torch.gather(c, -1, idx).reshape(p, -1) for c in mean_upd]
        + [torch.gather(c, -1, idx_flat) for c in cov_upd]
        + [torch.where(torch.isfinite(mx), mx, zero).reshape(p, -1)],
        dim=-1,
    )  # [P, M*G, 10]
    slot_m = torch.where(keep_miss & (rank_miss < k_out), rank_miss, k_out)
    ok_p = (valid & (slot_p < k_out)).reshape(p, -1)
    slot_p = torch.where(ok_p, slot_p.reshape(p, -1), k_out)
    slots = torch.cat([slot_m, slot_p], dim=1)
    feats = torch.cat([miss_feat, pair_feat], dim=1)
    cor = torch.zeros((p, k_out + 1, 10), dtype=dt, device=dev)
    cor.scatter_(1, slots[..., None].expand(-1, -1, 10), feats)
    filled = torch.zeros((p, k_out + 1), dtype=torch.bool, device=dev)
    filled.scatter_(1, slots, torch.ones_like(slots, dtype=torch.bool))
    cor, live = cor[:, :k_out], filled[:, :k_out]
    mean_s = [cor[..., i] for i in range(3)]
    cov_s = [cor[..., 3 + i] for i in range(6)]
    top_logw = torch.where(live, cor[..., 9], dead)

    # ---- greedy weight-ordered merge (:930-948) ----------------------------
    covm = smallmat.sym_to_mat(cov_s)
    inv_c = smallmat.inv(covm, smallmat.det(covm))  # leader metric
    diff = [mi[:, None, :] - mi[:, :, None] for mi in mean_s]  # [P, i leader, k]
    m2 = smallmat.quadform(diff, [[e[:, :, None] for e in row] for row in inv_c])
    close = m2 < params.merge_threshold * params.merge_threshold
    w = torch.where(live, torch.exp(top_logw), zero)
    ar = torch.arange(k_out, device=dev)
    heavier = (w[:, :, None] > w[:, None, :]) | (
        (w[:, :, None] == w[:, None, :]) & (ar[:, None] < ar[None, :])
    )
    lower = heavier & close & live[:, None, :] & live[:, :, None]
    is_leader = live
    for _ in range(cfg.merge_rounds):
        conflict = torch.any(lower & is_leader[:, :, None], dim=1)
        is_leader = live & ~conflict
    eligible = lower & is_leader[:, :, None]
    has = torch.any(eligible, dim=1)
    lead_w = torch.where(eligible, w[:, :, None], torch.full_like(w[:, :, None], -1.0))
    mw = torch.amax(lead_w, dim=1)
    first = (eligible & (lead_w == mw[:, None, :])).to(torch.uint8)
    leader = torch.where(has, torch.argmax(first, dim=1), ar)

    assign = ((leader[:, None, :] == ar[None, :, None]) & live[:, None, :]).to(dt)
    mean_feat = torch.stack(mean_s, dim=-1)  # [P, K, 3]
    leader_mean = torch.bmm(assign.transpose(1, 2), mean_feat)
    dv = [mean_feat[..., a] - leader_mean[..., a] for a in range(3)]
    chans = (
        [w]
        + [w * dv[a] for a in range(3)]
        + [w * dv[a] * dv[b] for a, b in _PAIRS]
        + [w * cov_s[i] for i in range(6)]
    )
    pooled = torch.bmm(assign, torch.stack(chans, dim=-1))  # [P, K, 16]
    wsum_l = pooled[..., 0]
    safe = torch.clamp(wsum_l, min=1e-30)
    delta_m = [pooled[..., 1 + a] / safe for a in range(3)]
    mean_m = [mi + dm for mi, dm in zip(mean_s, delta_m)]
    spread = [
        pooled[..., 4 + i] / safe - delta_m[a] * delta_m[b] for i, (a, b) in enumerate(_PAIRS)
    ]
    cov_m = [pooled[..., 10 + i] / safe + spread[i] for i in range(6)]
    out_alive = is_leader & (wsum_l > 0)
    one = torch.ones((), dtype=dt, device=dev)
    corrected = SGM(
        *[torch.where(out_alive, mi, zero) for mi in mean_m],
        *[torch.where(out_alive, ci, ei) for ci, ei in zip(cov_m, (one, zero, zero, one, zero, one))],
        torch.where(out_alive, torch.log(safe), dead),
    )
    return predicted, corrected


def first_argmax(values, dim):
    """(max, lowest index holding it) along `dim`."""
    vmax = values.amax(dim=dim, keepdim=True)
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    idx = torch.arange(n, device=values.device).view(shape)
    first = torch.where(values == vmax, idx, n).amin(dim=dim)
    return vmax.squeeze(dim), first
