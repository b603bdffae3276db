"""PHD births + correct + prune for all particles: the Hopper counterpart of
monorfs_tpu/slam/fused_pallas.py::fused_stage (kernel: csrc/fused_stage.cu).

fused_stage launches the CUDA kernel for CUDA tensors and runs
fused_stage_plain, the same function in plain PyTorch, for CPU tensors. Both
follow the kernel semantics of fused_pallas.py:21-41, not the XLA path's:

  * the MaxQuantity cut is a 30-step bisection for the threshold tau over
    {misdetections} u {pair updates} with strict `>` counts; ties at tau are
    dropped and a cap that does not bind keeps everything above
    max(log MinWeight, -80) - 1;
  * pair survivors are capped at gate_top per measurement, taken in
    (weight desc, index asc) order (the first-index argmax);
  * survivors are compacted misdetections first (component order), then
    each measurement's pairs in turn;
  * the greedy Mahalanobis merge orders leaders by (weight, index), runs
    `merge_rounds` synchronous leader rounds, gives each member its heaviest
    eligible leader (lowest index on ties) and pools moments centred at the
    leader's mean.

The kernel and the plain version take the three model families (PRM3D,
Linear2D, Linear1D: measurement dimension D = 3, 2, 1; pose width 7, 2, 1)
and every (K0, M). The kernel runs each phase over a particle's live
components and the birth candidates only, and keeps a table in a
per-particle device-memory workspace (allocated once per shape and device,
sized by the built library's fused_stage_workspace_floats) where it does
not fit its shared arena. `layout_bytes` and `workspace_floats` are Python
copies of the C sizes, for the CPU tests; chip_smoke.py holds them against
the C functions."""

import ctypes
import functools

import torch

from .. import _build
from ..gm import smallmat
from ..gm.mixture import ALIVE_THRESHOLD, DEAD, SGM, topk_stable

BISECT = 30
# the phase clock's names; the first pass copies pred's map part
PHASES = ("map copy, live list and births", "predicted births write", "EKF", "pairs", "cut",
          "compaction", "merge relation", "leader rounds", "pooling and write")
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


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


# ---- CUDA kernel wrapper -----------------------------------------------------

def pack_params(model, params):
    """PHDParams -> flat [16 + D + D*D] f32 (layout read by
    csrc/fused_stage.cu): 7 scalars, ramp [D], meas_cov [D, D], birth_cov."""
    d = model.meas_dim
    parts = [
        params.pd, params.clutter_density, params.birth_weight, params.min_weight,
        params.merge_threshold, params.exploration_threshold, params.density_radius,
        params.visibility_ramp[:d], params.meas_cov, params.birth_cov,
    ]
    return torch.cat([x.reshape(-1).to(torch.float32) for x in parts])


# csrc/fused_stage.cu's sizes: shared memory (LIVE_FIXED + LIVE_ARENA words)
_SMEM_WORDS = 32 + 64 + 2 * 128 * 8 + 15872


def layout_bytes(k0, m):
    """Shared memory one block asks for, the same at every shape (the Python
    copy of fused_stage_smem_bytes)."""
    return 4 * _SMEM_WORDS


def workspace_floats(k0, m):
    """f32 words of one particle's device-memory workspace: a slot for each
    of the kernel's tables at its largest (N = K0 + M local components and
    the cut's list of their entries, K0 output slots; the Python copy of
    fused_stage_workspace_floats)."""
    kpm, nwk = k0 + m, (k0 + 31) // 32
    return 9 * m + (41 + 2 * m) * kpm + 22 * k0 + k0 * nwk + nwk


@functools.cache
def smem_bytes(k0, m):
    """fused_stage_smem_bytes of the built library (on the card)."""
    fn = _build.function("fused_stage_smem_bytes", [ctypes.c_int] * 2, ctypes.c_size_t)
    return fn(k0, m)


@functools.cache
def workspace_floats_built(k0, m):
    """fused_stage_workspace_floats of the built library (on the card)."""
    fn = _build.function("fused_stage_workspace_floats", [ctypes.c_int] * 2, ctypes.c_size_t)
    return fn(k0, m)


@functools.cache
def _workspace(p, k0, m, device):
    """The workspace [P, fused_stage_workspace_floats] f32 of a shape,
    allocated once per device; launches on one stream run in order, so they
    share it."""
    return torch.empty((p, workspace_floats_built(k0, m)), dtype=torch.float32, device=device)


@functools.cache
def _launcher():
    return _build.function(
        "fused_stage_launch",
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_float] * 8 + [ctypes.c_void_p] * 2,
    )


def fused_stage(model, cfg, params, pose, maps: SGM, z, z_mask, packed=None, phase_clock=None):
    """Births + correct + prune for all particles; see the module note.
    z_mask: [M], or [P, M] with one measurement mask per particle (block p
    reads row p; the smoother's leave-block-out passes). packed: pack_params(model, params) on the device, when the caller keeps
    it across calls. phase_clock: an int64 [P, len(PHASES) + 1] CUDA tensor
    that receives each block's clock64() at entry and after each phase (a
    measurement; it adds a barrier per phase). Returns (predicted
    SGM [P, K0+M], corrected SGM [P, K0]). On CUDA tensors the kernel is
    launched or an error is raised; the plain version runs for CPU tensors
    only."""
    if pose.device.type == "cpu":
        return fused_stage_plain(model, cfg, params, pose, maps, z, z_mask)
    if pose.device.type != "cuda":
        raise ValueError(f"unsupported device {pose.device}")
    if model.kernel_params is None:
        raise ValueError(f"the fused kernel takes no {model.name} model")
    mvals = model.kernel_params(model.params)
    d, s = model.meas_dim, model.pose.state_dim
    p = pose.shape[0]
    k0 = maps.capacity
    m = z.shape[0]
    if k0 != cfg.max_components:
        raise ValueError(f"map capacity {k0} != max_components {cfg.max_components}")
    dev = pose.device
    checks = [("pose", pose, torch.float32, (p, s)), ("z", z, torch.float32, (m, d)),
              ("z_mask", z_mask, torch.bool, (p, m) if z_mask.dim() == 2 else (m,))]
    checks += [(f"maps.{n}", leaf, torch.float32, (p, k0)) for n, leaf in zip(SGM._fields, maps)]
    for name, t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dt} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if cfg.gate_top < 1 or cfg.merge_rounds < 0:
        raise ValueError("gate_top must be positive and merge_rounds non-negative")
    work = _workspace(p, k0, m, dev).data_ptr()
    clk = 0
    if phase_clock is not None:
        shape = (p, len(PHASES) + 1)
        if (phase_clock.device != dev or phase_clock.dtype != torch.int64
                or tuple(phase_clock.shape) != shape or not phase_clock.is_contiguous()):
            raise ValueError(f"phase_clock: expected contiguous int64 {shape} on {dev}")
        clk = phase_clock.data_ptr()

    kp = k0 + m
    pose_c = pose.contiguous()
    maps_in = torch.stack(list(maps))  # [10, P, K0]
    z_c = z.contiguous()
    zm = z_mask.to(torch.int32).contiguous()
    prm = pack_params(model, params).to(dev) if packed is None else packed
    if prm.device != dev or prm.dtype != torch.float32 or prm.shape != (16 + d + d * d,):
        raise ValueError(f"packed params: expected float32 ({16 + d + d * d},) on {dev}")
    pred = torch.empty((10, p, kp), dtype=torch.float32, device=dev)
    cor = torch.empty((10, p, k0), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            d, prm.data_ptr(), pose_c.data_ptr(), maps_in.data_ptr(), z_c.data_ptr(),
            zm.data_ptr(), m if z_mask.dim() == 2 else 0, pred.data_ptr(), cor.data_ptr(), work,
            p, k0, m, cfg.gate_top, cfg.merge_rounds, *mvals, clk, stream,
        )
    _build.check(err, "fused_stage_launch")
    fused_stage.launches += 1
    return SGM(*pred.unbind(0)), SGM(*cor.unbind(0))


fused_stage.launches = 0
