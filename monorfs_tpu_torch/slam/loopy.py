"""Loopy-PHD offline smoother: belief propagation on the pose chain with the
PHD map marginalised out (LoopyPHDNavigator.cs:51-1120). The torch twin of
monorfs_tpu.slam.loopy: same names, same messages, same schedule.

  * per-pose messages from past / future in the linearisation-point tangent
    space, propagated through the motion Jacobian with added motion
    covariance (:427-501);
  * map messages as constant + Gaussian-mixture factors fitted by gradient
    ascent on the quasi set log-likelihood from FitToMeasurement seeds, with
    the exact autograd Hessian as covariance and annealing temperature
    (1 + T) * cov(past x future) (:511-552, :777-1019);
  * fusion by canonical-form products followed by moment mixdown (:615-688).

Where the JAX package vmaps, this module writes the batch axis out: the B
leave-block-out cavity maps are ONE mapping run of B "particles" that all
snap to the same pose and each take their own measurement mask (the fused
stage takes a [P, M] mask: one launch a frame for all B passes); the refit's
seeds, guesses and line-search fan are rows of one quasi-likelihood call;
map messages are fitted for a chunk of nodes at once. Its lax.scans are
Python loops over the nodes that never read a device value on the host.

Gradients come from torch.autograd through the plain association beam
(association.quasi_set_log_likelihood); the Hessian is O rows of double
backward. Value-only likelihoods take the beam that phd.route gives for
LoopyConfig.kernels (the kernel for float32)."""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..gm import gaussian, mixture
from ..gm.mixture import DEAD, SGM
from . import association, phd

LARGE_COV = 1.0e6
NODE_CHUNK = 32  # nodes whose map messages are fitted in one batch


@dataclasses.dataclass(frozen=True)
class LoopyConfig:
    """Field for field the JAX LoopyConfig (see its comments for each
    default's measurement), plus `kernels`."""

    max_nodes: int
    max_meas: int
    mix_cap: int = 6  # map-message mixture components per node
    blocks: int = 8  # leave-block-out cavity maps
    anchor_sigma: float = 0.5  # initial lp-anchor prior std (see init_state)
    gauge_fix: bool = True  # project out the shear gauge mode per sweep
    relinearize: bool = True  # re-anchor lp to the fused estimate per sweep
    refit: bool = True  # sequential re-localisation first pass
    refit_gate: float = 1.0  # seed radius of the refit pose fit
    refit_seeds: int = 6  # gradient-ascent starts per refit frame
    refit_passes: int = 1  # forward refit passes
    refit_backward: bool = True  # then one reversed refit pass
    freeze_map_after: int = 2  # sweeps after which map messages freeze
    ga_iters: int = 8
    ga_steps: int = 4  # parallel line-search fan per iteration
    jmap_cap: int = 32
    beam_width: int = 32
    inner: phd.PHDConfig = None  # inner mapping filter sizes
    # the inner filter's stages and the value-only beams: phd.route's
    # `kernels` (None -> the kernels for float32, their plain versions on
    # CPU tensors; False -> the XLA-semantics stage and the plain versions
    # for any dtype, the tests' oracle)
    kernels: Optional[bool] = None

    def __post_init__(self):
        if self.inner is None:
            object.__setattr__(
                self,
                "inner",
                phd.PHDConfig(
                    num_particles=1,
                    max_components=128,
                    max_measurements=self.max_meas,
                    gate_top=8,
                    estimate_cap=self.jmap_cap,
                    beam_width=self.beam_width,
                ),
            )


class LoopyState(NamedTuple):
    lp: torch.Tensor  # [T, S] linearisation points
    past_mean: torch.Tensor  # [T, O]
    past_cov: torch.Tensor  # [T, O, O]
    future_mean: torch.Tensor
    future_cov: torch.Tensor
    map_const: torch.Tensor  # [T]
    map_mean: torch.Tensor  # [T, Kf, O]
    map_cov: torch.Tensor  # [T, Kf, O, O]
    map_logw: torch.Tensor  # [T, Kf]
    fused_mean: torch.Tensor  # [T, O]
    fused_cov: torch.Tensor  # [T, O, O]
    node_mask: torch.Tensor  # [T] bool


def init_state(model, cfg: LoopyConfig, trajectory, n_nodes, dtype=torch.float32, device="cuda"):
    """Messages start as infinite-covariance priors with a Dirac-ish delta at
    t=0 (initMessages, LoopyPHDNavigator.cs:281-311); the map slot holds a
    weak Gaussian prior at the linearisation point (std cfg.anchor_sigma),
    which the first real map fit overwrites (see the JAX twin's note)."""
    dev = resolve_device(device)
    t, o = cfg.max_nodes, model.pose.odo_dim
    eye = torch.eye(o, dtype=dtype, device=dev)
    inf = (LARGE_COV * eye).expand(t, o, o)
    past_cov = inf.clone()
    past_cov[0] = 1e-8 * eye
    map_cov = eye.expand(t, cfg.mix_cap, o, o).clone()
    map_cov[:, 0] = cfg.anchor_sigma ** 2 * eye
    map_logw = torch.full((t, cfg.mix_cap), DEAD, dtype=dtype, device=dev)
    map_logw[:, 0] = 0.0
    if isinstance(trajectory, torch.Tensor):
        lp = trajectory.to(dtype=dtype, device=dev)
    else:
        lp = torch.as_tensor(np.asarray(trajectory, np.float64), dtype=dtype, device=dev)
    zeros = torch.zeros((t, o), dtype=dtype, device=dev)
    return LoopyState(
        lp=lp,
        past_mean=zeros,
        past_cov=past_cov,
        future_mean=zeros.clone(),
        future_cov=inf.clone(),
        map_const=torch.full((t,), DEAD, dtype=dtype, device=dev),
        map_mean=torch.zeros((t, cfg.mix_cap, o), dtype=dtype, device=dev),
        map_cov=map_cov,
        map_logw=map_logw,
        fused_mean=zeros.clone(),
        fused_cov=inf.clone(),
        node_mask=torch.arange(t, device=dev) < n_nodes,
    )


# ----------------------------------------------------------------------
# gaussian utilities (tangent space)


def _mv(mat, vec):
    return torch.einsum("...ij,...j->...i", mat, vec)


def _fuse(mean_a, cov_a, mean_b, cov_b):
    """Information-form product (Gaussian.Fuse, Gaussian.cs:253-260)."""
    ia = gaussian.inv(cov_a)
    ib = gaussian.inv(cov_b)
    cov = gaussian.inv(ia + ib)
    return _mv(cov, _mv(ia, mean_a) + _mv(ib, mean_b)), cov


def _unfuse(mean_a, cov_a, mean_b, cov_b):
    """Information-form division (Gaussian.Unfuse, Gaussian.cs:268-274);
    an indefinite result falls back to an uninformative prior."""
    ia = gaussian.inv(cov_a)
    ib = gaussian.inv(cov_b)
    info = ia - ib
    o = mean_a.shape[-1]
    diag_ok = torch.all(torch.diagonal(info, dim1=-2, dim2=-1) > 1.0 / LARGE_COV * 0.5, dim=-1)
    eye = torch.eye(o, dtype=mean_a.dtype, device=mean_a.device)
    cov = gaussian.inv(torch.where(diag_ok[..., None, None], info, eye / LARGE_COV))
    vec = _mv(ia, mean_a) - _mv(ib, mean_b)
    mean = _mv(cov, torch.where(diag_ok[..., None], vec, torch.zeros_like(vec)))
    return torch.where(diag_ok[..., None], mean, mean_a), cov


def _log_weight_product(mean_a, cov_a, mean_b, cov_b):
    """log of the scale of N_a * N_b = scale * N_fused:
    N(mean_a - mean_b; 0, cov_a + cov_b)."""
    return gaussian.logpdf(mean_a, mean_b, cov_a + cov_b)


def fuse_with_mixture(mean, cov, m_const, m_mean, m_cov, m_logw):
    """Fuse a Gaussian with a (const + mixture) map factor and mix down to a
    single Gaussian (LoopyPHDNavigator.cs:615-688)."""
    pm, pc = _fuse(mean[..., None, :], cov[..., None, :, :], m_mean, m_cov)
    logs = _log_weight_product(mean[..., None, :], cov[..., None, :, :], m_mean, m_cov) + m_logw
    logs = torch.where(m_logw > DEAD / 2, logs, torch.full_like(logs, DEAD))
    all_mean = torch.cat([mean[..., None, :], pm], dim=-2)
    all_cov = torch.cat([cov[..., None, :, :], pc], dim=-3)
    all_logw = torch.cat([m_const[..., None], logs], dim=-1)
    all_logw = all_logw - torch.logsumexp(all_logw, dim=-1, keepdim=True)
    _, mm, cc = gaussian.merge_moments(all_logw, all_mean, all_cov, all_logw > DEAD / 2, axis=-1)
    return mm, cc


def _fuse3(state: LoopyState):
    """fused = mixdown(past x future x map) for all nodes."""
    pf_mean, pf_cov = _fuse(state.past_mean, state.past_cov, state.future_mean, state.future_cov)
    return fuse_with_mixture(pf_mean, pf_cov, state.map_const, state.map_mean, state.map_cov,
                             state.map_logw)


def _fuse3_single(model, state, i):
    pf_mean, pf_cov = _fuse(state.past_mean[i], state.past_cov[i], state.future_mean[i],
                            state.future_cov[i])
    return fuse_with_mixture(pf_mean, pf_cov, state.map_const[i], state.map_mean[i],
                             state.map_cov[i], state.map_logw[i])


# ----------------------------------------------------------------------
# motion jacobian (LoopyPHDNavigator.cs:586-594)


def motion_jacobian(model, prevlinear, linear, prevmean, odometry):
    identity = model.pose.identity(prevlinear.dtype, prevlinear.device)
    linj = model.pose.subtract_jacobian(identity.expand(prevlinear.shape), linear)
    odoj = model.pose.add_odometry_jacobian(model.pose.add(prevlinear, prevmean), odometry)
    prevj = model.pose.add_jacobian(prevlinear, prevmean)
    return torch.einsum("...ij,...jk,...kl->...il", linj, odoj, prevj)


# ----------------------------------------------------------------------
# message sweeps


def make_forward_step(model, motion_cov):
    """One step of the forward message sweep: (carry, inputs) -> (carry,
    outputs), as the JAX scan step."""

    def step(carry, inputs):
        fused_prev_mean, fused_prev_cov = carry
        (lp_prev, lp_cur, fut_prev_mean, fut_prev_cov, odo, past_mean, past_cov, fut_mean,
         fut_cov, m_const, m_mean, m_cov, m_logw, active) = inputs
        half_mean, half_cov = _unfuse(fused_prev_mean, fused_prev_cov, fut_prev_mean, fut_prev_cov)
        estpose = model.pose.add_odometry(model.pose.add(lp_prev, half_mean), odo)
        jac = motion_jacobian(model, lp_prev, lp_cur, half_mean, odo)
        newcov = torch.einsum("...ij,...jk,...lk->...il", jac, half_cov, jac) + motion_cov
        new_past_mean = torch.where(active, model.pose.subtract(estpose, lp_cur), past_mean)
        new_past_cov = torch.where(active, newcov, past_cov)
        pf_mean, pf_cov = _fuse(new_past_mean, new_past_cov, fut_mean, fut_cov)
        fused = fuse_with_mixture(pf_mean, pf_cov, m_const, m_mean, m_cov, m_logw)
        return fused, (new_past_mean, new_past_cov) + fused

    return step


def forward_sweep(model, state: LoopyState, odometry, motion_cov):
    """msg_past[t] from fused[t-1] / future[t-1] (UpdateMessagesFromPast,
    :427-460), node by node. Node 0 keeps its Dirac past message."""
    step = make_forward_step(model, motion_cov)
    t = state.lp.shape[0]
    f0 = _fuse3_single(model, state, 0)
    carry, outs = f0, [(state.past_mean[0], state.past_cov[0]) + f0]
    for i in range(1, t):
        inputs = (state.lp[i - 1], state.lp[i], state.future_mean[i - 1], state.future_cov[i - 1],
                  odometry[i - 1], state.past_mean[i], state.past_cov[i], state.future_mean[i],
                  state.future_cov[i], state.map_const[i], state.map_mean[i], state.map_cov[i],
                  state.map_logw[i], state.node_mask[i])
        carry, out = step(carry, inputs)
        outs.append(out)
    past_mean, past_cov, fused_mean, fused_cov = (torch.stack(x) for x in zip(*outs))
    return state._replace(past_mean=past_mean, past_cov=past_cov, fused_mean=fused_mean,
                          fused_cov=fused_cov)


def _pinv(mat):
    """Moore-Penrose pseudo-inverse of the symmetric part, by eigen-
    decomposition."""
    sym = 0.5 * (mat + mat.transpose(-1, -2))
    lam, vec = torch.linalg.eigh(sym)
    inv_lam = torch.where(torch.abs(lam) > 1e-9, 1.0 / lam, torch.zeros_like(lam))
    return torch.einsum("...ab,...b,...cb->...ac", vec, inv_lam, vec)


def make_backward_step(model, motion_cov):
    """One step of the backward message sweep (reverse direction, pseudo-
    inverse Jacobian)."""

    def step(carry, inputs):
        fused_next_mean, fused_next_cov = carry
        (lp_cur, lp_next, past_next_mean, past_next_cov, odo, fut_mean, fut_cov, past_mean,
         past_cov, m_const, m_mean, m_cov, m_logw, active) = inputs
        half_mean, half_cov = _unfuse(fused_next_mean, fused_next_cov, past_next_mean, past_next_cov)
        estpose = model.pose.add_odometry(model.pose.add(lp_next, half_mean), -odo)
        est_tangent = model.pose.subtract(estpose, lp_cur)
        jac = _pinv(motion_jacobian(model, lp_cur, lp_next, est_tangent, odo))
        newcov = torch.einsum("...ij,...jk,...lk->...il", jac, half_cov, jac) + motion_cov
        new_fut_mean = torch.where(active, est_tangent, fut_mean)
        new_fut_cov = torch.where(active, newcov, fut_cov)
        pf_mean, pf_cov = _fuse(past_mean, past_cov, new_fut_mean, new_fut_cov)
        fused = fuse_with_mixture(pf_mean, pf_cov, m_const, m_mean, m_cov, m_logw)
        return fused, (new_fut_mean, new_fut_cov) + fused

    return step


def backward_sweep(model, state: LoopyState, odometry, motion_cov):
    """msg_future[t] from fused[t+1] / past[t+1] (UpdateMessagesFromFuture,
    :467-501), from the last node back; the last live node keeps its unit
    future message."""
    step = make_backward_step(model, motion_cov)
    t = state.lp.shape[0]
    n_nodes = torch.sum(state.node_mask)
    active = (torch.arange(t, device=n_nodes.device) < n_nodes - 1) & state.node_mask
    last = (n_nodes - 1).reshape(1)
    carry = (state.fused_mean.index_select(0, last)[0], state.fused_cov.index_select(0, last)[0])
    outs = [None] * t
    for i in range(t - 1, -1, -1):
        nxt = (i + 1) % t
        inputs = (state.lp[i], state.lp[nxt], state.past_mean[nxt], state.past_cov[nxt],
                  odometry[i], state.future_mean[i], state.future_cov[i], state.past_mean[i],
                  state.past_cov[i], state.map_const[i], state.map_mean[i], state.map_cov[i],
                  state.map_logw[i], active[i])
        carry, outs[i] = step(carry, inputs)
    fut_mean, fut_cov, fused_mean, fused_cov = (torch.stack(x) for x in zip(*outs))
    return state._replace(future_mean=fut_mean, future_cov=fut_cov, fused_mean=fused_mean,
                          fused_cov=fused_cov)


# ----------------------------------------------------------------------
# mapping passes (cavity maps, causal maps, final map)


def _select(keep, new, old):
    """new where `keep`, else old, leaf by leaf (nested NamedTuples)."""
    if isinstance(new, tuple):
        return type(new)(*[_select(keep, a, b) for a, b in zip(new, old)])
    return torch.where(keep, new, old)


def _masked_frame_step(model, params, step):
    """Mapping-PHD frame update that is inert on INVALID frames (padded
    trajectory slots past n_nodes): a padded frame is skipped as a whole,
    while a cavity-EXCLUDED frame only drops its measurements (its
    misdetection update stays; see the JAX twin's note)."""

    def frame_step(st, pose_t, z_t, mask_t, valid_t):
        zero_odo = torch.zeros((model.pose.odo_dim,), dtype=pose_t.dtype, device=pose_t.device)
        st2 = step(params, st, zero_odo, z_t, mask_t, None, None, true_pose=pose_t)
        return _select(valid_t, st2, st)

    return frame_step


def _mapping_run(model, cfg: LoopyConfig, params, poses, particles=1):
    """(frame_step, initial state) of a mapping-only inner filter with
    `particles` maps, on poses' device and dtype."""
    icfg = dataclasses.replace(cfg.inner, num_particles=particles)
    step = phd.make_slam_step(model, icfg, slam=False, kernels=cfg.kernels)
    state0 = phd.init_state(model, icfg, np.zeros(poses.shape[-1]), poses.dtype, poses.device)
    return _masked_frame_step(model, params, step), state0


def _jmap(cfg: LoopyConfig, maps: SGM):
    """The MAP estimate's first jmap_cap components of maps [..., K0]:
    (means [..., J, 3], covs [..., J, 3, 3], valid [..., J])."""
    jidx, jvalid = mixture.best_map_indices(maps.logw, cfg.jmap_cap)
    mean, cov = maps.mean, maps.cov
    jm = torch.gather(mean, -2, jidx[..., None].expand(jidx.shape + (3,)))
    jc = torch.gather(cov, -3, jidx[..., None, None].expand(jidx.shape + (3, 3)))
    return jm, jc, jvalid


def _cavity_passes(model, cfg: LoopyConfig, params, map_poses, z, z_mask, block_ids, node_mask,
                   contiguous):
    """Leave-block-out mapping passes over the trajectory as ONE mapping
    run whose particle b excludes the measurements of block block_ids[b]:
    every particle snaps to the same pose, the fused stage gets a [B, M]
    mask per frame. Returns per-pass jmaps ([B, J, 3], [B, J, 3, 3], [B, J])."""
    t = map_poses.shape[0]
    dev = map_poses.device
    b = cfg.blocks
    ids = torch.as_tensor(block_ids, device=dev)
    tidx = torch.arange(t, device=dev)
    if node_mask is None:
        node_mask = torch.ones((t,), dtype=torch.bool, device=dev)
    if contiguous:
        # block ids span the ACTIVE nodes, not the padded capacity
        n_act = torch.clamp(torch.sum(node_mask), min=1)
        chunk = torch.div(tidx * b, n_act, rounding_mode="floor")
    else:
        chunk = tidx % b
    masks = z_mask[:, None, :] & (chunk[:, None] != ids[None, :])[:, :, None]  # [T, B, M]
    fstep, st = _mapping_run(model, cfg, params, map_poses, len(block_ids))
    for i in range(t):
        st = fstep(st, map_poses[i], z[i], masks[i], node_mask[i])
    return _jmap(cfg, st.maps)


def cavity_map_block(model, cfg: LoopyConfig, params, map_poses, z, z_mask, block_id,
                     node_mask=None, contiguous=False):
    """One leave-block-out mapping pass, excluding the measurements of
    frames with t % B == block_id (or of the contiguous chunk
    t * B // n_active == block_id). Returns (jmap [J, 3], jcov [J, 3, 3],
    jvalid [J])."""
    out = _cavity_passes(model, cfg, params, map_poses, z, z_mask, [block_id], node_mask,
                         contiguous)
    return tuple(x[0] for x in out)


def cavity_maps(model, cfg: LoopyConfig, params, map_poses, z, z_mask, node_mask=None,
                contiguous=False):
    """All B leave-block-out passes in one mapping run (O(B*T) work in place
    of the reference's O(T^2) FilterMissing, :729-763). Returns per-block
    jmaps [B, J, 3], [B, J, 3, 3] and valid [B, J]."""
    return _cavity_passes(model, cfg, params, map_poses, z, z_mask, list(range(cfg.blocks)),
                          node_mask, contiguous)


def causal_maps(model, cfg: LoopyConfig, params, map_poses, z, z_mask, node_mask=None):
    """First-pass cavity maps: node t sees the map filtered over frames
    0..t-1 only (the reference's growing `tofilter = clock + 1`, :375 +
    :729-763). Returns [T, J, 3] means, [T, J, 3, 3] covs, [T, J] valid."""
    t = map_poses.shape[0]
    if node_mask is None:
        node_mask = torch.ones((t,), dtype=torch.bool, device=map_poses.device)
    fstep, st = _mapping_run(model, cfg, params, map_poses)
    before = []
    for i in range(t):
        before.append(mixture.map_soa(lambda a: a[0], st.maps))  # maps of frames 0..i-1
        st = fstep(st, map_poses[i], z[i], z_mask[i], node_mask[i])
    return _jmap(cfg, mixture.map_soa(lambda *a: torch.stack(a), *before))


def final_map(model, cfg: LoopyConfig, params, state: LoopyState, z, z_mask, history=False):
    """Map estimate: the mapping-PHD filter over the fused trajectory
    (BestMapModel / Filter, :186-197, :716-719), as a GM [K0]. history=True
    also returns the map after each frame as a GM with a leading [T] axis
    (the recording's maps.out series, Navigator.cs:269)."""
    with record_function("loopy.final_map"):
        pf_mean, _ = _fuse(state.past_mean, state.past_cov, state.future_mean, state.future_cov)
        poses = model.pose.add(state.lp, pf_mean)
        fstep, st = _mapping_run(model, cfg, params, poses)
        hist = []
        for i in range(poses.shape[0]):
            st = fstep(st, poses[i], z[i], z_mask[i], state.node_mask[i])
            if history:
                hist.append(mixture.map_soa(lambda a: a[0], st.maps))
        final = mixture.aos_of(mixture.map_soa(lambda a: a[0], st.maps))
        if history:
            return final, mixture.aos_of(mixture.map_soa(lambda *a: torch.stack(a), *hist))
        return final


# ----------------------------------------------------------------------
# likelihood, gradient ascent, Hessian


def quasi_ll(model, meas_cov, pd, log_clutter, lp, tangent, jmap, jvalid, z, z_mask, beam_width,
             jcov=None, beam=None):
    """Quasi set log-likelihood at pose lp (+) tangent, batched over the
    leading dims (they broadcast)."""
    pose = model.pose.add(lp, tangent)
    return association.quasi_set_log_likelihood(
        model, meas_cov, pd, log_clutter, pose, jmap, jvalid, z, z_mask, beam_width,
        lm_cov=jcov, beam=beam,
    )


def _grad(fn, x):
    """d fn(x) / dx for a batch of independent rows x [..., O] (fn maps
    [..., O] -> [...]; nothing couples the rows, so the gradient of the sum
    is every row's own)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xg).sum(), xg)
    return g


def _hessian(fn, x):
    """Hessian [..., O, O] of fn at every row of x [..., O]: the gradient
    with its graph kept, then O rows of double backward (jax.hessian is
    jacfwd(jacrev))."""
    o = x.shape[-1]
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xg).sum(), xg, create_graph=True)
        rows = []
        for i in range(o):
            (h,) = torch.autograd.grad(g[..., i].sum(), xg, retain_graph=i < o - 1,
                                       allow_unused=True)
            rows.append(torch.zeros_like(x) if h is None else h)
    return torch.stack(rows, dim=-2).detach()


def _ascend(fn, x, cfg: LoopyConfig, grad_clip, grad_rate, stage=""):
    """Gradient ascent with a parallel step-size fan (:915-963 redesigned),
    for every row of x [..., O] at once: per iteration one gradient pass and
    one value pass over the ga_steps candidates of every row, a candidate
    taken only where it beats the row's current value. Returns (x, fn(x))."""
    with torch.no_grad(), record_function(f"{stage}.fan"):
        fx = fn(x)
        steps = grad_rate / (4.0 ** torch.arange(cfg.ga_steps, dtype=x.dtype, device=x.device))
    for _ in range(cfg.ga_iters):
        with record_function(f"{stage}.grad"):
            g = _grad(fn, x)
        with torch.no_grad(), record_function(f"{stage}.fan"):
            gn = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
            g = torch.where(gn > grad_clip, g * (grad_clip / gn), g)
            cands = x[..., None, :] + steps[:, None] * g[..., None, :]  # [..., S, O]
            fc = fn(cands)
            best = torch.argmax(fc, dim=-1, keepdim=True)
            fbest = torch.gather(fc, -1, best)[..., 0]
            xbest = torch.gather(cands, -2, best[..., None].expand(best.shape + x.shape[-1:]))[..., 0, :]
            better = fbest > fx
            x = torch.where(better[..., None], xbest, x)
            fx = torch.where(better, fbest, fx)
    return x, fx


def _take(x, idx):
    """x [..., K, *rest] gathered at idx [..., G] along the K axis."""
    rest = x.shape[idx.dim():]
    return torch.gather(x, idx.dim() - 1, idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest))


# ----------------------------------------------------------------------
# sequential refit (the reference's Gauss-Seidel first pass)


def make_sequential_refit(model, cfg: LoopyConfig):
    """The sequential re-localisation pass:
    (params, lp, node_mask, odometry, z, z_mask, motion_cov, grad_clip,
    grad_rate) -> corrected trajectory [T, S].

    Node t is re-localised against the map built from nodes 0..t-1, whose
    poses were ALREADY corrected earlier in the pass (the reference's
    growing filter horizon, LoopyPHDNavigator.cs:375 + :729-763): predict
    from the corrected previous pose through the odometry link, maximise
    quasi_ll(pose) - 0.5 (pose - pred)^T Q^-1 (pose - pred) by seeded
    gradient ascent (seeds = FitToMeasurement over (landmark, z) pairs,
    GuidedFitMixture's guesses :777-793), then feed the corrected pose to
    the mapping filter. A loop over the nodes; no value goes to the host."""
    o = model.pose.odo_dim

    def fit_pose(params, minfo, pred, lp_t, jmap, jcov, jvalid, z_t, zm_t, grad_clip, grad_rate):
        log_clutter = torch.log(params.clutter_density)
        beam = phd.route(model, pred.dtype, cfg.kernels).beam

        def obj(tg):
            ll = quasi_ll(model, params.meas_cov, params.pd, log_clutter, pred, tg, jmap, jvalid,
                          z_t, zm_t, cfg.beam_width, jcov=jcov, beam=beam)
            return ll - 0.5 * torch.sum(tg * (tg @ minfo.T), dim=-1)

        with torch.no_grad(), record_function("loopy.refit.seeds"):
            fit = model.fit_to_measurement(model.params, pred, z_t[None, :, :], jmap[:, None, :])
            tangents = model.pose.subtract(fit, pred).reshape(-1, o)  # [J*M, O]
            valid = (jvalid[:, None] & zm_t[None, :]).reshape(-1)
            valid = valid & (torch.sum(tangents * tangents, dim=-1) < cfg.refit_gate ** 2)
            seed_obj = torch.where(valid, obj(tangents), torch.full_like(valid, -math.inf, dtype=pred.dtype))
            top_obj, top = mixture.topk_stable(seed_obj, cfg.refit_seeds)
            # fixed guesses: the odometry prediction and the node's initial
            # estimate, then the best map seeds
            guesses = torch.cat([torch.zeros((1, o), dtype=pred.dtype, device=pred.device),
                                 model.pose.subtract(lp_t, pred)[None, :], tangents[top]])
            gvalid = torch.cat([torch.ones(2, dtype=torch.bool, device=pred.device),
                                top_obj > -math.inf])
        xs, fs = _ascend(obj, guesses, cfg, grad_clip, grad_rate, "loopy.refit")
        fs = torch.where(gvalid & torch.isfinite(fs), fs, torch.full_like(fs, -math.inf))
        best = torch.argmax(fs, dim=0, keepdim=True)
        tg = torch.where(torch.isfinite(fs[best]), xs[best][0], torch.zeros_like(xs[0]))
        return model.pose.add(pred, tg)

    def refit(params, lp, node_mask, odometry, z, z_mask, motion_cov, grad_clip, grad_rate):
        t = lp.shape[0]
        minfo = gaussian.inv(motion_cov)
        fstep, pst = _mapping_run(model, cfg, params, lp)
        prev_pose, traj = lp[0], []
        for i in range(t):
            if i == 0:  # the first node anchors the pass (JAX: where(is_first, lp_t, ...))
                corrected = lp[0]
            else:
                with record_function("loopy.refit.map"):
                    pred = model.pose.add_odometry(prev_pose, odometry[i - 1])
                    jmap, jcov, jvalid = _jmap(cfg, mixture.map_soa(lambda a: a[0], pst.maps))
                corrected = fit_pose(params, minfo, pred, lp[i], jmap, jcov, jvalid, z[i], z_mask[i],
                                     grad_clip, grad_rate)
            with record_function("loopy.refit.map"):
                pst = fstep(pst, corrected, z[i], z_mask[i], node_mask[i])
                prev_pose = torch.where(node_mask[i], corrected, prev_pose)
            traj.append(corrected)
        return torch.where(node_mask[:, None], torch.stack(traj), lp)

    return refit


def reverse_refit_inputs(lp, odometry, z, z_mask):
    """Time-reverse the refit's inputs: the reversed pass is the same scan
    over flipped nodes with rev_odo[k] = -odometry[T-2-k] as the link
    (T-1-k) -> (T-2-k) (for the midpoint-rotation composition the exact
    inverse reading is the negation; see the JAX twin)."""
    odo_r = -torch.roll(torch.flip(odometry, dims=(0,)), -1, dims=0)
    return torch.flip(lp, dims=(0,)), odo_r, torch.flip(z, dims=(0,)), torch.flip(z_mask, dims=(0,))


# ----------------------------------------------------------------------
# guided mixture fitting (GuidedFitMixture, :777-847)


def fit_map_message(model, cfg: LoopyConfig, params, lp, pose0, pf_cov, jmap, jcov, jvalid, z,
                    z_mask, temperature, grad_clip, grad_rate):
    """Fit the (const + mixture) map factor of a batch of nodes: lp [N, S],
    pose0 [N, O], pf_cov [N, O, O], jmap [N, J, 3], jcov [N, J, 3, 3], jvalid
    [N, J], z [N, M, D], z_mask [N, M]. Returns (const [N], means
    [N, G + 1, O], covs [N, G + 1, O, O], log-weights [N, G + 1]) with
    G = mix_cap - 1 fitted components and the anchor last."""
    o = model.pose.odo_dim
    n = lp.shape[0]
    dtype, dev = pose0.dtype, pose0.device
    mc = params.meas_cov
    log_clutter = torch.log(params.clutter_density)
    beam = phd.route(model, dtype, cfg.kernels).beam
    eye = torch.eye(o, dtype=dtype, device=dev)

    def ll(tangent):  # tangent [N, ..., O] -> [N, ...]
        def node(x):  # the node inputs broadcast over the tangent's batch dims
            return x.reshape(x.shape[:1] + (1,) * (tangent.dim() - 2) + x.shape[1:])

        return quasi_ll(model, mc, params.pd, log_clutter, node(lp), tangent, node(jmap),
                        node(jvalid), node(z), node(z_mask), cfg.beam_width, jcov=node(jcov),
                        beam=beam)

    with torch.no_grad():
        # seeds: FitToMeasurement near the estimate, gated at 0.5 plus the
        # node's own chain uncertainty (3 sigma of pf_cov's trace), ranked by
        # their set log-likelihood
        tr = torch.diagonal(pf_cov, dim1=-2, dim2=-1).sum(-1) / o
        seed_r2 = 0.25 + 9.0 * torch.clamp(tr, 0.0, 1e4)
        initpose = model.pose.add(lp, pose0)
        fit = model.fit_to_measurement(model.params, initpose[:, None, None, :], z[:, None, :, :],
                                       jmap[:, :, None, :])  # [N, J, M, S]
        diff = model.pose.subtract(fit, initpose[:, None, None, :])
        valid = (jvalid[:, :, None] & z_mask[:, None, :]
                 & (torch.sum(diff * diff, dim=-1) < seed_r2[:, None, None])).reshape(n, -1)
        tangents = model.pose.subtract(fit, lp[:, None, None, :]).reshape(n, -1, o)
        score = torch.where(valid, ll(tangents), torch.full(valid.shape, -math.inf, dtype=dtype, device=dev))
        top_score, top = mixture.topk_stable(score, cfg.mix_cap - 2)  # +pose0 +anchor slots
        guesses = torch.cat([pose0[:, None, :], _take(tangents, top)], dim=1)  # [N, G, O]
        guess_valid = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                                 _take(valid, top) & (top_score > -math.inf)], dim=1)
        # empty-space likelihood: the pose far from everything (:807-811)
        far = torch.full((o,), 1e5, dtype=dtype, device=dev)
        emptyspace = quasi_ll(model, mc, params.pd, log_clutter,
                              model.pose.identity(dtype, dev), far, jmap, jvalid, z, z_mask,
                              cfg.beam_width, jcov=jcov, beam=beam)  # [N]

    maxpose, maxval = _ascend(ll, guesses, cfg, grad_clip, grad_rate, "loopy.sweep.map")

    # covariance: clamped-eigenvalue pseudo-inverse of -Hessian
    # (:974-1019); NaN Hessians are zeroed as the reference guards (:1000-1002)
    hess = _hessian(ll, maxpose)
    with torch.no_grad():
        hess = torch.where(torch.isnan(hess), torch.zeros_like(hess), hess)
        hess = 0.5 * (hess + hess.transpose(-1, -2))
        lam, vec = torch.linalg.eigh(hess)
        lam = torch.clamp(lam, max=0.0)
        inv_lam = torch.where(lam < -1e-9, -1.0 / lam, torch.zeros_like(lam))
        cov = torch.einsum("...ab,...b,...cb->...ac", vec, inv_lam, vec)
        logdet = torch.where(inv_lam > 0, torch.log(inv_lam), torch.zeros_like(inv_lam))
        logw = maxval + 0.5 * (o * math.log(2 * math.pi) + torch.sum(logdet, dim=-1))

        # validity: above empty space (:820-822), finite, and no duplicate of
        # an earlier component (Mahalanobis < 0.1, :826-836)
        alive = (guess_valid & (maxval - emptyspace[:, None] >= 0)
                 & torch.all(torch.isfinite(maxpose), dim=-1) & torch.isfinite(maxval))
        g = guesses.shape[1]
        diffm = maxpose[:, None, :, :] - maxpose[:, :, None, :]  # [N, i, j, O] = x_j - x_i
        m2 = torch.einsum("nijd,nide,nije->nij", diffm, _pinv(cov), diffm)
        dup = (m2 < 0.01) & alive[:, :, None]
        earlier = torch.tril(torch.ones((g, g), dtype=torch.bool, device=dev), diagonal=-1)
        alive = alive & ~torch.any(dup.transpose(-1, -2) & earlier, dim=-1)

        # annealed covariance (UpdateMessagesFromMap, :537-543); dead
        # components sanitised so no NaN leaks into moment sums
        cov = cov + (1.0 + temperature) * pf_cov[:, None]
        logw = torch.where(alive, logw, torch.full_like(logw, DEAD))
        maxpose = torch.where(alive[..., None], maxpose, torch.zeros_like(maxpose))
        cov = torch.where(alive[..., None, None], cov, eye)

        # trust-region anchor N(tangent; 0, (sigma^2 + pf_tr) I) at the
        # linearisation point (see the JAX twin's note); the const branch
        # becomes the explicit anchor component
        pf_tr = torch.clamp(tr, 0.0, 100.0 * cfg.anchor_sigma ** 2)
        eye_a = (cfg.anchor_sigma ** 2 + pf_tr)[:, None, None] * eye  # [N, O, O]
        zero = torch.zeros((o,), dtype=dtype, device=dev)
        am, ac = _fuse(maxpose, cov, zero, eye_a[:, None])
        ascale = gaussian.logpdf(maxpose, zero, cov + eye_a[:, None])
        logw = torch.where(alive, logw + ascale, torch.full_like(logw, DEAD))
        maxpose = torch.where(alive[..., None], am, torch.zeros_like(am))
        cov = torch.where(alive[..., None, None], ac, eye)
        maxpose = torch.cat([maxpose, zero.expand(n, 1, o)], dim=1)
        cov = torch.cat([cov, eye_a[:, None]], dim=1)
        logw = torch.cat([logw, emptyspace[:, None]], dim=1)
        return torch.full((n,), DEAD, dtype=dtype, device=dev), maxpose, cov, logw


def map_sweep(model, cfg: LoopyConfig, params, state: LoopyState, z, z_mask, temperature,
              grad_clip, grad_rate, causal=False):
    """Update every node's map message (UpdateMessagesFromMap, :511-552),
    NODE_CHUNK nodes at a time. causal=True uses the first-pass filtering
    maps (frames 0..t-1 per node)."""
    # node-local cavity pose: past x future, own map factor excluded (:559-575)
    pf_mean, pf_cov = _fuse(state.past_mean, state.past_cov, state.future_mean, state.future_cov)
    # the maps are built from the full fused beliefs (:186-197 / :729-763)
    map_poses = model.pose.add(state.lp, state.fused_mean)
    t = state.lp.shape[0]
    tidx = torch.arange(t, device=map_poses.device)
    if causal:
        jmaps, jcovs, jvalids = causal_maps(model, cfg, params, map_poses, z, z_mask, state.node_mask)
        block_ids = tidx
    else:
        jmaps, jcovs, jvalids = cavity_maps(model, cfg, params, map_poses, z, z_mask, state.node_mask)
        block_ids = tidx % cfg.blocks
    return fit_map_messages(model, cfg, params, state, pf_mean, pf_cov, (jmaps, jcovs, jvalids),
                            block_ids, z, z_mask, temperature, grad_clip, grad_rate)


def fit_map_messages(model, cfg: LoopyConfig, params, state: LoopyState, pf_mean, pf_cov, jmaps,
                     block_ids, z, z_mask, temperature, grad_clip, grad_rate):
    """Fit the map message of every node of `state` against the jmaps
    (means, covs, valid) of its block, jmaps[i][block_ids[node]],
    NODE_CHUNK nodes at a time, then re-fuse. A node without measurements
    keeps only the trust-region anchor."""
    jmaps, jcovs, jvalids = jmaps
    t = state.lp.shape[0]
    parts = []
    for s in range(0, t, NODE_CHUNK):
        ids = block_ids[s : s + NODE_CHUNK]
        parts.append(fit_map_message(
            model, cfg, params, state.lp[s : s + NODE_CHUNK], pf_mean[s : s + NODE_CHUNK],
            pf_cov[s : s + NODE_CHUNK], jmaps[ids], jcovs[ids], jvalids[ids], z[s : s + NODE_CHUNK],
            z_mask[s : s + NODE_CHUNK], temperature, grad_clip, grad_rate,
        ))
    m_const, m_mean, m_cov, m_logw = (torch.cat(x) for x in zip(*parts))
    # nodes without measurements keep only the trust-region anchor (last
    # slot), as the reference carries a flat factor there (:530-544)
    no_meas = torch.full((m_logw.shape[1],), DEAD, dtype=m_logw.dtype, device=m_logw.device)
    no_meas[-1] = 0.0
    m_logw = torch.where(torch.any(z_mask, dim=-1)[:, None], m_logw, no_meas)
    state = state._replace(map_const=m_const, map_mean=m_mean, map_cov=m_cov, map_logw=m_logw)
    fused_mean, fused_cov = _fuse3(state)
    return state._replace(fused_mean=fused_mean, fused_cov=fused_cov)


def refuse_map(model, state: LoopyState):
    """Re-fuse past x future x the STORED map messages (the frozen-map
    sweep's fusion step)."""
    fused_mean, fused_cov = _fuse3(state)
    return state._replace(fused_mean=fused_mean, fused_cov=fused_cov)


# ----------------------------------------------------------------------


def gauge_fix_shear(state: LoopyState):
    """Project the shear gauge mode (a coherent warp growing linearly from
    the t=0 anchor, nearly free in the joint posterior) out of the fused
    belief: the best-fit b*t of the deviation from lp is removed."""
    t = state.lp.shape[0]
    ts = torch.arange(t, dtype=state.fused_mean.dtype, device=state.fused_mean.device)
    ts = torch.where(state.node_mask, ts, torch.zeros_like(ts))
    b = torch.sum(ts[:, None] * state.fused_mean, dim=0) / torch.clamp(torch.sum(ts * ts), min=1.0)
    fixed = state.fused_mean - ts[:, None] * b[None, :]
    return state._replace(fused_mean=torch.where(state.node_mask[:, None], fixed, state.fused_mean))


def make_sweep(model, cfg: LoopyConfig, causal=False, damping=0.6, freeze_map=False):
    """One full Jacobi sweep: forward + backward + map messages (causal=True:
    over the first-pass filtering maps; freeze_map=True: the stored map
    messages re-fused, pure Gaussian BP on the chain), then information-
    form damping with the previous fused belief and the shear gauge fix."""

    def sweep(params, state, odometry, z, z_mask, temperature, grad_clip, grad_rate, motion_cov):
        old_mean, old_cov = state.fused_mean, state.fused_cov
        with record_function("loopy.sweep.forward"):
            state = forward_sweep(model, state, odometry, motion_cov)
        with record_function("loopy.sweep.backward"):
            state = backward_sweep(model, state, odometry, motion_cov)
        if not freeze_map:
            with record_function("loopy.sweep.map"):
                state = map_sweep(model, cfg, params, state, z, z_mask, temperature, grad_clip,
                                  grad_rate, causal=causal)
        with record_function("loopy.sweep.fuse"):
            if freeze_map:
                state = refuse_map(model, state)
            if damping < 1.0:
                a = torch.as_tensor(damping, dtype=state.fused_mean.dtype)
                inew = gaussian.inv(state.fused_cov)
                iold = gaussian.inv(old_cov)
                cov = gaussian.inv(a * inew + (1 - a) * iold)
                vec = a * _mv(inew, state.fused_mean) + (1 - a) * _mv(iold, old_mean)
                state = state._replace(fused_mean=_mv(cov, vec), fused_cov=cov)
            if cfg.gauge_fix:
                state = gauge_fix_shear(state)
        return state

    return sweep


def fused_trajectory(model, state: LoopyState):
    """Current pose estimates: lp[t] (+) fused_mean[t]."""
    return model.pose.add(state.lp, state.fused_mean)


def relinearize(model, state: LoopyState):
    """Move the linearisation points to the current fused estimate and
    re-express every message mean in the new tangent space (covariances
    carried untransported; see the JAX twin's note)."""
    new_lp = model.pose.add(state.lp, state.fused_mean)
    mask = state.node_mask[:, None]
    new_lp = torch.where(mask, new_lp, state.lp)

    def move(mean, lp=state.lp, nlp=new_lp):
        return model.pose.subtract(model.pose.add(lp, mean), nlp)

    return state._replace(
        lp=new_lp,
        past_mean=torch.where(mask, move(state.past_mean), state.past_mean),
        future_mean=torch.where(mask, move(state.future_mean), state.future_mean),
        map_mean=torch.where(mask[:, :, None],
                             move(state.map_mean, state.lp[:, None], new_lp[:, None]),
                             state.map_mean),
        fused_mean=torch.where(mask, torch.zeros_like(state.fused_mean), state.fused_mean),
    )


def trajectory_objective(model, cfg: LoopyConfig, params, state: LoopyState, odometry, z, z_mask,
                         motion_cov):
    """Model-selection scores of the fused trajectory, as tensors
    (chain_term, measurement_term): the odometry chain consistency, and the
    CROSS-VALIDATED measurement set log-likelihood -- frame t's measurements
    scored against the cavity map that excludes frame t's contiguous block
    (see the JAX twin's note on why self-scoring cannot select)."""
    poses = fused_trajectory(model, state)
    t = poses.shape[0]
    tidx = torch.arange(t, device=poses.device)
    with record_function("loopy.objective.ll"):
        prev = torch.roll(poses, 1, dims=0)
        err = model.pose.diff_odometry(poses, prev) - torch.roll(odometry, 1, dims=0)
        chain = -0.5 * torch.einsum("td,de,te->t", err, gaussian.inv(motion_cov), err)
        chain = torch.where((tidx >= 1) & state.node_mask, chain, torch.zeros_like(chain))
    with record_function("loopy.objective.cavity"):
        jmaps, jcovs, jvalids = cavity_maps(model, cfg, params, poses, z, z_mask, state.node_mask,
                                            contiguous=True)
    with record_function("loopy.objective.ll"):
        n_act = torch.clamp(torch.sum(state.node_mask), min=1)
        block_ids = torch.clamp(torch.div(tidx * cfg.blocks, n_act, rounding_mode="floor"),
                                max=cfg.blocks - 1)
        map_term = association.quasi_set_log_likelihood(
            model, params.meas_cov, params.pd, torch.log(params.clutter_density), poses,
            jmaps[block_ids], jvalids[block_ids], z, z_mask, cfg.beam_width,
            lm_cov=jcovs[block_ids], beam=phd.route(model, poses.dtype, cfg.kernels).beam,
        )
        map_term = torch.where(state.node_mask, map_term, torch.zeros_like(map_term))
        return torch.sum(chain), torch.sum(map_term)
