"""Batch factor-graph solver: Gauss-Newton with landmark Schur complement
(the torch twin of monorfs_tpu.slam.graph).

Stands in for the reference's gtsam/iSAM2 bridge (isam2/isam2.cpp:46-365 +
PixelRangeFactor.cpp:41-110). The whole graph lives in fixed-capacity dense
factor arrays and every update re-solves by batched Gauss-Newton:

  * between (odometry) factors chain consecutive poses (isam2.cpp:234-238);
  * measurement factors couple poses and landmarks (isam2.cpp:216-232), the
    residual and Jacobians taken from the model registry;
  * pose 0 is pinned (gauge prior, isam2.cpp:167); in mapping mode every
    pose is pinned (the reference's hard prior, isam2.cpp:240-242).

The normal equations are reduced by the Schur complement on the landmark
block: Hll is 3x3-block-diagonal and closed-form invertible, the reduced
pose system is one dense Cholesky solve. Marginal pose/landmark covariances
(for Mahalanobis gating, J Sigma J^T + R as in isam2.cpp:258-312) come from
the same factorization.

Assembly is deterministic: no scatter-add touches the normal equations. A
scatter-add on CUDA is a set of atomics whose float summation order changes
from run to run, and the association thresholds downstream turn a last-bit
difference into another label. Instead

  * the between factors touch each pose block at most twice, so their sums
    are written as shifted sums onto the block diagonals;
  * the measurement factors are gathered, after a stable sort by pose, into
    a dense [pose, slot] layout (`factor_layout`), and every per-pose sum is
    a reduction over the slot axis; the landmark-keyed sums (Hll, bl and the
    landmark axis of Hpl) are exact one-hot products over that layout, in
    the solve's own dtype with TF32 off.

`n_poses` is a Python int (the callers know it on the host), so no flag is
read from the device here apart from the Cholesky's own status check.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from .. import resolve_device
from ..gm import gaussian


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    max_poses: int
    max_landmarks: int
    max_factors: int
    gn_iters: int = 5
    damping: float = 1e-6
    # static bound on the measurement factors of one pose (the slot axis of
    # the dense layout); None reads the largest count from the device
    factors_per_pose: Optional[int] = None


# Cholesky factorizations made since the caller last reset it; each one reads
# its status back from the device
counts = {"cholesky": 0}


class GraphState(NamedTuple):
    """Factor arrays + current estimates (all fixed capacity, masked)."""

    poses: torch.Tensor  # [T, S] estimates
    n_poses: int  # number of active poses
    landmarks: torch.Tensor  # [L, 3]
    lm_mask: torch.Tensor  # [L]
    between: torch.Tensor  # [T, O]: delta linking pose t-1 -> t
    between_mask: torch.Tensor  # [T]
    pose_fixed: torch.Tensor  # [T] poses pinned (mapping mode / gauge)
    f_pose: torch.Tensor  # [F] int64 pose index per measurement factor
    f_lm: torch.Tensor  # [F] int64 landmark index
    f_z: torch.Tensor  # [F, D]
    f_mask: torch.Tensor  # [F]


class FactorLayout(NamedTuple):
    """The measurement factors as dense per-pose slots."""

    lm: torch.Tensor  # [T, R] int64 landmark index (0 in empty slots)
    z: torch.Tensor  # [T, R, D]
    mask: torch.Tensor  # [T, R] slot holds an active factor


def assert_full_precision():
    """The solve needs true float32/float64 products: TF32 gave NaN at ~300
    poses in the reference's reduced-precision runs."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "the graph solve needs torch.backends.cuda.matmul.allow_tf32 and "
            "torch.backends.cudnn.allow_tf32 to be False"
        )


def empty_state(model, cfg: GraphConfig, init_pose, dtype=torch.float32, device="cuda"):
    dev = resolve_device(device)
    t, l, f = cfg.max_poses, cfg.max_landmarks, cfg.max_factors
    o, d = model.pose.odo_dim, model.meas_dim
    ident = torch.as_tensor(init_pose, dtype=dtype, device=dev)
    fixed = torch.zeros((t,), dtype=torch.bool, device=dev)
    fixed[0] = True
    return GraphState(
        poses=ident.expand(t, -1).clone(),
        n_poses=1,
        landmarks=torch.zeros((l, 3), dtype=dtype, device=dev),
        lm_mask=torch.zeros((l,), dtype=torch.bool, device=dev),
        between=torch.zeros((t, o), dtype=dtype, device=dev),
        between_mask=torch.zeros((t,), dtype=torch.bool, device=dev),
        pose_fixed=fixed,
        f_pose=torch.zeros((f,), dtype=torch.int64, device=dev),
        f_lm=torch.zeros((f,), dtype=torch.int64, device=dev),
        f_z=torch.zeros((f, d), dtype=dtype, device=dev),
        f_mask=torch.zeros((f,), dtype=torch.bool, device=dev),
    )


def _linearize_between(model, state: GraphState):
    """Residuals + Jacobians of the odometry chain wrt the `add` tangent of
    both endpoint poses. [T] factors: factor t links t-1 -> t. The Jacobians
    are forward-mode derivatives of the residual at a zero tangent, as the
    JAX package takes them."""
    prev = torch.roll(state.poses, 1, dims=0)
    cur = state.poses
    delta = state.between

    o = model.pose.odo_dim

    def res(dprev, dcur):
        """e = diff_odometry(cur, prev) - delta in the odometry tangent."""
        return model.pose.diff_odometry(
            model.pose.add(cur, dcur), model.pose.add(prev, dprev)
        ) - delta

    # one forward-mode pass carries all 2 O tangent directions as a leading
    # axis: direction k perturbs the k-th tangent coordinate of every factor
    basis = torch.eye(2 * o, dtype=cur.dtype, device=cur.device)[:, None, :]
    shape = (2 * o, cur.shape[0], o)
    zero = torch.zeros(shape, dtype=cur.dtype, device=cur.device)
    out, tangent = torch.func.jvp(
        res, (zero, zero), (basis[..., :o].expand(shape), basis[..., o:].expand(shape))
    )
    r = out[0]
    jac = tangent.permute(1, 2, 0)  # [T, O, 2 O]
    jprev, jcur = jac[..., :o], jac[..., o:]
    return r, jprev, jcur


def _safe_landmark(model, pose, lm, mask):
    """Replace masked-out landmarks with a point safely in front of the
    camera so inactive factors can't generate NaNs (z_local = 0 divisions)."""
    d = model.meas_dim
    safe_z = torch.zeros(pose.shape[:-1] + (d,), dtype=pose.dtype, device=pose.device)
    if d == 3:  # pixel-range: range 1 straight ahead
        safe_z[..., 2] = 1.0
    safe = model.to_map(model.params, pose, safe_z)
    return torch.where(mask[..., None], lm, safe)


def factor_layout(cfg: GraphConfig, state: GraphState) -> FactorLayout:
    """Gather the active measurement factors into [T, R] slots, pose by pose,
    in their order in the factor arrays (a stable sort; nothing is added up
    here). R is cfg.factors_per_pose, or the largest count read from the
    device."""
    t, f = cfg.max_poses, cfg.max_factors
    dev = state.f_pose.device
    key = torch.where(state.f_mask, state.f_pose, t)
    skey, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(skey, torch.arange(t + 1, device=dev))
    start, count = bounds[:-1], bounds[1:] - bounds[:-1]
    r = cfg.factors_per_pose or max(int(count.max()), 1)
    slot = torch.arange(r, device=dev)
    mask = slot[None, :] < count[:, None]
    src = order[torch.clamp(start[:, None] + slot[None, :], max=f - 1)]
    lm = torch.where(mask, state.f_lm[src], 0)
    return FactorLayout(lm=lm, z=state.f_z[src], mask=mask)


def _linearize_measurements(model, state: GraphState, layout: FactorLayout):
    """Residuals + Jacobians of the measurement factors, in the slot layout
    (PixelRangeFactor.cpp:76-110 equivalents from the model registry)."""
    pose = state.poses[:, None, :].expand(-1, layout.lm.shape[1], -1)  # [T, R, S]
    lm = _safe_landmark(model, pose, state.landmarks[layout.lm], layout.mask)
    r = model.measure(model.params, pose, lm) - layout.z
    jp = model.jac_pose(model.params, pose, lm)  # [T, R, D, O]
    jl = model.jac_landmark(model.params, pose, lm)  # [T, R, D, 3]
    return r, jp, jl


def build_normal_equations(model, cfg, state: GraphState, motion_info, meas_info,
                           layout: Optional[FactorLayout] = None):
    """Assemble H dx = b in tangent space.

    motion_info: [O, O] information of the between factors (inv noise cov);
    meas_info: [D, D] information of the measurement factors."""
    t, l = cfg.max_poses, cfg.max_landmarks
    o = model.pose.odo_dim
    dtype = state.poses.dtype
    dev = state.poses.device
    if layout is None:
        layout = factor_layout(cfg, state)

    # odometry chain: factor i touches blocks i-1 and i (factor 0 links
    # pose 0 to itself and is normally masked out)
    r, jprev, jcur = _linearize_between(model, state)
    w = state.between_mask.to(dtype)
    jprev_w = torch.einsum("de,teb->tdb", motion_info, jprev) * w[:, None, None]
    jcur_w = torch.einsum("de,teb->tdb", motion_info, jcur) * w[:, None, None]
    pp = torch.einsum("tba,tbc->tac", jprev, jprev_w)
    pc = torch.einsum("tba,tbc->tac", jprev, jcur_w)
    cp = torch.einsum("tba,tbc->tac", jcur, jprev_w)
    diag = torch.einsum("tba,tbc->tac", jcur, jcur_w)
    diag[:-1] += pp[1:]
    diag[0] += pp[0] + pc[0] + cp[0]
    gprev = -torch.einsum("tba,tb->ta", jprev_w, r)
    bp = -torch.einsum("tba,tb->ta", jcur_w, r)
    bp[:-1] += gprev[1:]
    bp[0] += gprev[0]

    # measurement factors
    rm, jp, jl = _linearize_measurements(model, state, layout)
    wm = layout.mask.to(dtype)
    jp_w = torch.einsum("de,treb->trdb", meas_info, jp) * wm[..., None, None]
    jl_w = torch.einsum("de,treb->trdb", meas_info, jl) * wm[..., None, None]
    diag += torch.einsum("trba,trbc->tac", jp, jp_w)
    bp += -torch.einsum("trba,trb->ta", jp_w, rm)
    onehot = (layout.lm[..., None] == torch.arange(l, device=dev)).to(dtype)  # [T, R, L]
    hpl = torch.einsum(
        "trac,trl->talc", torch.einsum("trba,trbc->trac", jp, jl_w), onehot
    ).reshape(t * o, l * 3)
    hll = torch.einsum("trl,trac->lac", onehot, torch.einsum("trba,trbc->trac", jl, jl_w))
    bl = -torch.einsum("trl,tra->la", onehot, torch.einsum("trba,trb->tra", jl_w, rm))

    hpp = torch.zeros((t * o, t * o), dtype=dtype, device=dev)
    blocks = hpp.view(t, o, t, o).permute(1, 3, 0, 2)  # [o, o, T, T] view
    blocks.diagonal(dim1=2, dim2=3).copy_(diag.permute(1, 2, 0))
    blocks.diagonal(offset=1, dim1=2, dim2=3).copy_(pc[1:].permute(1, 2, 0))
    blocks.diagonal(offset=-1, dim1=2, dim2=3).copy_(cp[1:].permute(1, 2, 0))
    return hpp, hpl, hll, bp.reshape(-1), bl


def _apply_gauges(cfg, state, o, hpp, hpl, bp):
    """Pin fixed poses and deactivate unused pose slots: identity diagonal,
    zero couplings and rhs."""
    t = cfg.max_poses
    active = (torch.arange(t, device=hpp.device) < state.n_poses) & ~state.pose_fixed
    free = torch.repeat_interleave(active, o)  # [T*O]
    zero = torch.zeros((), dtype=hpp.dtype, device=hpp.device)
    hpp = torch.where(free[:, None] & free[None, :], hpp, zero)
    hpp = hpp + torch.diag((~free).to(hpp.dtype))
    hpl = torch.where(free[:, None], hpl, zero)
    bp = torch.where(free, bp, zero)
    return hpp, hpl, bp


def _schur_solve(cfg, state, o, hpp, hpl, hll, bp, bl, damping):
    """Schur-complement reduction on the landmark block + dense Cholesky."""
    l = cfg.max_landmarks
    dtype = hpp.dtype
    eye3 = torch.eye(3, dtype=dtype, device=hpp.device)
    hll_active = torch.where(state.lm_mask[:, None, None], hll + damping * eye3, eye3)
    hll_inv = gaussian.inv(hll_active)

    hpl_b = hpl.reshape(-1, l, 3)  # [TO, L, 3]
    hpl_hllinv = torch.einsum("nlb,lbc->nlc", hpl_b, hll_inv)
    hred = hpp - torch.einsum("nlc,mlc->nm", hpl_hllinv, hpl_b)
    bred = bp - torch.einsum("nlc,lc->n", hpl_hllinv, bl)

    # dtype-aware Levenberg damping: the Schur complement cancels exactly for
    # single-factor landmarks, so float32 roundoff can leave hred slightly
    # indefinite; damping relative to the diagonal scale absorbs it
    eps = torch.finfo(dtype).eps
    lam = damping + 100.0 * eps * torch.max(torch.diagonal(hred))
    hred = hred + lam * torch.eye(hred.shape[0], dtype=dtype, device=hpp.device)
    # Jacobi preconditioning keeps the reduced solve well-conditioned in
    # float32: Hs = D^-1/2 H D^-1/2
    dscale = torch.rsqrt(torch.clamp(torch.diagonal(hred), min=1e-12))
    hred_s = hred * dscale[:, None] * dscale[None, :]
    # raises (after reading the status from the device) where the reduced
    # system is not positive definite
    chol = torch.linalg.cholesky(hred_s)
    counts["cholesky"] += 1

    def solve(rhs):
        """Hred^-1 @ rhs through the preconditioned factorization."""
        if rhs.ndim == 1:
            return dscale * torch.cholesky_solve((dscale * rhs)[:, None], chol)[:, 0]
        return torch.cholesky_solve(rhs * dscale[:, None], chol) * dscale[:, None]

    dxp = solve(bred)
    resid = bl - torch.einsum("nlb,n->lb", hpl_b, dxp)
    dxl = torch.einsum("lbc,lc->lb", hll_inv, resid)
    dxl = torch.where(state.lm_mask[:, None], dxl, torch.zeros_like(dxl))
    return dxp, dxl, (solve, hll_inv, hpl_hllinv, hpl_b)


@record_function("graph.solve")
def gauss_newton(model, cfg: GraphConfig, state: GraphState, motion_info, meas_info,
                 layout: Optional[FactorLayout] = None):
    """Run cfg.gn_iters Gauss-Newton iterations; returns the updated state.
    The factor arrays do not change between iterations, so their layout is
    made once."""
    assert_full_precision()
    o = model.pose.odo_dim
    if layout is None:
        layout = factor_layout(cfg, state)
    active = (torch.arange(cfg.max_poses, device=state.poses.device) < state.n_poses)[:, None]
    for _ in range(cfg.gn_iters):
        hpp, hpl, hll, bp, bl = build_normal_equations(
            model, cfg, state, motion_info, meas_info, layout
        )
        hpp, hpl, bp = _apply_gauges(cfg, state, o, hpp, hpl, bp)
        dxp, dxl, _ = _schur_solve(cfg, state, o, hpp, hpl, hll, bp, bl, cfg.damping)
        new_poses = model.pose.add(state.poses, dxp.reshape(cfg.max_poses, o))
        state = state._replace(
            poses=torch.where(active, new_poses, state.poses),
            landmarks=state.landmarks + dxl,
        )
    return state


@record_function("graph.marginals")
def marginals(model, cfg: GraphConfig, state: GraphState, motion_info, meas_info, meas_cov,
              layout: Optional[FactorLayout] = None):
    """Marginal covariances from the final linearization:
      - lm_cov [L, 3, 3]: landmark marginal covariance (visualization);
      - pl_cov [L, D, D]: joint (last pose, landmark) covariance projected to
        measurement space, J Sigma J^T + R (isam2.cpp:287-307), used for
        Mahalanobis association gating.
    """
    assert_full_precision()
    o = model.pose.odo_dim
    t, l = cfg.max_poses, cfg.max_landmarks
    hpp, hpl, hll, bp, bl = build_normal_equations(
        model, cfg, state, motion_info, meas_info, layout
    )
    hpp, hpl, bp = _apply_gauges(cfg, state, o, hpp, hpl, bp)
    _, _, (solve, hll_inv, hpl_hllinv, hpl_b) = _schur_solve(
        cfg, state, o, hpp, hpl, hll, bp, bl, cfg.damping
    )

    # B_j = Hpl[:, j] Hll_inv_j: [TO, L, 3]; solve for X = Hred^-1 B
    x_b = solve(hpl_hllinv.reshape(t * o, l * 3)).reshape(t * o, l, 3)

    # landmark marginal: Hll^-1 + B^T Hred^-1 B (per-landmark diagonal block)
    lm_cov = hll_inv + torch.einsum("nlb,nlc->lbc", hpl_hllinv, x_b)

    # last-pose block of Hred^-1 and pose-landmark cross covariance
    last = state.n_poses - 1
    cols = torch.zeros((t * o, o), dtype=hpp.dtype, device=hpp.device)
    cols[last * o : (last + 1) * o] = torch.eye(o, dtype=hpp.dtype, device=hpp.device)
    pose_cols = solve(cols)  # [TO, O]
    pose_cov = pose_cols[last * o : (last + 1) * o]
    # Sigma_pl(last, j) = -(Hred^-1)[last, :] @ B_j  -> [L, O, 3]
    cross = -torch.einsum("nc,nlb->lcb", pose_cols, hpl_hllinv)

    # project to measurement space at the last pose
    last_pose = state.poses[last][None, :].expand(l, -1)
    lms = _safe_landmark(model, last_pose, state.landmarks, state.lm_mask)
    jp = model.jac_pose(model.params, last_pose, lms)
    jl = model.jac_landmark(model.params, last_pose, lms)
    pl_cov = (
        torch.einsum("lda,ab,leb->lde", jp, pose_cov, jp)
        + torch.einsum("lda,lab,leb->lde", jp, cross, jl)
        + torch.einsum("lda,lba,leb->lde", jl, cross, jp)
        + torch.einsum("lda,lab,leb->lde", jl, lm_cov, jl)
        + meas_cov
    )
    return lm_cov, pl_cov
