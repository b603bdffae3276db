"""Distributed Schur-complement bundle adjustment over the ranks of a
torch.distributed group (the torch twin of monorfs_tpu.parallel.dist_ba).

The single-card backend (slam/graph.py) is a dense batch Gauss-Newton with
a landmark-block Schur complement, the replacement for the reference's
gtsam/iSAM2 bridge (isam2/isam2.cpp:46-365). This module scales the same
math to the BASELINE flagship (10k landmarks) by sharding the LANDMARK axis:

  * landmarks [L, 3], their masks, and the measurement factors that touch
    them live on the rank that owns the landmark (`partition_factors`
    routes them);
  * every rank assembles its local Hll (3x3 blocks), Hpl, bl and its share
    of the reduced pose system
        Hred_local = Hpp_meas_local - Hpl Hll^-1 Hpl^T
        bred_local = bp_meas_local - Hpl Hll^-1 bl
  * ONE psum a Gauss-Newton iteration reduces (Hred, bred): (T O)^2 + T O
    floats, whatever L is;
  * the odometry chain and the gauges are pose-only and added after the
    psum on every rank; the reduced [T O, T O] solve is replicated;
  * the landmark back-substitution dxl = Hll^-1 (bl - Hpl^T dxp) is local.

Each piece is the single-card solver's own (graph.schur_reduce,
graph.reduced_solve, graph.back_substitute, graph.odometry_blocks,
graph.pin): only the psum between them is new.
"""

import dataclasses

import numpy as np
import torch

from ..slam import graph as _graph
from . import collectives as C
from .mesh import local_rows, make_mesh


@dataclasses.dataclass(frozen=True)
class DistBAConfig:
    max_poses: int
    max_landmarks: int  # global capacity; must divide by the number of ranks
    max_factors: int  # global capacity; must divide by the number of ranks
    gn_iters: int = 5
    damping: float = 1e-6


def make_landmark_mesh(device=None, group=None):
    """The `landmarks` mesh over every rank of the group."""
    return make_mesh(device=device, axis="landmarks", group=group)


def partition_factors(cfg: DistBAConfig, n_shards, f_pose, f_lm, f_z, f_mask):
    """Host-side: route each measurement factor to the shard that owns its
    landmark and reindex f_lm to shard-local ids.

    Landmark j lives on shard j // (L // n_shards). Returns factor arrays of
    shape [n_shards * Fl, ...] laid out so that shard s's rows are its own
    factors. Raises if any shard's factors overflow its local capacity."""
    l_local = cfg.max_landmarks // n_shards
    f_local = cfg.max_factors // n_shards
    f_pose = np.asarray(f_pose)
    f_lm = np.asarray(f_lm)
    f_z = np.asarray(f_z)
    f_mask = np.asarray(f_mask)

    out_pose = np.zeros((n_shards, f_local), np.int32)
    out_lm = np.zeros((n_shards, f_local), np.int32)
    out_z = np.zeros((n_shards, f_local, f_z.shape[-1]), f_z.dtype)
    out_mask = np.zeros((n_shards, f_local), bool)
    fill = np.zeros(n_shards, np.int64)
    owner = f_lm // l_local
    for i in np.flatnonzero(f_mask):
        s = owner[i]
        k = fill[s]
        if k >= f_local:
            raise ValueError(
                f"shard {s} overflows local factor capacity {f_local}"
            )
        out_pose[s, k] = f_pose[i]
        out_lm[s, k] = f_lm[i] - s * l_local
        out_z[s, k] = f_z[i]
        out_mask[s, k] = True
        fill[s] += 1
    return (
        out_pose.reshape(-1),
        out_lm.reshape(-1),
        out_z.reshape(-1, f_z.shape[-1]),
        out_mask.reshape(-1),
    )


def _meas_normal_contrib(model, cfg, o, poses, landmarks_l, lm_mask_l, f_pose, f_lm, f_z, f_mask,
                         meas_info):
    """This rank's measurement-factor blocks of the normal equations: the
    linearisation of graph._linearize_measurements (PixelRangeFactor.cpp:
    76-110) per factor, indexed into the LOCAL landmark slab. A factor
    touches one pose, so its Hpp share is block-diagonal."""
    t = cfg.max_poses
    l_local = landmarks_l.shape[0]
    dtype, dev = poses.dtype, poses.device

    pose = poses[f_pose]  # [Fl, S]
    lm = _graph._safe_landmark(model, pose, landmarks_l[f_lm], f_mask)
    r = model.measure(model.params, pose, lm) - f_z
    jp = model.jac_pose(model.params, pose, lm)  # [Fl, D, O]
    jl = model.jac_landmark(model.params, pose, lm)  # [Fl, D, 3]

    wm = f_mask.to(dtype)
    jp_w = torch.einsum("de,feb->fdb", meas_info, jp) * wm[:, None, None]
    jl_w = torch.einsum("de,feb->fdb", meas_info, jl) * wm[:, None, None]

    diag = torch.zeros((t, o, o), dtype=dtype, device=dev)
    diag.index_add_(0, f_pose, torch.einsum("fba,fbc->fac", jp, jp_w))
    hpl = torch.zeros((t, l_local, o, 3), dtype=dtype, device=dev)
    hpl.index_put_((f_pose, f_lm), torch.einsum("fba,fbc->fac", jp, jl_w), accumulate=True)
    hll = torch.zeros((l_local, 3, 3), dtype=dtype, device=dev)
    hll.index_add_(0, f_lm, torch.einsum("fba,fbc->fac", jl, jl_w))
    bp = torch.zeros((t, o), dtype=dtype, device=dev)
    bp.index_add_(0, f_pose, -torch.einsum("fba,fb->fa", jp_w, r))
    bl = torch.zeros((l_local, 3), dtype=dtype, device=dev)
    bl.index_add_(0, f_lm, -torch.einsum("fba,fb->fa", jl_w, r))
    return (_graph.block_tridiagonal(diag), hpl.permute(0, 2, 1, 3).reshape(t * o, l_local * 3),
            hll, bp.reshape(-1), bl)


def _chain_normal_contrib(model, poses, between, between_mask, motion_info):
    """The pose-only odometry-chain terms (Hpp [T O, T O], bp [T O]), the
    same on every rank: graph.odometry_blocks, dense."""
    diag, upper, lower, bp = _graph.odometry_blocks(model, poses, between, between_mask,
                                                    motion_info)
    return _graph.block_tridiagonal(diag, upper, lower), bp.reshape(-1)


def make_dist_gauss_newton(model, cfg: DistBAConfig, mesh):
    """The distributed GN solve on this rank:
      (poses [T, S] (whole), n_poses, pose_fixed [T], between [T, O],
       between_mask [T], landmarks_l [L/N, 3], lm_mask_l [L/N],
       f_pose [F/N], f_lm [F/N] (rank-local landmark ids from
       `partition_factors`), f_z [F/N, D], f_mask [F/N],
       motion_info [O, O], meas_info [D, D])
      -> (poses [T, S] (whole, the same on every rank), landmarks_l)."""
    o = model.pose.odo_dim
    if cfg.max_landmarks % mesh.size or cfg.max_factors % mesh.size:
        raise ValueError("landmark/factor capacity must divide the number of ranks")
    t = cfg.max_poses

    def solve(poses, n_poses, pose_fixed, between, between_mask, landmarks_l, lm_mask_l, f_pose,
              f_lm, f_z, f_mask, motion_info, meas_info):
        _graph.assert_full_precision()
        free = _graph.free_coordinates(t, n_poses, pose_fixed, o)
        live = (torch.arange(t, device=poses.device) < n_poses)[:, None]
        for _ in range(cfg.gn_iters):
            hpp_m, hpl, hll, bp_m, bl = _meas_normal_contrib(
                model, cfg, o, poses, landmarks_l, lm_mask_l, f_pose, f_lm, f_z, f_mask, meas_info
            )
            hred, bred, hll_inv, _, hpl_b = _graph.schur_reduce(lm_mask_l, hpp_m, hpl, hll, bp_m, bl,
                                                                cfg.damping)
            # the ONLY collective: reduce the pose system over landmark shards
            red = C.psum(mesh, torch.cat([hred.reshape(-1), bred]))
            hred, bred = red[: (t * o) ** 2].reshape(t * o, t * o), red[(t * o) ** 2:]
            # replicated pose-only terms: odometry chain + gauge pinning
            hpp_c, bp_c = _chain_normal_contrib(model, poses, between, between_mask, motion_info)
            hred, bred = _graph.pin(free, hred + hpp_c, bred + bp_c)
            dxp, _ = _graph.reduced_solve(hred, bred, cfg.damping)
            dxl = _graph.back_substitute(lm_mask_l, hll_inv, hpl_b, bl, dxp)  # local
            new_poses = model.pose.add(poses, dxp.reshape(t, o))
            poses = torch.where(live, new_poses, poses)
            landmarks_l = landmarks_l + dxl
        return poses, landmarks_l

    return solve


def shard_ba_inputs(mesh, landmarks, lm_mask, f_pose, f_lm, f_z, f_mask):
    """This rank's rows of the landmark and factor arrays (the factor arrays
    partitioned by `partition_factors`), on the mesh's device, the ids as
    int64."""
    lrows = local_rows(mesh, len(lm_mask))
    frows = local_rows(mesh, len(f_mask))
    put = lambda x, rows: torch.as_tensor(np.asarray(x)[rows]).to(mesh.device)
    return (put(landmarks, lrows), put(lm_mask, lrows), put(f_pose, frows).long(),
            put(f_lm, frows).long(), put(f_z, frows), put(f_mask, frows))
