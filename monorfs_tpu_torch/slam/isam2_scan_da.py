"""Mahalanobis-DA graph SLAM with frontend and backend on the device (the
torch twin of monorfs_tpu.slam.isam2_scan_da).

The reference's iSAM2 workload is per-frame data association plus an
incremental solve, host-interactive (isam2.cpp:199-246 and
ISAM2Navigator.FindLabels, ISAM2Navigator.cs:256-441). This module keeps the
whole Mahalanobis pipeline on the device: gated log-profit matrix in the
projected J Sigma J^T + R metric, linear assignment, candidate lifecycle
with promotion/culling and the penumbra cover discipline, factor writes,
warm-started Gauss-Newton and the amortized marginal refresh.

Against the host navigator (slam/isam2nav.py), semantics kept:

  * the Hungarian becomes the epsilon-scaled auction (slam/assignment.py),
    profit-optimal to S*eps;
  * the candidate list becomes fixed-capacity masked arrays (count 0 = dead
    slot) with cumsum-ranked slot allocation for seeds/promotions;
  * the bucketed host re-solve becomes a fixed-capacity warm-started GN
    iteration per frame, +1 extra iteration on new-landmark frames, exactly
    like the known-DA scan;
  * marginals (the Mahalanobis gate covariances, isam2.cpp:258-312) refresh
    every `marginals_every` frames and on every new-landmark frame.

What the host reads per frame: the auction's stopping flag once per
iteration, the count of promotions (which decides the extra iteration and
the refresh), and the status of each Cholesky. `stats`, when passed to the
runner, collects the auction's iterations per phase and its reads.

Where the JAX module scatters with duplicate indices dropped, the writes
here go to distinct indices, and everything that must not be written goes to
one extra slot that is cut off afterwards.
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from . import assignment, graph
from .isam2_scan import append_frame, clone_carry, scan_setup, vehicle_frame
from ..sim import vehicle as vehicle_mod

CLUTTER = -9999


class DAState(NamedTuple):
    pl_cov: torch.Tensor  # [L_cap, D, D] gate covariances (J Sigma J^T + R)
    cand_mean: torch.Tensor  # [C, 3]
    cand_count: torch.Tensor  # [C] int64, 0 = dead slot
    next_label: int


class ScanDACarry(NamedTuple):
    vstate: vehicle_mod.VehicleState
    gstate: graph.GraphState
    da: DAState
    est_pose: torch.Tensor
    frame: int  # frame counter (marginals cadence)


def _next_mult(n, k):
    return ((n + k - 1) // k) * k


def _put(size, index, values, fill, dtype, device):
    """A [size] tensor of `fill` with `values` written at `index`; an index
    equal to `size` writes nothing."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=device)
    out[index] = values
    return out[:size]


def build_mahalanobis_scan(cfg, world, frames, dtype=torch.float32, max_clutter=8,
                           max_landmarks=None, cand_cap=16, marginals_every=4, eps=0.05,
                           map_cover_radius=0.0, device="cuda"):
    """Return (runner, init_carry, model). runner(carry, commands, draws,
    stats=None) runs the vehicle + Mahalanobis-DA graph-SLAM pipeline;
    per-frame outputs (true_pose, estimated_pose, n_landmarks).

    eps=0.05 and marginals_every=4 are the JAX package's tuned values: with
    the forced seats below the auction's phases converge in tens of
    iterations at any eps, and 0.05 gave the best map accuracy there."""
    graph.assert_full_precision()
    lmax = max(len(world.landmarks), 1)
    l_cap = max_landmarks or _next_mult(2 * lmax, 8)
    model, gcfg, m, vparams, vstate, gstate, (motion_info, meas_info, meas_cov) = scan_setup(
        cfg, world, frames, dtype, max_clutter, l_cap, 1, device
    )
    dtype = gstate.poses.dtype
    dev = gstate.poses.device
    d = model.meas_dim

    thr2 = float(cfg.match_threshold) ** 2
    cover_thr2 = float(3.5 * cfg.match_threshold) ** 2
    log_pd = float(np.log(cfg.detection_probability))
    log_clutter = float(np.log(max(cfg.navigator_clutter_density, 1e-30)))
    promote_at = int(cfg.new_landmark_threshold)
    visible = model.visible_fn()
    NEG = assignment.NEG
    c = cand_cap
    n = l_cap + c
    s = n + m
    rows_n = torch.arange(n, device=dev)
    rows_m = torch.arange(m, device=dev)
    rows_s = torch.arange(s, device=dev)
    slots_c = torch.arange(c, device=dev)

    def profit_rows(mu, covs, z, z_mask):
        """Gated log-profit of N projected sources vs M measurements in the
        given [N, D, D] covariances (ISAM2Navigator.cs:293-365)."""
        ci = torch.linalg.inv(covs)
        _, logdet = torch.linalg.slogdet(covs)
        logmult = -0.5 * (d * np.log(2 * np.pi) + logdet)
        diff = z[None, :, :] - mu[:, None, :]  # [N, M, D]
        d2 = torch.einsum("nmd,nde,nme->nm", diff, ci, diff)
        prof = log_pd + logmult[:, None] - 0.5 * d2
        return torch.where((d2 < thr2) & z_mask[None, :], prof, prof.new_full((), NEG)), d2

    @record_function("graph.assoc")
    def associate(da: DAState, gstate, pred, z, z_mask, stats):
        """FindLabels (ISAM2Navigator.cs:256-441) as fixed-shape tensor ops.
        Returns (labels [M], updated DAState minus pl_cov, new_any)."""
        lms = gstate.landmarks
        lm_mask = gstate.lm_mask
        cand_alive = da.cand_count > 0
        pred_b = pred[None, :]

        mu_l = model.measure(model.params, pred_b, lms)  # [L, D]
        vis = visible(model.params, mu_l) & lm_mask
        backproj = model.to_map(model.params, pred_b, z)  # [M, 3]
        mu_c = model.measure(model.params, pred_b, da.cand_mean)

        neg = z.new_full((), NEG)
        prof_l, d2_l = profit_rows(mu_l, da.pl_cov, z, z_mask)
        prof_l = torch.where(vis[:, None], prof_l, neg)
        prof_c, _ = profit_rows(mu_c, meas_cov.expand((c,) + meas_cov.shape), z, z_mask)
        prof_c = torch.where(cand_alive[:, None], prof_c, neg)
        d2_l = torch.where(
            lm_mask[:, None] & z_mask[None, :], d2_l, d2_l.new_full((), float("inf"))
        )

        # square profit matrix: rows = L sources + C candidates + M clutter,
        # cols = M measurements + (L + C) miss slots. Dead/invisible source
        # rows keep their miss column (log_pd vs NEG elsewhere), forcing the
        # same optimum trade-offs as the reference's visible-compacted
        # matrix (ISAM2Navigator.cs:293-365).
        profit = torch.full((s, s), NEG, dtype=dtype, device=dev)
        profit[:l_cap, :m] = prof_l
        profit[l_cap:n, :m] = prof_c
        profit[rows_n, m + rows_n] = log_pd
        # An INVALID measurement slot's clutter row gets its own column at
        # +1 (strictly above the 0 miss block) instead of NEG: that column
        # has no other finite row, so the pair is forced in any optimal
        # matching anyway, and without it the row has no acceptable seat: it
        # then fights the miss block across the ~1e4 NEG gap in eps-sized
        # bid increments, and EVERY auction phase burns the full max_iters
        # cap. The constant on a forced edge does not change the optimum
        # over the real (landmark/candidate/clutter) trade-offs.
        profit[n + rows_m, rows_m] = torch.where(
            z_mask, z.new_full((), log_clutter), z.new_full((), 1.0)
        )
        profit[n:, m:] = 0.0

        col = assignment.auction_assign(profit, eps=eps, stats=stats)

        # invert: owner row of each measurement column (-1 = none); assigned
        # columns are distinct
        owner = _put(s, torch.where(col >= 0, col, s), rows_s, -1, torch.int64, dev)
        z_owner = owner[:m]  # [M]
        own_valid = (z_owner >= 0) & z_mask
        # profit sanity: an assignment into a NEG cell is a miss in disguise
        own_prof = profit[torch.clamp(z_owner, 0, s - 1), rows_m]
        own_valid &= own_prof > NEG / 2

        # [M] >= 0 where a proven landmark matched
        lm_label = torch.where(own_valid & (z_owner < l_cap), z_owner, -1)
        # [M] candidate index or -1
        cand_of_z = torch.where(
            own_valid & (z_owner >= l_cap) & (z_owner < n), z_owner - l_cap, -1
        )
        matched_lm = _put(
            l_cap, torch.where(lm_label >= 0, lm_label, l_cap), True, False, torch.bool, dev
        )

        # penumbra cover (see slam/isam2nav.py find_labels): a measurement
        # gated (cover radius) by a proven landmark that went UNMATCHED this
        # frame is a shadow of that landmark, not a birth. The map-space
        # radius complements the projected metric.
        cover_rows = lm_mask & ~matched_lm  # [L]
        dmap2 = sum((backproj[None, :, i] - lms[:, None, i]) ** 2 for i in range(3))  # [L, M]
        gate = ((d2_l < cover_thr2) | (dmap2 < map_cover_radius**2)) & cover_rows[:, None]
        has_cover = gate.any(dim=0)  # [M]

        # candidate lifecycle
        z_of_cand = _put(c, torch.where(cand_of_z >= 0, cand_of_z, c), rows_m, -1, torch.int64, dev)
        cand_matched = z_of_cand >= 0
        zc = torch.clamp(z_of_cand, 0, m - 1)
        w = da.cand_count.to(dtype)
        upd_mean = (da.cand_mean * w[:, None] + backproj[zc]) / (w + 1.0)[:, None]
        new_count = da.cand_count + 1
        promote = cand_matched & (new_count >= promote_at)
        blocked = promote & has_cover[zc]
        promote_ok = promote & ~blocked

        # allocate labels for promotions in slot order
        rank = torch.cumsum(promote_ok.to(torch.int64), 0) - 1
        new_label = da.next_label + rank
        can_fit = promote_ok & (new_label < l_cap)
        n_new = int(promote_ok.sum())  # a read from the device
        if stats is not None:
            stats["reads"] += 1

        # measurement labels: landmark match, promotion label, else CLUTTER
        labels = torch.where(lm_label >= 0, lm_label, CLUTTER)
        ext = torch.cat([labels, labels.new_zeros((1,))])
        ext[torch.where(can_fit, zc, m)] = torch.where(can_fit, new_label, CLUTTER)
        labels = ext[:m]

        # surviving candidates: matched, below threshold (promoted and
        # cover-blocked ones are culled; unmatched are culled)
        keep = cand_matched & ~promote
        cand_mean = torch.where(keep[:, None], upd_mean, torch.zeros_like(upd_mean))
        cand_count = torch.where(keep, new_count, 0)

        # seed new candidates from unmatched, uncovered measurements: the
        # k-th seeding measurement takes the k-th free slot
        seed_z = (labels == CLUTTER) & z_mask & ~has_cover
        free = cand_count == 0
        free_rank = torch.cumsum(free.to(torch.int64), 0) - 1  # [C]
        seed_rank = torch.cumsum(seed_z.to(torch.int64), 0) - 1  # [M]
        slot_of_rank = _put(c, torch.where(free, free_rank, c), slots_c, c, torch.int64, dev)
        seat = seed_z & (seed_rank < free.sum())
        slot = slot_of_rank[torch.clamp(seed_rank, 0, c - 1)]  # [M]
        tgt = torch.where(seat, slot, c)
        cand_mean = torch.cat([cand_mean, cand_mean.new_zeros((1, 3))])
        cand_mean[tgt] = backproj
        cand_count = torch.cat([cand_count, cand_count.new_zeros((1,))])
        cand_count[tgt] = 1

        da = DAState(
            pl_cov=da.pl_cov, cand_mean=cand_mean[:c], cand_count=cand_count[:c],
            next_label=da.next_label + n_new,
        )
        return labels, da, n_new > 0

    def runner(carry: ScanDACarry, commands, draws, stats=None):
        vstate, st, da, est, frame = clone_carry(carry)
        nframes = commands.shape[0]
        true_poses = torch.zeros((nframes, st.poses.shape[1]), dtype=dtype, device=dev)
        est_poses = torch.zeros_like(true_poses)
        n_landmarks = torch.zeros((nframes,), dtype=torch.int64, device=dev)
        for i in range(nframes):
            vstate, noisy, z, z_mask, _ = vehicle_frame(
                model, vparams, vstate, commands[i], draws, i, max_clutter
            )
            t = st.n_poses
            pred = model.pose.add_odometry(est, noisy)
            labels, da, new_any = associate(da, st, pred, z, z_mask, stats)

            upd = z_mask & (labels >= 0) & (labels < l_cap)
            st = append_frame(model, st, m, pred, noisy, z, upd, labels)
            layout = graph.factor_layout(gcfg, st)
            st = graph.gauss_newton(model, gcfg, st, motion_info, meas_info, layout)
            if new_any:
                # new-landmark frames relinearize once more (the host
                # navigator's full re-solve, isam2nav.slam_update)
                st = graph.gauss_newton(model, gcfg, st, motion_info, meas_info, layout)
            # amortized gate-covariance refresh (isam2.cpp:258-312;
            # marginals_every cadence + every new-landmark frame)
            if new_any or frame % marginals_every == 0:
                da = da._replace(
                    pl_cov=graph.marginals(
                        model, gcfg, st, motion_info, meas_info, meas_cov, layout
                    )[1]
                )
            est = st.poses[t]
            frame += 1
            true_poses[i] = vstate.pose
            est_poses[i] = est
            n_landmarks[i] = st.lm_mask.sum()
        return ScanDACarry(vstate, st, da, est, frame), (true_poses, est_poses, n_landmarks)

    da0 = DAState(
        pl_cov=meas_cov[None].repeat(l_cap, 1, 1),
        cand_mean=torch.zeros((cand_cap, 3), dtype=dtype, device=dev),
        cand_count=torch.zeros((cand_cap,), dtype=torch.int64, device=dev),
        next_label=0,
    )
    init = ScanDACarry(vstate, gstate, da0, vstate.pose.clone(), 0)
    return runner, init, model
