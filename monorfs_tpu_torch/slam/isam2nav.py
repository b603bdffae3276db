"""Graph-SLAM navigator: Mahalanobis data association + batch GN backend
(the torch twin of monorfs_tpu.slam.isam2nav).

Follows the reference's ISAM2Navigator
(mono-rfs-lib/SLAM/Navigators/ISAM2Navigator.cs:47-632). The association
frontend reproduces FindLabels (:256-441): visible landmarks and candidates
build a gated log-profit matrix (Mahalanobis distances measured in the
J Sigma J^T + R projected covariance for proven landmarks, R for
candidates), solved by Hungarian assignment; candidates promote to real
landmarks after NewLandmarkThreshold consecutive sightings and are culled
when unseen. The backend is the batched Gauss-Newton Schur solver in
graph.py instead of the gtsam Bayes tree.

Layout:

  * the association quantities (visibility, gated log-profit rows for all
    landmarks and candidates, measurement back-projections) are one device
    computation per frame; only the small Hungarian assignment and the
    candidate lifecycle run on the host (the reference's own split);
  * the factor arrays live in host numpy mirrors, uploaded in bulk per
    solve;
  * solves are shape-bucketed: the dense normal equations are sized to the
    next power of two of the ACTIVE pose/factor/landmark counts, so early
    frames don't pay the full-capacity Cholesky;
  * steady-state frames run 1 warm-started GN iteration (the previous
    estimate is the linearization point, the analogue of reusing the Bayes
    tree, isam2.cpp:245); every `full_solve_every` frames (and whenever a
    bucket grows) a full gn_iters re-solve relinearizes everything.
    Marginal covariances are refreshed on full solves and (for the
    Mahalanobis gate, isam2.cpp:258-312) every `marginals_every` frames.

Everything the navigator computes on tensors (association, solve,
marginals) runs on `device` in `solve_dtype`, float64 by default: the
reference's FindLabels and gtsam run in doubles, and a float32 solve of the
~1800-dim reduced pose system degraded the landmark estimates enough to mint
duplicate landmarks (the chap4-cluttery configuration mapped 150 landmarks
in float32 against 43 in float64). Each transfer to the device counts into
`uploads`, each read back into `reads`.
"""

import dataclasses
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..metrics.errors import hungarian
from . import graph

CLUTTER = -9999
NEG = -1e20


def _pow2_at_least(n, lo, hi):
    c = lo
    while c < n:
        c *= 2
    return min(c, hi)


class ISAM2Navigator:
    def __init__(self, model, cfg, init_pose, max_poses=512, max_landmarks=256,
                 meas_per_frame=24, onlymapping=False, dtype=np.float64, da_algorithm=None,
                 full_solve_every=8, cand_cap=128, marginals_every=4, merge_threshold=0.0,
                 cover_threshold=None, solve_dtype=torch.float64, dup_merge_radius=0.0,
                 dup_min_obs=6, dup_coobs_frac=0.15, map_cover_radius=0.0, device="cuda"):
        """`dtype` (the simulation's) is accepted for API compatibility; the
        navigator works in `solve_dtype` throughout (see the module note)."""
        graph.assert_full_precision()
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.solve_dtype = solve_dtype
        self.dtype = np.float64 if solve_dtype == torch.float64 else np.float32
        self.onlymapping = onlymapping
        self.da_algorithm = da_algorithm or cfg.da_algorithm
        self.match_threshold = cfg.match_threshold
        self.cover_threshold = cover_threshold or 3.5 * cfg.match_threshold
        self.merge_threshold = merge_threshold
        self.new_landmark_threshold = cfg.new_landmark_threshold
        self.pd = cfg.detection_probability
        self.clutter_density = max(cfg.navigator_clutter_density, 1e-30)
        self.full_solve_every = full_solve_every
        self.marginals_every = marginals_every

        self.max_poses = max_poses
        self.max_landmarks = max_landmarks
        self.max_factors = max_poses * meas_per_frame
        self.meas_per_frame = meas_per_frame
        self.cand_cap = cand_cap

        o = model.pose.odo_dim
        d = model.meas_dim
        self.meas_dim = d

        # host mirrors of the graph (bulk-uploaded per solve)
        dtype = self.dtype
        self.poses_np = np.tile(np.asarray(init_pose, dtype), (max_poses, 1))
        self.n_poses = 1
        self.landmarks_np = np.zeros((max_landmarks, 3), dtype)
        self.lm_mask_np = np.zeros(max_landmarks, bool)
        self.between_np = np.zeros((max_poses, o), dtype)
        self.between_mask_np = np.zeros(max_poses, bool)
        self.pose_fixed_np = np.zeros(max_poses, bool)
        self.pose_fixed_np[0] = True
        self.f_pose_np = np.zeros(self.max_factors, np.int64)
        self.f_lm_np = np.zeros(self.max_factors, np.int64)
        self.f_z_np = np.zeros((self.max_factors, d), dtype)
        self.f_mask_np = np.zeros(self.max_factors, bool)
        self.n_factors = 0
        self._pose_factors_max = 1  # most factors any one pose holds

        self.uploads = 0  # host -> device transfers
        self.reads = 0  # device -> host reads (each waits for the device)

        # diagonal noise like the reference bridge (ISAM2Navigator.cs:140-150)
        dt = cfg.measure_elapsed
        motion_sigma = dt * np.sqrt(np.diag(cfg.motion_covariance))
        meas_sigma = np.sqrt(np.diag(cfg.measurement_covariance))
        self.motion_info = self._up(np.diag(1.0 / motion_sigma**2))
        self.meas_info = self._up(np.diag(1.0 / meas_sigma**2))
        self.meas_cov_np = np.diag(meas_sigma**2).astype(dtype)
        self.meas_cov = self._up(self.meas_cov_np)

        # co-observation duplicate merge: OFF by default. Duplicate labels of
        # one physical landmark are never matched in the same frame, true
        # close pairs are co-detected at PD^2; sound only under reliable
        # association (on the noisy configuration, label flipping between
        # true neighbours makes the merge fuse TRUE pairs).
        self.dup_merge_radius = dup_merge_radius
        # map-space cover: OFF by default. A measurement whose
        # back-projection is within map_cover_radius of an UNMATCHED proven
        # landmark cannot seed or promote a candidate. An opt-in for sparse
        # worlds (spacing >> radius); in the 0.17 m-median-spacing 3D world it
        # suppresses true landmarks faster than duplicates.
        self.map_cover_radius = map_cover_radius
        self.dup_min_obs = dup_min_obs
        self.dup_coobs_frac = dup_coobs_frac
        self.obs_count = np.zeros(max_landmarks, np.int64)
        self.coobs = np.zeros((max_landmarks, max_landmarks), np.int32)

        self._last_full_solve = -1
        self._last_marginals = -10**9
        self._last_bucket = None
        self._perfect_map = {}
        self.debug_promotions = None  # set to [] to record promotion events

        self.pose = np.asarray(init_pose, dtype)
        self.lm_cov = np.zeros((max_landmarks, 3, 3))
        self.pl_cov = np.tile(self.meas_cov_np, (max_landmarks, 1, 1))
        self.next_label = 0
        self.cand_mean: List[np.ndarray] = []
        self.cand_count: List[int] = []

    # ------------------------------------------------------------------

    def _up(self, x, dtype=None):
        """numpy -> device tensor (floats in solve_dtype); always a copy, so
        that on the CPU no tensor aliases a host mirror."""
        self.uploads += 1
        x = np.asarray(x)
        if dtype is None and x.dtype.kind == "f":
            dtype = self.solve_dtype
        return torch.tensor(x, dtype=dtype, device=self.device)

    def _down(self, x):
        """device tensor -> numpy."""
        self.reads += 1
        return x.detach().cpu().numpy()

    def predict(self, odometry, true_pose=None):
        """Odometry dead-reckoning of the current estimate
        (ISAM2Navigator.cs:174-183)."""
        if self.onlymapping and true_pose is not None:
            self.pose = np.asarray(true_pose, self.dtype)
        else:
            self.pose = self._down(
                self.model.pose.add_odometry(self._up(self.pose), self._up(odometry))
            )

    # ------------------------------------------------------------------

    def _profit_rows(self, means, covs, targets, t_mask):
        """Gated log-profit of N (mean, cov) sources vs M targets, and the
        raw squared Mahalanobis distances (ungated)."""
        d = self.meas_dim
        thr2 = float(self.match_threshold) ** 2
        ci = torch.linalg.inv(covs)
        _, logdet = torch.linalg.slogdet(covs)
        logmult = -0.5 * (d * np.log(2 * np.pi) + logdet)  # [N]
        diff = targets[None, :, :] - means[:, None, :]  # [N, M, D]
        d2 = torch.einsum("nmd,nde,nme->nm", diff, ci, diff)
        prof = np.log(self.pd) + logmult[:, None] - 0.5 * d2
        neg = torch.full((), NEG, dtype=d2.dtype, device=d2.device)
        return torch.where((d2 < thr2) & t_mask[None, :], prof, neg), d2

    def _assoc(self, pose, lms, lm_mask, pl_cov, cand, cand_mask, z, z_mask):
        """Every per-frame association quantity in one device computation:
        landmark visibility (frustum), gated log-profit rows vs all
        measurements for landmarks and candidates, and the measurement
        back-projections."""
        model = self.model
        pose_b = pose[None, :]
        mu_l = model.measure(model.params, pose_b, lms)  # [L, D]
        vis = model.visible_fn()(model.params, mu_l) & lm_mask
        backproj = model.to_map(model.params, pose_b, z)  # [M, 3]
        if self.da_algorithm == "Mahalanobis":
            mu_c = model.measure(model.params, pose_b, cand)  # [C, D]
            r = self.meas_cov
            prof_l, d2_l = self._profit_rows(mu_l, pl_cov, z, z_mask)
            prof_c, _ = self._profit_rows(mu_c, r.expand((cand.shape[0],) + r.shape), z, z_mask)
        else:  # NN: distances in map space, tiny fixed covariance
            nn_cov = 0.001 * torch.eye(3, dtype=lms.dtype, device=lms.device)
            prof_l, d2_l = self._profit_rows(
                lms, nn_cov.expand(lms.shape[0], 3, 3), backproj, z_mask
            )
            prof_c, _ = self._profit_rows(
                cand, nn_cov.expand(cand.shape[0], 3, 3), backproj, z_mask
            )
        neg = torch.full((), NEG, dtype=prof_l.dtype, device=prof_l.device)
        inf = torch.full((), float("inf"), dtype=prof_l.dtype, device=prof_l.device)
        prof_l = torch.where(vis[:, None], prof_l, neg)
        prof_c = torch.where(cand_mask[:, None], prof_c, neg)
        d2_l = torch.where(lm_mask[:, None] & z_mask[None, :], d2_l, inf)
        return vis, prof_l, prof_c, backproj, d2_l

    def find_labels(self, measurements, true_labels=None):
        """FindLabels (ISAM2Navigator.cs:256-441). Returns one label per
        measurement: >=0 real landmark, <0 candidate, CLUTTER unmatched."""
        if self.da_algorithm == "Perfect":
            if true_labels is None:
                raise RuntimeError("Tried to use perfect data association when none exists.")
            return [lab if lab >= 0 else CLUTTER for lab in true_labels]

        m = len(measurements)
        d = self.meas_dim
        z = np.zeros((self.meas_per_frame, d), self.dtype)
        z_mask = np.zeros(self.meas_per_frame, bool)
        for k, zi in enumerate(measurements[: self.meas_per_frame]):
            z[k] = np.asarray(zi)[:d]
            z_mask[k] = True

        nc = len(self.cand_mean)
        cand = np.zeros((self.cand_cap, 3), self.dtype)
        cand_mask = np.zeros(self.cand_cap, bool)
        for k, c in enumerate(self.cand_mean[: self.cand_cap]):
            cand[k] = c
            cand_mask[k] = True

        with record_function("graph.assoc"):
            out = self._assoc(
                self._up(self.pose), self._up(self.landmarks_np), self._up(self.lm_mask_np),
                self._up(self.pl_cov), self._up(cand), self._up(cand_mask), self._up(z),
                self._up(z_mask),
            )
            vis, prof_l, prof_c, self._backproj, d2_l = (self._down(x) for x in out)

        visible_idx = np.flatnonzero(vis)
        nv = len(visible_idx)
        n = nv + nc
        log_pd = np.log(self.pd)
        log_clutter = np.log(self.clutter_density)

        size = n + m
        profit = np.full((size, size), NEG)
        if nv:
            profit[:nv, :m] = prof_l[visible_idx][:, :m]
        if nc:
            profit[nv:n, :m] = prof_c[:nc, :m]
        profit[np.arange(n), m + np.arange(n)] = log_pd
        profit[n + np.arange(m), np.arange(m)] = log_clutter
        profit[n:, m:] = 0.0  # misdetection x clutter quadrant

        with record_function("graph.hungarian"):
            assignment = hungarian(-profit)

        labels = [CLUTTER] * m
        keep = [False] * nc
        # The cover test: a measurement is "covered" (treated as the shadow
        # of a proven landmark, not a birth) when some live landmark is gated
        # for it (pl_cov metric) AND that landmark went UNMATCHED in this
        # frame's assignment. That is the signature of the steal cycle: a
        # tight-R candidate out-bids the landmark's wider J Sigma J^T + R
        # profit, leaving the landmark missed while its own measurement feeds
        # a duplicate candidate. Requiring "unmatched" keeps legitimate
        # births alive while the pose is uncertain. The cover gate is WIDER
        # than the match gate: duplicate births cluster just outside the
        # match gate, where the amortized marginals' staleness underestimates
        # the innovation covariance. A covered measurement gives no birth,
        # but is NOT force-matched.
        thr2_f = float(self.cover_threshold) ** 2
        matched_lms = {int(visible_idx[i]) for i in range(nv) if assignment[i] < m}
        # cover rows: proven landmarks that could explain a measurement but
        # did not claim one in this frame's assignment: visible + unmatched
        # (the steal cycle), or INVISIBLE under the frustum test on the
        # estimated geometry (a landmark at the frustum edge flickers out of
        # the visible set while its physical detection is still in Z).
        # Visible landmarks matched to ANOTHER measurement do NOT cover: two
        # nearby true landmarks must both stay mappable.
        cover_rows = [
            j for j in np.flatnonzero(self.lm_mask_np[: d2_l.shape[0]]) if j not in matched_lms
        ]
        if cover_rows:
            gate_rows = d2_l[cover_rows][:, :m] < thr2_f
            dmap = np.linalg.norm(
                self._backproj[None, :m, :] - self.landmarks_np[cover_rows][:, None, :], axis=-1
            )
            has_cover = (gate_rows | (dmap < self.map_cover_radius)).any(axis=0)
        else:
            has_cover = np.zeros(m, bool)
        for i in range(nv):
            if assignment[i] < m:
                labels[assignment[i]] = int(visible_idx[i])
        for i in range(nv, n):
            if assignment[i] < m:
                k = i - nv
                zi = assignment[i]
                labels[zi] = -k - 1
                w = self.cand_count[k]
                self.cand_mean[k] = (self.cand_mean[k] * w + self._backproj[zi]) / (w + 1)
                self.cand_count[k] = w + 1
                if self.cand_count[k] >= self.new_landmark_threshold:
                    if has_cover[zi]:
                        # promotion would duplicate a proven landmark: cull
                        # the candidate without promoting
                        labels[zi] = CLUTTER
                    else:
                        self._debug_promotion(zi, d2_l, vis, matched_lms)
                        labels[zi] = self.next_label
                        self.next_label += 1
                else:
                    keep[k] = True
        for i in range(m):
            if labels[i] == CLUTTER:
                if has_cover[i]:
                    continue  # shadowed by a proven landmark: not a birth
                if self.new_landmark_threshold <= 1:
                    labels[i] = self.next_label
                    self.next_label += 1
                elif len(self.cand_mean) < self.cand_cap:
                    self.cand_mean.append(self._backproj[i].copy())
                    self.cand_count.append(1)
                    keep.append(True)
        self.cand_mean = [c for c, k in zip(self.cand_mean, keep) if k]
        self.cand_count = [c for c, k in zip(self.cand_count, keep) if k]
        return labels

    def _debug_promotion(self, zi, d2_l, vis, matched_lms):
        """Record a promotion event for diagnosis; enabled by setting
        `self.debug_promotions = []`."""
        events = self.debug_promotions
        if events is None:
            return
        live = np.flatnonzero(self.lm_mask_np)
        info = {"z": int(zi), "label": int(self.next_label)}
        if len(live):
            dists = np.linalg.norm(self.landmarks_np[live] - self._backproj[zi], axis=1)
            jn = int(live[np.argmin(dists)])
            info.update(
                nearest=jn, dist=float(dists.min()), nearest_visible=bool(vis[jn]),
                nearest_matched=jn in matched_lms, nearest_d2=float(d2_l[jn, zi]),
            )
        events.append(info)

    # ------------------------------------------------------------------

    def _bucket_state(self):
        """Slice the host mirrors to power-of-two active capacities and
        upload them as a GraphState, with its bucket GraphConfig."""
        t_cap = _pow2_at_least(self.n_poses + 1, 8, self.max_poses)
        f_cap = _pow2_at_least(self.n_factors + 1, 32, self.max_factors)
        l_cap = _pow2_at_least(max(self.next_label, 1), 8, self.max_landmarks)
        cfg = graph.GraphConfig(
            max_poses=t_cap, max_landmarks=l_cap, max_factors=f_cap,
            factors_per_pose=-(-self._pose_factors_max // 8) * 8,
        )
        st = graph.GraphState(
            poses=self._up(self.poses_np[:t_cap]),
            n_poses=self.n_poses,
            landmarks=self._up(self.landmarks_np[:l_cap]),
            lm_mask=self._up(self.lm_mask_np[:l_cap]),
            between=self._up(self.between_np[:t_cap]),
            between_mask=self._up(self.between_mask_np[:t_cap]),
            pose_fixed=self._up(self.pose_fixed_np[:t_cap]),
            f_pose=self._up(self.f_pose_np[:f_cap]),
            f_lm=self._up(self.f_lm_np[:f_cap]),
            f_z=self._up(self.f_z_np[:f_cap]),
            f_mask=self._up(self.f_mask_np[:f_cap]),
        )
        return cfg, st, (t_cap, f_cap, l_cap)

    def _solve(self, cfg, st, key, iters, t):
        """Gauss-Newton on the bucket and the estimates read back into the
        mirrors."""
        st = graph.gauss_newton(
            self.model, dataclasses.replace(cfg, gn_iters=iters), st, self.motion_info,
            self.meas_info,
        )
        t_cap, _, l_cap = key
        self.poses_np[:t_cap] = self._down(st.poses)
        self.landmarks_np[:l_cap] = self._down(st.landmarks)
        self.pose = self.poses_np[t].copy()
        return st

    def _refresh_marginals(self, cfg, st, key):
        lm_cov, pl_cov = graph.marginals(
            self.model, cfg, st, self.motion_info, self.meas_info, self.meas_cov
        )
        l_cap = key[2]
        self.lm_cov[:l_cap] = self._down(lm_cov)
        self.pl_cov[:l_cap] = self._down(pl_cov)

    def slam_update(self, measurements, true_labels=None):
        """Add the frame's factors and re-solve (ISAM2Navigator.cs:192-248).

        For perfect association the true labels must map to internal ids;
        clutter (negative true labels) is dropped."""
        if self.da_algorithm == "Perfect":
            labels = []
            for lab in self.find_labels(measurements, true_labels):
                if lab == CLUTTER:
                    labels.append(CLUTTER)
                    continue
                if lab not in self._perfect_map:
                    self._perfect_map[lab] = self.next_label
                    self.next_label += 1
                labels.append(self._perfect_map[lab])
        else:
            labels = self.find_labels(measurements)

        t = self.n_poses
        if t >= self.max_poses:
            raise RuntimeError("graph pose capacity exceeded")

        pose_dev = self._up(self.pose)
        delta = self._down(
            self.model.pose.diff_odometry(pose_dev, self._up(self.poses_np[t - 1]))
        )
        self.poses_np[t] = self.pose
        self.between_np[t] = delta
        self.between_mask_np[t] = True
        if self.onlymapping:
            self.pose_fixed_np[t] = True

        new_landmark = False
        added = 0
        for z, lab in zip(measurements, labels):
            if lab < 0:
                continue
            if lab >= self.max_landmarks:
                # capacity reached: drop the factor (the reference would
                # abort on gtsam failure; a bounded map is the contract
                # here: size max_landmarks to the scene)
                continue
            if not self.lm_mask_np[lab]:
                self.landmarks_np[lab] = self._down(
                    self.model.to_map(
                        self.model.params, pose_dev, self._up(np.asarray(z)[: self.meas_dim])
                    )
                )
                self.lm_mask_np[lab] = True
                new_landmark = True
            fi = self.n_factors
            if fi >= self.max_factors:
                continue  # factor budget exhausted; drop extra observations
            self.f_pose_np[fi] = t
            self.f_lm_np[fi] = lab
            self.f_z_np[fi] = np.asarray(z)[: self.meas_dim]
            self.f_mask_np[fi] = True
            self.n_factors += 1
            added += 1
        self._pose_factors_max = max(self._pose_factors_max, added)

        self.n_poses = t + 1
        cfg, st, key = self._bucket_state()

        full = (
            new_landmark
            or t - self._last_full_solve >= self.full_solve_every
            or self._last_bucket != key
        )
        self._last_bucket = key
        if full:
            self._last_full_solve = t
        st = self._solve(cfg, st, key, cfg.gn_iters if full else 1, t)

        # observation statistics for the co-observation duplicate merge
        seen = sorted({lab for lab in labels if 0 <= lab < self.max_landmarks})
        if seen:
            self.obs_count[seen] += 1
            ix = np.asarray(seen)
            self.coobs[np.ix_(ix, ix)] += 1

        # marginals: refreshed on relinearization frames and (for the
        # Mahalanobis gate) every `marginals_every` frames. The gate
        # covariances J Sigma J^T + R evolve slowly between landmark-set
        # changes, and any new landmark forces full=True above, so a
        # just-promoted landmark never sees a stale row. The marginals pass
        # is a [T*O, L*3] multi-RHS solve per call; amortizing it stands in
        # for gtsam's incremental Bayes-tree marginals.
        if full or (
            self.da_algorithm == "Mahalanobis"
            and t - self._last_marginals >= self.marginals_every
        ):
            self._refresh_marginals(cfg, st, key)
            self._last_marginals = t
            if self._merge_duplicates():
                # relabeled factors: re-solve and refresh the gate state
                cfg, st, key = self._bucket_state()
                st = self._solve(cfg, st, key, cfg.gn_iters, t)
                self._refresh_marginals(cfg, st, key)
        return labels

    def _merge_duplicates(self):
        """Merge duplicate proven landmarks (two labels, one physical
        point): the later label's factors are relabeled to the earlier one
        and its observation statistics are folded in. Both criteria are OFF
        by default; the find_labels cover discipline suppresses duplication
        at the source. The reference has no equivalent cleanup: its
        candidate culling (ISAM2Navigator.cs:425-436) is the only
        discipline."""
        merged = False
        idx = np.flatnonzero(self.lm_mask_np)
        if len(idx) < 2:
            return False

        # (1) co-observation criterion (dup_merge_radius > 0): two labels of
        # the SAME physical landmark split its one detection per frame
        # between them, so they are (almost) never matched in the same
        # frame; two genuinely close landmarks are co-detected in most
        # co-visible frames. A close pair seen often but (almost) never
        # together is a duplicate: merge the later label into the earlier.
        if self.dup_merge_radius > 0:
            for a in range(len(idx)):
                ia = idx[a]
                if not self.lm_mask_np[ia]:
                    continue
                for b in range(a + 1, len(idx)):
                    ib = idx[b]
                    if not self.lm_mask_np[ib]:
                        continue
                    dist = float(np.linalg.norm(self.landmarks_np[ia] - self.landmarks_np[ib]))
                    if dist >= self.dup_merge_radius:
                        continue
                    o = min(self.obs_count[ia], self.obs_count[ib])
                    if o < self.dup_min_obs:
                        continue
                    if self.coobs[ia, ib] > self.dup_coobs_frac * o:
                        continue
                    self._merge_pair(ia, ib)
                    merged = True

        # (2) Mahalanobis criterion in the summed GLOBAL-frame marginals
        # (merge_threshold > 0): under a weak motion prior the accumulated
        # pose uncertainty dominates these covariances and physically
        # distinct landmarks merge; kept for explicitly-configured use.
        if self.merge_threshold > 0:
            thr2 = float(self.merge_threshold) ** 2
            for a in range(len(idx)):
                ia = idx[a]
                if not self.lm_mask_np[ia]:
                    continue
                for b in range(a + 1, len(idx)):
                    ib = idx[b]
                    if not self.lm_mask_np[ib]:
                        continue
                    diff = self.landmarks_np[ia] - self.landmarks_np[ib]
                    c = self.lm_cov[ia] + self.lm_cov[ib]
                    try:
                        m2 = float(diff @ np.linalg.solve(c, diff))
                    except np.linalg.LinAlgError:
                        continue
                    if 0 <= m2 < thr2:
                        self._merge_pair(ia, ib)
                        merged = True
        return merged

    def _merge_pair(self, ia, ib):
        """Relabel ib's factors to ia and fold its observation statistics."""
        sel = self.f_mask_np & (self.f_lm_np == ib)
        self.f_lm_np[sel] = ia
        self.lm_mask_np[ib] = False
        self.obs_count[ia] += self.obs_count[ib]
        self.obs_count[ib] = 0
        self.coobs[ia, :] += self.coobs[ib, :]
        self.coobs[:, ia] += self.coobs[:, ib]
        self.coobs[ib, :] = 0
        self.coobs[:, ib] = 0

    # ------------------------------------------------------------------

    @property
    def state(self):
        """Full-capacity GraphState on the device (for direct inspection)."""
        return graph.GraphState(
            poses=self._up(self.poses_np), n_poses=self.n_poses,
            landmarks=self._up(self.landmarks_np), lm_mask=self._up(self.lm_mask_np),
            between=self._up(self.between_np), between_mask=self._up(self.between_mask_np),
            pose_fixed=self._up(self.pose_fixed_np), f_pose=self._up(self.f_pose_np),
            f_lm=self._up(self.f_lm_np), f_z=self._up(self.f_z_np),
            f_mask=self._up(self.f_mask_np),
        )

    @property
    def trajectory(self):
        return self.poses_np[: self.n_poses].copy()

    @property
    def map_estimate(self):
        mask = self.lm_mask_np
        return self.landmarks_np[mask].copy(), self.lm_cov[mask]
