"""Host-side navigator of the Loopy-PHD smoother (LoopyPHDNavigator.cs:223-311):
the torch twin of monorfs_tpu.slam.loopynav.

Built from an initial trajectory estimate (an inner PHD / odometry run or a
recorded estimate) plus the odometry and measurement logs, then iterated:
the first sweeps are the sequential refit (forward, then one reversed pass),
later ones Jacobi BP sweeps, cold after a refit and with the map messages
frozen after `freeze_map_after` sweeps. The joint trajectory objective is
read after every sweep (two host reads) and the best state kept."""

import numpy as np
import torch

from .. import resolve_device
from ..gm import mixture
from . import loopy


class LoopyPHDNavigator:
    def __init__(self, model, cfg, trajectory, odometry, measurements, max_meas=16,
                 dtype=torch.float64, loopy_cfg=None, link_cov=None, anneal_t0=None,
                 device="cuda"):
        """trajectory: [T, S] initial estimate; odometry: list of readings
        (odometry[t] produced pose t from pose t-1); measurements: list of
        per-frame measurement lists."""
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        t = len(trajectory)
        self.n_nodes = t
        self.lcfg = loopy_cfg or loopy.LoopyConfig(max_nodes=t, max_meas=max_meas)
        d, cap = model.meas_dim, self.lcfg.max_nodes

        # node-to-node odometry: link j -> j+1 is the reading that produced
        # frame j+1 (the reference's Odometry[i-1], :440)
        odo = np.zeros((cap, model.pose.odo_dim))
        for j in range(t - 1):
            odo[j] = odometry[j + 1]
        z = np.zeros((cap, max_meas, d))
        zm = np.zeros((cap, max_meas), bool)
        for i, zs in enumerate(measurements[:t]):
            for k, zi in enumerate(list(zs)[:max_meas]):
                z[i, k] = np.asarray(zi)[:d]
                zm[i, k] = True
        traj = np.zeros((cap, model.pose.state_dim))
        traj[:t] = np.asarray(trajectory)
        traj[t:] = np.asarray(trajectory)[-1]
        self.odometry = self._tensor(odo)
        self.z = self._tensor(z)
        self.z_mask = torch.as_tensor(zm, device=dev)
        self.state = loopy.init_state(model, self.lcfg, traj, t, dtype, dev)

        self.params = cfg.phd_params(dtype, dev)
        # chain-link noise: the vehicle draws odometry noise as dt * N(0, Q)
        # (Vehicle.cs:330-333), so the chain uses dt^2 Q (the reference adds
        # the raw Q per link, LoopyPHDNavigator.cs:447; see the JAX twin)
        dt = cfg.measure_elapsed
        if link_cov is None:
            link_cov = dt * dt * np.asarray(cfg.motion_covariance)
        self.motion_cov = self._tensor(link_cov)
        self.grad_clip = self._tensor(cfg.gradient_clip)
        self.grad_rate = self._tensor(cfg.gradient_ascent_rate)
        self._sweep = loopy.make_sweep(model, self.lcfg)
        self._sweep_causal = loopy.make_sweep(model, self.lcfg, causal=True)
        self._sweep_frozen = loopy.make_sweep(model, self.lcfg, freeze_map=True)
        self._refit = loopy.make_sequential_refit(model, self.lcfg) if self.lcfg.refit else None
        self._refit_back = self._reversed_refit if self._refit and self.lcfg.refit_backward else None
        self.sweeps = 0
        # annealing start temperature of the BP sweeps: cold after a refit,
        # the reference's 5 / (sweep + 1) otherwise (:369-370)
        if anneal_t0 is None:
            anneal_t0 = 0.0 if self.lcfg.refit else 5.0
        self.anneal_t0 = float(anneal_t0)
        self.best_state = None
        self.best_objective = -np.inf
        # the measurement term's argmax, a diagnostic (see the JAX twin)
        self.best_map_state = None
        self.best_map_objective = -np.inf

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype, device=self.device)

    def _reversed_refit(self, params, lp, node_mask, odometry, z, z_mask, motion_cov, grad_clip,
                        grad_rate):
        """The refit over the time-reversed nodes (loopy.reverse_refit_inputs)."""
        lp_r, odo_r, z_r, zm_r = loopy.reverse_refit_inputs(lp, odometry, z, z_mask)
        traj_r = self._refit(params, lp_r, node_mask, odo_r, z_r, zm_r, motion_cov, grad_clip,
                             grad_rate)
        return torch.flip(traj_r, dims=(0,))

    def _n_refit_passes(self):
        """Forward refit passes + the single backward pass."""
        if self._refit is None:
            return 0
        return self.lcfg.refit_passes + (1 if self._refit_back is not None else 0)

    def sweep(self):
        """One pass: the sequential refit first (forward passes, then the
        reversed one), then Jacobi BP sweeps over leave-block-out cavity
        maps (causal maps first when there is no refit, frozen map messages
        from freeze_map_after on). The best state by the joint objective is
        kept; a non-finite objective reverts to it."""
        if self.best_state is None:
            # score the initial estimate, so a run that only degrades it
            # falls back to it
            self.best_state = self.state
            self.best_objective = self._score()
        n_refit = self._n_refit_passes()
        if self.sweeps < n_refit:
            backward = self._refit_back is not None and self.sweeps == n_refit - 1
            fn = self._refit_back if backward else self._refit
            traj = fn(self.params, self.state.lp, self.state.node_mask, self.odometry, self.z,
                      self.z_mask, self.motion_cov, self.grad_clip, self.grad_rate)
            self.state = loopy.init_state(self.model, self.lcfg, traj, self.n_nodes, self.dtype,
                                          self.device)
            self.sweeps += 1
            obj = self._score()
            if np.isfinite(obj) and obj > self.best_objective:
                self.best_objective = obj
                self.best_state = self.state
            return self
        bp_sweeps = max(self.sweeps - n_refit, 0)
        temperature = self._tensor(self.anneal_t0 / (bp_sweeps + 1))
        use_causal = self.sweeps == 0 and self._refit is None
        frozen = self.lcfg.freeze_map_after and self.sweeps >= self.lcfg.freeze_map_after
        fn = self._sweep_causal if use_causal else self._sweep_frozen if frozen else self._sweep
        self.state = fn(self.params, self.state, self.odometry, self.z, self.z_mask, temperature,
                        self.grad_clip, self.grad_rate, self.motion_cov)
        self.sweeps += 1
        obj = self._score()
        if not np.isfinite(obj):
            # numerical blowup: back to the best state
            self.state = self.best_state
        elif obj > self.best_objective:
            self.best_objective = obj
            self.best_state = self.state
        if self.lcfg.relinearize:
            self.state = loopy.relinearize(self.model, self.state)
        return self

    # 12 sweeps reach the converged plateau on the chap5 grids (JAX twin)
    DEFAULT_SWEEPS = 12

    def _objective(self, state):
        return loopy.trajectory_objective(self.model, self.lcfg, self.params, state,
                                          self.odometry, self.z, self.z_mask, self.motion_cov)

    def objective(self):
        chain, meas = self._objective(self.state)
        return float(chain) + float(meas)

    def _score(self):
        """Score self.state: updates the map-state selector, returns the
        joint objective (the trajectory selector). Two host reads."""
        chain, meas = (float(x) for x in self._objective(self.state))
        if np.isfinite(meas) and meas > self.best_map_objective:
            self.best_map_objective = meas
            self.best_map_state = self.state
        return chain + meas

    @property
    def result_state(self):
        return self.best_state if self.best_state is not None else self.state

    @property
    def result_map_state(self):
        # maps follow the joint selector; best_map_state stays a diagnostic
        return self.result_state

    @property
    def trajectory(self):
        traj = loopy.fused_trajectory(self.model, self.result_state)
        return traj.detach().cpu().numpy()[: self.n_nodes]

    def map_model(self):
        gm = loopy.final_map(self.model, self.lcfg, self.params, self.result_map_state, self.z,
                             self.z_mask)
        return self._gm_components(gm)

    def map_history(self):
        """Per-frame map snapshots over the final fused trajectory (the
        maps.out series): a list of component lists, one per node."""
        _, hist = loopy.final_map(self.model, self.lcfg, self.params, self.result_map_state,
                                  self.z, self.z_mask, history=True)
        hist = mixture.GM(*[x.detach().cpu() for x in hist])
        return [self._gm_components(mixture.GM(hist.mean[i], hist.cov[i], hist.logw[i]))
                for i in range(self.n_nodes)]

    @staticmethod
    def _gm_components(gm):
        logw = gm.logw.detach().cpu().numpy()
        mean, cov = gm.mean.detach().cpu().numpy(), gm.cov.detach().cpu().numpy()
        alive = logw > mixture.ALIVE_THRESHOLD
        return [(float(np.exp(logw[i])), mean[i], cov[i]) for i in np.nonzero(alive)[0]]
