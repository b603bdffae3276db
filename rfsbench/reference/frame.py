"""One frame of the benchmark's configurations, worked out again from the
configuration file, the benchmark's inputs and the state the frame starts
from: the simulated vehicle's measurement set, then predict, the correct
stage, the weight inputs with the beam, and the normalised weights with the
systematic draws.

Everything here is plain PyTorch (the frozen copies beside this file); it
imports nothing of the port. The SLAM stages run in blocks of particles so
that the float64 pass fits beside the port's state."""

import numpy as np
import torch

from . import association, mixture, phd, prm3d, vehicle
from .gaussian import sqrt_cov
from .mixture import SGM


def pose_model(config):
    """The measurement model of a configuration file: PRM3D with the
    world's camera."""
    return prm3d.MODEL.with_params(prm3d.Params.from_linear(config["camera"]))


def _mat(x):
    return np.atleast_2d(np.asarray(x, np.float64))


def phd_params(config, dtype, device):
    """The navigator's parameters (covariance multipliers applied) from the
    configuration's descriptor."""
    d = config["descriptor"]
    fields = dict(
        motion_cov=d["MotionCovarianceMultiplier"] * _mat(d["MotionCovariance"]),
        meas_cov=d["MeasurementCovarianceMultiplier"] * _mat(d["MeasurementCovariance"]),
        pd=d["NavigatorPD"], clutter_density=d["NavigatorClutterDensity"],
        birth_weight=d["BirthWeight"], birth_cov=_mat(d["BirthCovariance"]),
        min_weight=d["MinWeight"], merge_threshold=d["MergeThreshold"],
        exploration_threshold=d["ExplorationThreshold"],
        density_radius=d["DensityDistanceThreshold"],
        min_effective_particle=d["MinEffectiveParticle"],
        visibility_ramp=np.asarray(d["VisibilityRamp"], np.float64).ravel(),
        dt=d["MeasureElapsed"], depth_map=np.full((1, 1), np.inf),
    )
    vals = {k: torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)
            for k, v in fields.items()}
    vals["motion_sqrt"] = torch.as_tensor(sqrt_cov(fields["motion_cov"]), dtype=dtype, device=device)
    return phd.PHDParams(**vals)


def vehicle_params(config, model, dtype, device):
    """The simulated vehicle's parameters from the descriptor."""
    d = config["descriptor"]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return vehicle.VehicleParams(
        motion_sqrt=t(sqrt_cov(_mat(d["MotionCovariance"]))),
        meas_sqrt=t(sqrt_cov(_mat(d["MeasurementCovariance"]))),
        pd=t(d["DetectionProbability"]),
        clutter_count=t(d["ClutterDensity"] * float(model.volume(model.params))),
        visibility_ramp=t(np.asarray(d["VisibilityRamp"], np.float64).ravel()),
        dt=t(d["MeasureElapsed"]),
        perfect_still=torch.tensor(bool(d["PerfectStill"]), device=device),
    )


def phd_config(config, particles):
    return phd.PHDConfig(num_particles=particles, **config["phd"])


def init_state(config, particles, pose0, dtype, device):
    """The filter's first state: every particle at the world's pose, equal
    weights, empty maps."""
    k = config["phd"]["max_components"]
    pose = torch.as_tensor(np.asarray(pose0, np.float64), dtype=dtype, device=device)
    return dict(
        pose=pose.expand(particles, pose.shape[0]).clone(),
        logweight=torch.full((particles,), -float(np.log(particles)), dtype=dtype, device=device),
        maps=mixture.empty_soa(k, dtype, batch=(particles,), device=device),
    )


# ---- measurement sets -------------------------------------------------------

def vehicle_frame(config, model, vparams, pose_prev, landmarks, command, draws):
    """The simulated vehicle's frame from the true pose it starts at: (true
    pose, noisy odometry, z [L + C, D], mask [L + C])."""
    dt = vparams.dt.dtype
    lm_mask = torch.ones(landmarks.shape[0], dtype=torch.bool, device=landmarks.device)
    state = vehicle.VehicleState(pose=pose_prev, landmarks=landmarks, landmark_mask=lm_mask)
    reading = torch.as_tensor(np.asarray(command[: model.pose.odo_dim], np.float64), dtype=dt,
                              device=landmarks.device)
    state, noisy = vehicle.update(model, vparams, state, reading, draws["odo_normals"].to(dt))
    z, mask, _, _, _ = vehicle.measure(
        model, vparams, state, draws["detect_u"].to(dt), draws["meas_normals"].to(dt),
        draws["clutter_draw"], draws["clutter_u"].to(dt), config["max_clutter"])
    if not config["descriptor"]["UseOdometry"]:
        noisy = torch.zeros_like(noisy)
    return state.pose, noisy, z, mask


# ---- the SLAM step ------------------------------------------------------------

def _block(sgm, rows):
    return SGM(*[leaf[rows] for leaf in sgm])


def systematic(w, u):
    """The systematic (wheel) draw's source slot of every particle from the
    normalised weights w [P] and one uniform u."""
    p = w.shape[0]
    cum = torch.cumsum(w, dim=0)
    positions = u.to(w.dtype) / p + torch.arange(p, dtype=w.dtype, device=w.device) / p
    return torch.clamp(torch.searchsorted(cum, positions, side="left"), 0, p - 1)


def slam_frame(config, model, cfg, params, state, odometry, z, z_mask, motion_normals,
               resample_u, block=250, corrected_in=None, held=None):
    """The frame's SLAM step from `state` (pose [P, S], logweight [P], maps
    SGM [P, K]): predict, the correct stage, the weight inputs with the
    beam, the normalisation and the ESS test, and the systematic draws.

    corrected_in (SGM [P, K], the port's corrected maps) and held ([P] bool)
    make the weight inputs of each held particle start from the port's
    corrected map, its MAP estimate chosen on the port's own values, as the
    port's step chose it; the correct stage is judged by itself (the
    corrected maps returned are always the reference's).

    Returns a dict: the predicted poses `pose` [P, S] and corrected maps
    `maps` of every particle (before the resampling gather), the normalised
    log-weights `logweight` [P], `ess`, `depleted`, the draws' source slots
    `src` [P], `margin` [P] (mixture.map_margin of the reference's own
    corrected map), and the next state as the step would hand it on
    (`next`)."""
    dt = state["pose"].dtype
    p = state["pose"].shape[0]
    odometry, z = odometry.to(dt), z.to(dt)
    moved = model.pose.add_odometry(state["pose"], odometry[None, :])
    noise = params.dt * torch.sum(params.motion_sqrt[None, :, :] * motion_normals.to(dt)[:, None, :],
                                  dim=-1)
    pose = model.pose.add_odometry(moved, noise)
    n_words = (cfg.estimate_cap + 31) // 32
    chosen = None
    if corrected_in is not None:  # on every particle at once, as the port chooses
        chosen = mixture.best_map_indices(corrected_in.logw, cfg.estimate_cap)
    increments, corrected, margins = [], [], []
    for lo in range(0, p, block):
        rows = slice(lo, min(p, lo + block))
        pose_b, maps_b = pose[rows], _block(state["maps"], rows)
        pred, cor = phd.fused_stage_plain(model, cfg, params, pose_b, maps_b, z, z_mask)
        margins.append(mixture.map_margin(cor.logw, cfg.estimate_cap))
        used, selection = cor, None
        if chosen is not None:
            h = held[rows].to(cor.logw.device)[:, None]
            used = SGM(*[torch.where(h, a[rows].to(dt), b) for a, b in zip(corrected_in, cor)])
            own = mixture.best_map_indices(cor.logw, cfg.estimate_cap)
            selection = tuple(torch.where(h, c[rows], o) for c, o in zip(chosen, own))
        rest, base, od, wk, bk = phd.weight_inputs(model, cfg, params, pose_b, pred, used, z, z_mask,
                                                   selection=selection)
        scores = association.beam_scan(base, od, wk, bk, cfg.beam_width, n_words)
        increments.append(association.logsumexp_scores(scores) + rest)
        corrected.append(cor)
        del pred, used, rest, base, od, wk, bk, scores
    increment = torch.cat(increments)
    maps = SGM(*[torch.cat([c[i] for c in corrected]) for i in range(len(SGM._fields))])

    lw = state["logweight"] + increment
    top = lw.max()
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    norm = torch.log(torch.sum(torch.exp(lw - top))) + top
    lw = torch.where(torch.isfinite(norm), lw - norm, state["logweight"])
    w = torch.exp(lw)
    ess = 1.0 / torch.clamp(torch.sum(w * w), min=1e-30)
    depleted = bool(ess < params.min_effective_particle * p)
    src = systematic(w, resample_u)
    if depleted:
        best = p - 1 - phd.first_argmax(torch.flip(w[src], dims=(0,)), 0)[1]
        nxt = dict(pose=pose[src], logweight=torch.full_like(lw, -float(np.log(p))),
                   maps=SGM(*[leaf[src] for leaf in maps]), ancestor=src, best=best)
    else:
        nxt = dict(pose=pose, logweight=lw, maps=maps, ancestor=torch.arange(p, device=lw.device),
                   best=phd.first_argmax(lw, 0)[1])
    return dict(pose=pose, maps=maps, logweight=lw, ess=float(ess), depleted=depleted,
                ess_threshold=float(params.min_effective_particle * p), src=src,
                margin=torch.cat(margins), next=nxt)
