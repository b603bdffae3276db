"""Simulated ground-truth vehicle (SimulatedVehicle.cs:47-387 +
Vehicle.cs:313-352): the torch twin of monorfs_tpu.sim.vehicle.

Per-landmark Bernoulli detection with fuzzy-visibility-scaled PD, Gaussian
measurement noise, Poisson clutter capped at 10 lambda and at max_clutter,
reset-on-read noisy odometry. Every draw is injected as a tensor, so a test
can hand both packages the same numbers; outputs have fixed shapes
(measurement slots + mask)."""

from typing import NamedTuple

import numpy as np
import torch


from .gaussian import sqrt_cov

CLUTTER_LABEL = -2
NO_MEASUREMENT = -9999


class VehicleParams(NamedTuple):
    motion_sqrt: torch.Tensor  # [T, T] factor of the true motion covariance
    meas_sqrt: torch.Tensor  # [D, D] factor of the true measurement covariance
    pd: torch.Tensor  # DetectionProbability
    clutter_count: torch.Tensor  # ClutterDensity * measurer volume
    visibility_ramp: torch.Tensor  # [D]
    dt: torch.Tensor
    perfect_still: torch.Tensor  # bool


class VehicleState(NamedTuple):
    pose: torch.Tensor  # [S] true pose
    landmarks: torch.Tensor  # [L, 3]
    landmark_mask: torch.Tensor  # [L] bool


def make_params(model, cfg, dtype=torch.float32, device="cuda"):
    """VehicleParams from a Config (square-root factors on the host, float64)."""
    device = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return VehicleParams(
        motion_sqrt=t(sqrt_cov(cfg.motion_covariance)),
        meas_sqrt=t(sqrt_cov(cfg.measurement_covariance)),
        pd=t(cfg.detection_probability),
        clutter_count=t(cfg.clutter_density * float(model.volume(model.params))),
        visibility_ramp=t(cfg.visibility_ramp),
        dt=t(cfg.measure_elapsed),
        perfect_still=torch.tensor(bool(cfg.perfect_still), device=device),
    )


def update(model, params: VehicleParams, state: VehicleState, reading, normals):
    """Advance the true pose by the exact reading and return the noisy
    odometry (Vehicle.cs:325-352: noise = dt * N(0, Q), reset on read).
    With PerfectStill and a zero reading no noise is added
    (SimulatedVehicle.cs:190-202). normals: [T] standard normals."""
    new_pose = model.pose.add_odometry(state.pose, reading)
    noise = params.dt * torch.sum(params.motion_sqrt * normals[None, :], dim=-1)
    still = params.perfect_still & torch.all(reading == 0)
    noise = torch.where(still, torch.zeros_like(noise), noise)
    odometry_pose = model.pose.add_odometry(new_pose, noise)
    noisy_reading = model.pose.diff_odometry(odometry_pose, state.pose)
    return state._replace(pose=new_pose), noisy_reading


def measure(model, params: VehicleParams, state: VehicleState, detect_u,
            meas_normals, clutter_draw, clutter_u, max_clutter: int):
    """One measurement set (SimulatedVehicle.Measure, :243-295).

    detect_u [L] uniforms, meas_normals [L, D] normals, clutter_draw a
    Poisson(clutter_count) draw (integer tensor), clutter_u [max_clutter, D]
    uniforms. Returns (z [L + C, D], mask, labels, visible, detected); the
    first L slots follow landmark order, clutter fills the tail."""
    lm = state.landmarks
    l = lm.shape[0]
    dev = lm.device
    perfect = model.measure(model.params, state.pose[None, :], lm)  # [L, D]
    pd = model.fuzzy_visible(model.params, perfect, params.visibility_ramp) * params.pd
    detected = state.landmark_mask & (pd > 0) & (detect_u < pd)
    noise = torch.sum(params.meas_sqrt[None, :, :] * meas_normals[:, None, :], dim=-1)
    z_land = perfect + noise

    # Poisson clutter, capped at 10 lambda (SimulatedVehicle.cs:269-285)
    cap = torch.floor(params.clutter_count * 10).to(torch.int64)
    n_clutter = torch.clamp(torch.minimum(clutter_draw.to(torch.int64), cap), max=max_clutter)
    z_clutter = model.random_measure(model.params, clutter_u)
    clutter_mask = torch.arange(max_clutter, device=dev) < n_clutter

    z = torch.cat([z_land, z_clutter.to(z_land.dtype)], dim=0)
    mask = torch.cat([detected, clutter_mask])
    labels = torch.cat(
        [
            torch.where(
                detected, torch.arange(l, device=dev),
                torch.full((l,), NO_MEASUREMENT, device=dev),
            ),
            torch.full((max_clutter,), CLUTTER_LABEL, device=dev),
        ]
    )
    visible = state.landmark_mask & (pd > 0)
    return z, mask, labels, visible, detected
