"""Simulated ground-truth vehicle (SimulatedVehicle.cs:47-387 +
Vehicle.cs:313-352): the torch twin of monorfs_tpu.sim.vehicle.

Per-landmark Bernoulli detection with fuzzy-visibility-scaled PD, Gaussian
measurement noise, Poisson clutter capped at 10 lambda and at max_clutter,
reset-on-read noisy odometry. Every draw is injected as a tensor, so a test
can hand both packages the same numbers; outputs have fixed shapes
(measurement slots + mask). `FrameRunner` runs `update` then `measure` as
one CUDA-graph replay a frame; the two functions stay the eager path."""

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..gm.gaussian import sqrt_cov

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
    device = resolve_device(device)

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


DRAWS = ("odo_normals", "detect_u", "meas_normals", "clutter_draw", "clutter_u")  # a frame's vehicle draws


class FrameRunner:
    """`update` followed by `measure` on tensors at fixed addresses: on a
    CUDA device recorded once, when the runner is built, as one CUDA graph
    and replayed every frame (one launch for the ~400 small operators the
    host would dispatch one by one), on the CPU run eagerly on the same
    tensors. The outputs are the eager functions' bit for bit: the graph
    replays the same kernels on the same inputs.

    Each call copies the true pose and the frame's draws in (they arrive
    as views of per-sequence or per-chunk tensors, so their addresses
    change) and stages the host reading through a pinned buffer, copied
    without blocking the host. What it hands out is fresh each frame, one
    copy a dtype with views into it, so a caller may hold a frame's tensors
    across the next. `params`, the landmarks and their mask are read where
    they lie when the runner is built: they must not be replaced."""

    def __init__(self, model, params: VehicleParams, state: VehicleState, draws, max_clutter: int):
        self.model, self.params, self.max_clutter = model, params, max_clutter
        self.landmarks, self.landmark_mask = state.landmarks, state.landmark_mask
        dev, dtype = state.pose.device, state.pose.dtype
        odo, n_lm = model.pose.odo_dim, state.landmarks.shape[0]
        slots = n_lm + max_clutter
        self.float_sizes = [state.pose.numel(), odo, slots * model.meas_dim]  # pose, noisy, z
        self.bool_sizes = [slots, n_lm, n_lm]  # mask, visible, detected
        self.pose = state.pose.clone()
        self.reading = torch.zeros(odo, dtype=dtype, device=dev)
        self.draws = {name: draws[name].clone() for name in DRAWS}
        self.cuda = dev.type == "cuda"
        # two host buffers for the reading, each rewritten only after the copy
        # that last read it has run: the host may be frames ahead of the device
        staging = [torch.zeros(odo, dtype=dtype, pin_memory=self.cuda) for _ in range(2)]
        self.staging = [(t, t.numpy()) for t in staging]
        self.staged = [torch.cuda.Event() for _ in staging] if self.cuda else None
        self.frame = 0
        self.graph = self.outputs = None
        if self.cuda:
            self._capture()

    def _body(self):
        """update + measure on the fixed tensors; the outputs packed one
        tensor a dtype: [pose, noisy, z] in the pose's float type, [mask,
        visible, detected] bools, the labels."""
        state = VehicleState(self.pose, self.landmarks, self.landmark_mask)
        state, noisy = update(self.model, self.params, state, self.reading, self.draws["odo_normals"])
        z, mask, labels, visible, detected = measure(
            self.model, self.params, state, self.draws["detect_u"], self.draws["meas_normals"],
            self.draws["clutter_draw"], self.draws["clutter_u"], self.max_clutter,
        )
        return torch.cat([state.pose, noisy, z.reshape(-1)]), torch.cat([mask, visible, detected]), labels

    def _capture(self):
        """Warm up on a side stream, then record `_body` there into one CUDA
        graph, whose outputs, in the graph's own memory pool, are rewritten
        by every replay. (torch.cuda.graph would first synchronise and empty
        the allocator's cache, which the next frame's step would refill.)"""
        current = torch.cuda.current_stream(self.pose.device)
        side = torch.cuda.Stream(self.pose.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._body()
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin()
            try:
                self.outputs = self._body()
            finally:
                self.graph.capture_end()
        current.wait_stream(side)

    def _stage(self, reading):
        """The host reading (numbers) into the fixed reading tensor, cast as
        `torch.as_tensor` casts float64; on a CUDA device through a pinned
        buffer and a copy that does not block the host."""
        slot = self.frame % 2
        self.frame += 1
        host, host_np = self.staging[slot]
        if self.cuda:
            self.staged[slot].synchronize()
        host_np[:] = np.asarray(reading, np.float64)
        self.reading.copy_(host, non_blocking=self.cuda)
        if self.cuda:
            self.staged[slot].record()

    def __call__(self, pose, reading, draws):
        """One frame from the true pose, the exact reading (host numbers,
        odometry dimensions) and the frame's draws (a dict holding DRAWS):
        (new true pose, noisy reading, z, mask, labels, visible, detected),
        as `update` and `measure` give them."""
        self._stage(reading)
        torch._foreach_copy_([self.pose, *self.draws.values()], [pose, *(draws[name] for name in DRAWS)])
        if self.graph is None:
            floats, bools, labels = self._body()
        else:
            self.graph.replay()
            floats, bools, labels = (t.clone() for t in self.outputs)
        new_pose, noisy, z = floats.split(self.float_sizes)
        mask, visible, detected = bools.split(self.bool_sizes)
        return new_pose, noisy, z.view(-1, self.model.meas_dim), mask, labels, visible, detected
