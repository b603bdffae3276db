"""Model registry and bundle: pose-manifold operations plus a measurement
model as plain tensor functions (Navigator.cs:47-50, IMeasurer.cs:38-148):
the torch twin of monorfs_tpu.models.base. Landmarks are always 3-vectors;
the measurement dimension varies per model. Measurer parameters are a frozen
dataclass of Python floats. A depth-occlusion model (Kinect) takes the live
depth map as a trailing argument of its visibility functions; the `*_fn`
accessors close over it, and return the model's own functions for every
other model, which ignores the map."""

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PoseOps:
    state_dim: int
    odo_dim: int
    identity: Callable
    add: Callable
    subtract: Callable
    add_global: Callable
    subtract_global: Callable
    add_odometry: Callable
    diff_odometry: Callable
    add_jacobian: Callable
    subtract_jacobian: Callable
    add_odometry_jacobian: Callable


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    pose: PoseOps
    meas_dim: int
    params: Any  # frozen dataclass of floats

    # array-of-structures forms: (params, pose [..., S], lm [..., 3]) -> ...
    measure: Callable
    jac_landmark: Callable  # -> [..., D, 3]
    jac_pose: Callable  # -> [..., D, T], in the tangent of pose.add
    to_map: Callable  # (params, pose, z [..., D]) -> lm [..., 3]
    fit_to_measurement: Callable  # (params, pose0, z, lm) -> pose [..., S]
    fuzzy_visible: Callable
    visible: Callable
    random_measure: Callable  # (params, uniforms [..., D]) -> z [..., D]
    volume: Callable
    # structure-of-arrays (K-last) hot-path forms over lists of [..., K]
    measure_soa: Callable  # (params, pose, m 3-list) -> D-list
    jac_landmark_soa: Callable  # -> D x 3 smallmat list
    to_map_soa: Callable  # (params, pose, z D-list) -> 3-list
    fuzzy_visible_soa: Callable  # (params, z D-list, ramp)
    # depth-occlusion models take the live depth map [H, W] as a trailing
    # argument of visible / fuzzy_visible / fuzzy_visible_soa
    uses_depth: bool = False
    # (params) -> the 8 floats csrc/model_policy.cuh's ModelParams holds for
    # the family's instantiation; None for a model no hand-written kernel takes
    kernel_params: Optional[Callable] = None

    def with_params(self, params):
        return dataclasses.replace(self, params=params)

    def _depth(self, depth_map, like):
        """The depth map, or a [1, 1] +inf one (frustum visibility alone)."""
        if depth_map is not None:
            return depth_map
        return torch.full((1, 1), float("inf"), dtype=like.dtype, device=like.device)

    def fuzzy_visible_fn(self, depth_map=None):
        """fuzzy_visible closed over the (possibly unused) depth map."""
        if self.uses_depth:
            return lambda params, z, ramp: self.fuzzy_visible(params, z, ramp, self._depth(depth_map, z))
        return self.fuzzy_visible

    def visible_fn(self, depth_map=None):
        """visible closed over the (possibly unused) depth map; with None a
        depth-occlusion model sees through a [1, 1] +inf map, so frustum
        visibility alone counts."""
        if self.uses_depth:
            return lambda params, z: self.visible(params, z, self._depth(depth_map, z))
        return self.visible

    def measure_soa_fn(self):
        return self.measure_soa

    def jac_landmark_soa_fn(self):
        return self.jac_landmark_soa

    def to_map_soa_fn(self):
        return self.to_map_soa

    def fuzzy_visible_soa_fn(self, depth_map=None):
        if self.uses_depth:
            return lambda params, z, ramp: self.fuzzy_visible_soa(params, z, ramp,
                                                                  self._depth(depth_map, z[0]))
        return self.fuzzy_visible_soa


_REGISTRY = {}


def register(model: Model):
    _REGISTRY[model.name] = model
    return model


def get(name: str) -> Model:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
