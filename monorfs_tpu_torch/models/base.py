"""Model registry and bundle: pose-manifold operations plus a measurement
model as plain tensor functions (Navigator.cs:47-50, IMeasurer.cs:38-148):
the torch twin of monorfs_tpu.models.base. Landmarks are always 3-vectors;
the measurement dimension varies per model. Measurer parameters are a frozen
dataclass of Python floats. No ported model has depth occlusion, so the
`*_fn` accessors return the model's own functions."""

import dataclasses
from typing import Any, Callable


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

    def with_params(self, params):
        return dataclasses.replace(self, params=params)

    def fuzzy_visible_fn(self):
        return self.fuzzy_visible

    def visible_fn(self):
        return self.visible

    def measure_soa_fn(self):
        return self.measure_soa

    def jac_landmark_soa_fn(self):
        return self.jac_landmark_soa

    def to_map_soa_fn(self):
        return self.to_map_soa

    def fuzzy_visible_soa_fn(self):
        return self.fuzzy_visible_soa


_REGISTRY = {}


def register(model: Model):
    _REGISTRY[model.name] = model
    return model


def get(name: str) -> Model:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
