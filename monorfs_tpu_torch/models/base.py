"""Model bundle: pose-manifold operations plus a measurement model as plain
tensor functions (Navigator.cs:47-50, IMeasurer.cs:38-148): the torch twin of
monorfs_tpu.models.base. Measurer parameters are a frozen dataclass of
Python floats."""

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
    fuzzy_visible: Callable
    visible: Callable
    random_measure: Callable  # (params, uniforms [..., D]) -> z [..., D]
    volume: Callable
    # structure-of-arrays (K-last) hot-path forms over 3-lists of [..., K]
    measure_soa: Callable
    jac_landmark_soa: Callable
    to_map_soa: Callable
    fuzzy_visible_soa: Callable

    def with_params(self, params):
        return dataclasses.replace(self, params=params)
