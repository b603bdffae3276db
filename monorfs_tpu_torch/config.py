"""Run configuration: the port's own copy of monorfs_tpu's Config
(reference: mono-rfs-lib/Config.cs:43-310): the fields, the model presets,
the `Name: value` descriptor format with Octave-style matrices that cfg files
and recordings carry, plus `phd_params` returning the PHD navigator
parameters as torch tensors.

Beyond the reference's fields, a cfg may state the PHD step's budget
(`GateTop`, `EstimateCap`, `BeamWidth`, `BeamCandidates`, `BeamMeasCap`,
`MergeRounds`: the PHDConfig fields of the same names, as `phd_budget`
returns them); each defaults to None, which keeps PHDConfig's default and
writes no line, so a cfg without them serialises as the reference's does."""

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from . import resolve_device


def _parse_matrix(text):
    """Parse an Octave-style jagged matrix: [a b; c d] (Config.cs:173-180)."""
    text = text.strip()
    if text.startswith("["):
        text = text[1:]
    if text.endswith("]"):
        text = text[:-1]
    rows = [r.strip() for r in text.split(";") if r.strip()]
    return np.array([[float(v) for v in re.split(r"[,\s]+", r) if v] for r in rows])


def _format_matrix(mat):
    mat = np.atleast_2d(np.asarray(mat, dtype=float))
    return "[" + "; ".join(" ".join(repr(float(v)) for v in row) for row in mat) + "]"


@dataclasses.dataclass
class Config:
    """Config.cs:45-103 field for field (rendering-only fields kept so a
    reference cfg maps one to one), then the PHD step's budget."""

    # General
    n_parallel: int = 8
    model: str = "PRM3D"

    # Manipulator
    axis_limit: float = 10.0

    # Simulation
    measure_elapsed: float = 1.0 / 30
    map_clip: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-6.0, 6, -3, 3])
    )
    use_odometry: bool = True
    checkpoint_cycle_time: int = 300

    # Vehicle
    motion_covariance: np.ndarray = None
    measurement_covariance: np.ndarray = None

    # SimulatedVehicle
    detection_probability: float = 0.9
    clutter_density: float = 3e-7
    perfect_still: bool = False
    visibility_ramp: np.ndarray = None

    # KinectVehicle
    kinect_delta: int = 4
    keypoint_filter: bool = True
    sidebar_jpeg_quality: int = 85

    # Navigator
    show_visible: bool = False
    density_distance_threshold: float = 0.5

    # PHDNavigator
    birth_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: 1e-2 * np.eye(3)
    )
    birth_weight: float = 0.05
    min_weight: float = 1e-3
    min_effective_particle: float = 0.1
    max_quantity: int = 600
    merge_threshold: float = 0.3
    exploration_threshold: float = 1e-5
    render_all_particles: bool = True

    motion_covariance_multiplier: float = 1.0
    measurement_covariance_multiplier: float = 1.0
    navigator_pd: float = 0.9
    navigator_clutter_density: float = 3e-7

    # LoopyPHDNavigator
    gradient_ascent_rate: float = 1e-2
    gradient_clip: float = 10.0
    loopy_sweeps: int = 1

    # ISAM2Navigator
    match_threshold: float = 3.0
    new_landmark_threshold: int = 3
    da_algorithm: str = "Mahalanobis"

    # OdometryNavigator
    odometry_merge_threshold: float = 1e-2

    # the PHD step's budget: the port's own keys (module docstring)
    gate_top: Optional[int] = None
    estimate_cap: Optional[int] = None
    beam_width: Optional[int] = None
    beam_candidates: Optional[int] = None
    beam_meas_cap: Optional[int] = None
    merge_rounds: Optional[int] = None

    def __post_init__(self):
        if self.motion_covariance is None:
            self.set_prm3d_defaults()

    # model presets (Config.cs:214-263)

    def _set_ramp(self):
        self.visibility_ramp = 3.0 * np.sqrt(np.diag(self.measurement_covariance))
        self.navigator_clutter_density = self.clutter_density

    def set_prm3d_defaults(self):
        self.model = "PRM3D"
        self.motion_covariance = np.diag([5e-3] * 3 + [2e-4] * 3)
        self.measurement_covariance = np.diag([2e-0, 2e-0, 1e-3])
        self.clutter_density = 3e-7
        self._set_ramp()

    def set_linear2d_defaults(self):
        self.model = "Linear2D"
        self.motion_covariance = np.diag([2e0, 2e0])
        self.measurement_covariance = np.diag([5e-4, 5e-4])
        self.clutter_density = 3e-7
        self._set_ramp()

    def set_linear1d_defaults(self):
        self.model = "Linear1D"
        self.motion_covariance = np.diag([2e0])
        self.measurement_covariance = np.diag([5e-4])
        self.clutter_density = 3e-7
        self._set_ramp()

    def set_model_defaults(self, model_name):
        presets = {
            "PRM3D": self.set_prm3d_defaults,
            "Linear2D": self.set_linear2d_defaults,
            "Linear1D": self.set_linear1d_defaults,
        }
        if model_name not in presets:
            raise ValueError(f"unknown model {model_name}")
        presets[model_name]()

    # reference-format (de)serialization

    _FIELD_MAP = {
        "NParallel": ("n_parallel", int),
        "Model": ("model", str),
        "AxisLimit": ("axis_limit", float),
        "MeasureElapsed": ("measure_elapsed", float),
        "MapClip": ("map_clip", "vector"),
        "UseOdometry": ("use_odometry", bool),
        "CheckpointCycleTime": ("checkpoint_cycle_time", int),
        "MotionCovariance": ("motion_covariance", "matrix"),
        "MeasurementCovariance": ("measurement_covariance", "matrix"),
        "DetectionProbability": ("detection_probability", float),
        "ClutterDensity": ("clutter_density", float),
        "PerfectStill": ("perfect_still", bool),
        "VisibilityRamp": ("visibility_ramp", "vector"),
        "KinectDelta": ("kinect_delta", int),
        "KeypointFilter": ("keypoint_filter", bool),
        "SidebarJpegQuality": ("sidebar_jpeg_quality", int),
        "ShowVisible": ("show_visible", bool),
        "DensityDistanceThreshold": ("density_distance_threshold", float),
        "BirthCovariance": ("birth_covariance", "matrix"),
        "BirthWeight": ("birth_weight", float),
        "MinWeight": ("min_weight", float),
        "MinEffectiveParticle": ("min_effective_particle", float),
        "MaxQuantity": ("max_quantity", int),
        "MergeThreshold": ("merge_threshold", float),
        "ExplorationThreshold": ("exploration_threshold", float),
        "RenderAllParticles": ("render_all_particles", bool),
        "MotionCovarianceMultiplier": ("motion_covariance_multiplier", float),
        "MeasurementCovarianceMultiplier": (
            "measurement_covariance_multiplier",
            float,
        ),
        "NavigatorPD": ("navigator_pd", float),
        "NavigatorClutterDensity": ("navigator_clutter_density", float),
        "GradientAscentRate": ("gradient_ascent_rate", float),
        "GradientClip": ("gradient_clip", float),
        "LoopySweeps": ("loopy_sweeps", int),
        "MatchThreshold": ("match_threshold", float),
        "NewLandmarkThreshold": ("new_landmark_threshold", int),
        "DAAlgorithm": ("da_algorithm", str),
        "OdometryMergeThreshold": ("odometry_merge_threshold", float),
        "GateTop": ("gate_top", int),
        "EstimateCap": ("estimate_cap", int),
        "BeamWidth": ("beam_width", int),
        "BeamCandidates": ("beam_candidates", int),
        "BeamMeasCap": ("beam_meas_cap", int),
        "MergeRounds": ("merge_rounds", int),
    }
    PHD_BUDGET = ("gate_top", "estimate_cap", "beam_width", "beam_candidates", "beam_meas_cap",
                  "merge_rounds")

    def apply_descriptor(self, lines):
        """Apply `Name: value` lines, leaving missing fields as-is
        (Config.FromDescriptor, Config.cs:155-209). If the descriptor sets
        the Model, model defaults are applied first so later lines override
        them (mirrors the reference behavior where presets run before file
        parsing and cfg files list Model first)."""
        parsed = []
        for line in lines:
            parts = line.split(":", 1)
            if len(parts) != 2:
                continue
            name, value = parts[0].strip(), parts[1].strip()
            if name not in self._FIELD_MAP:
                continue
            parsed.append((name, value))

        for name, value in parsed:
            if name == "Model":
                self.set_model_defaults(value)
                break

        for name, value in parsed:
            field, kind = self._FIELD_MAP[name]
            if kind == "matrix":
                setattr(self, field, _parse_matrix(value))
            elif kind == "vector":
                setattr(self, field, _parse_matrix(value)[0])
            elif kind is bool:
                setattr(self, field, value.strip().lower() == "true")
            elif kind is int:
                setattr(self, field, int(value))
            elif kind is float:
                setattr(self, field, float(value))
            else:
                setattr(self, field, value)
        return self

    @classmethod
    def from_file(cls, filename):
        cfg = cls()
        with open(filename) as f:
            cfg.apply_descriptor(f.read().splitlines())
        return cfg

    def to_descriptor(self) -> str:
        """Serialize in the reference `Name: value` format
        (Config.ToString, Config.cs:268-309)."""
        out = []
        for name, (field, kind) in self._FIELD_MAP.items():
            val = getattr(self, field)
            if val is None:
                continue
            if kind in ("matrix", "vector"):
                out.append(f"{name}: {_format_matrix(val)}")
            elif kind is bool:
                out.append(f"{name}: {bool(val)}")
            else:
                out.append(f"{name}: {val}")
        return "\n".join(out)

    def phd_budget(self):
        """The PHD step's budget that this configuration states: the
        PHDConfig fields of PHD_BUDGET that are not None."""
        return {name: getattr(self, name) for name in self.PHD_BUDGET if getattr(self, name) is not None}

    def phd_params(self, dtype=torch.float32, device="cuda"):
        """PHDParams tensors the navigator consumes (covariance multipliers
        applied as in PHDNavigator.cs:257-259)."""
        from .slam.phd import make_params

        return make_params(
            motion_cov=self.motion_covariance_multiplier * self.motion_covariance,
            meas_cov=self.measurement_covariance_multiplier
            * self.measurement_covariance,
            pd=self.navigator_pd,
            clutter_density=self.navigator_clutter_density,
            birth_weight=self.birth_weight,
            birth_cov=self.birth_covariance,
            min_weight=self.min_weight,
            merge_threshold=self.merge_threshold,
            exploration_threshold=self.exploration_threshold,
            density_radius=self.density_distance_threshold,
            min_effective_particle=self.min_effective_particle,
            visibility_ramp=self.visibility_ramp,
            dt=self.measure_elapsed,
            dtype=dtype,
            device=resolve_device(device),
        )
