"""Carry filter state and parameters across from monorfs_tpu.

The JAX package's arrays arrive as numpy (np.asarray of each field), so this
module imports neither JAX nor the JAX package. The system has no learned
weights: the parameters and the filter state are what must match between
the two packages."""

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .gm.mixture import GM, SGM
from .sim.vehicle import VehicleState
from .slam import graph, isam2_scan_da, loopy, phd

_PARAM_FIELDS = (
    "motion_cov", "meas_cov", "pd", "clutter_density", "birth_weight",
    "birth_cov", "min_weight", "merge_threshold", "exploration_threshold",
    "density_radius", "min_effective_particle", "visibility_ramp", "dt",
)


def _t(x, dtype, dev):
    return torch.tensor(np.array(x), dtype=dtype, device=dev)


def phd_params(fields, dtype=torch.float32, device="cuda"):
    """PHDParams from a mapping of the JAX PHDParams fields (e.g.
    `{k: np.asarray(v) for k, v in params._asdict().items()}`), for any
    measurement dimension and pose width; depth_map when the mapping has
    one."""
    names = _PARAM_FIELDS + (("depth_map",) if "depth_map" in fields else ())
    return phd.make_params(dtype=dtype, device=device, **{k: np.asarray(fields[k]) for k in names})


def phd_state(pose, logweight, maps, best, ancestor, dtype=torch.float32, device="cuda"):
    """PHDState from numpy: pose [P, S], logweight [P], the 10 SGM leaves
    [P, K] (mx, my, mz, cxx, cxy, cxz, cyy, cyz, czz, logw), best [] and
    ancestor [P]."""
    dev = resolve_device(device)
    leaves = list(maps)
    if len(leaves) != 10:
        raise ValueError(f"expected the 10 SGM leaves, got {len(leaves)}")
    return phd.PHDState(
        pose=_t(pose, dtype, dev),
        logweight=_t(logweight, dtype, dev),
        maps=SGM(*[_t(leaf, dtype, dev) for leaf in leaves]),
        best=_t(best, torch.int64, dev).reshape(()),
        ancestor=_t(ancestor, torch.int64, dev),
    )


def vehicle_state(pose, landmarks, landmark_mask, dtype=torch.float32, device="cuda"):
    """VehicleState from numpy: pose [S], landmarks [L, 3], mask [L]."""
    dev = resolve_device(device)
    return VehicleState(
        pose=_t(pose, dtype, dev),
        landmarks=_t(landmarks, dtype, dev),
        landmark_mask=_t(landmark_mask, torch.bool, dev),
    )


def graph_state(fields, dtype=torch.float64, device="cuda"):
    """GraphState from a mapping of the JAX GraphState fields as numpy
    (`{k: np.asarray(v) for k, v in state._asdict().items()}`)."""
    dev = resolve_device(device)
    kinds = dict(
        poses=dtype, landmarks=dtype, between=dtype, f_z=dtype, lm_mask=torch.bool,
        between_mask=torch.bool, pose_fixed=torch.bool, f_mask=torch.bool,
        f_pose=torch.int64, f_lm=torch.int64,
    )
    return graph.GraphState(
        n_poses=int(fields["n_poses"]), **{k: _t(fields[k], kind, dev) for k, kind in kinds.items()}
    )


def da_state(fields, dtype=torch.float32, device="cuda"):
    """DAState from a mapping of the JAX DAState fields as numpy."""
    dev = resolve_device(device)
    return isam2_scan_da.DAState(
        pl_cov=_t(fields["pl_cov"], dtype, dev),
        cand_mean=_t(fields["cand_mean"], dtype, dev),
        cand_count=_t(fields["cand_count"], torch.int64, dev),
        next_label=int(fields["next_label"]),
    )


def loopy_state(fields, dtype=torch.float32, device="cuda"):
    """LoopyState from a mapping of the JAX LoopyState fields as numpy
    (`{k: np.asarray(v) for k, v in state._asdict().items()}`)."""
    dev = resolve_device(device)
    return loopy.LoopyState(**{
        name: _t(fields[name], torch.bool if name == "node_mask" else dtype, dev)
        for name in loopy.LoopyState._fields
    })


def gm(mean, cov, logw, dtype=torch.float32, device="cuda"):
    """AoS GM from numpy: mean [..., K, 3], cov [..., K, 3, 3], logw [..., K]."""
    dev = resolve_device(device)
    return GM(_t(mean, dtype, dev), _t(cov, dtype, dev), _t(logw, dtype, dev))


def config(fields):
    """The port's Config from a mapping of a JAX Config's fields
    (`dataclasses.asdict(cfg)`): same names, arrays copied."""
    out = Config()
    for name, value in fields.items():
        if not hasattr(out, name):
            raise ValueError(f"Config has no field {name}")
        setattr(out, name, np.array(value) if isinstance(value, np.ndarray) else value)
    return out
