"""Known-label graph-SLAM replay as one loop on the device (the torch twin
of monorfs_tpu.slam.isam2_scan).

Counterpart of the reference's gtsam bridge driven headlessly
(isam2.cpp:199-246: per frame a BetweenFactor for the odometry delta plus
one PixelRangeFactor per labeled measurement, `isam.update`,
`calculateEstimate`). Data association is known-label (the reference's chap4
known-DA configuration, DataAssociationAlgorithm.Perfect), which removes the
host Hungarian, so the vehicle simulation and the graph solve stay on the
device for the whole run; the only flag read back per frame is the
Cholesky's status. The Mahalanobis-gated interactive frontend is
slam/isam2nav.py, its on-device twin slam/isam2_scan_da.py.

Per frame the step appends the new pose (dead-reckoned init, the bridge's
`predict`), writes the frame's measurement factors at a fixed stride (frame t
owns factor slots [(t-1)*M, t*M)), back-projects first sightings into
landmark inits (isam2.cpp:182-189), and re-runs `gn_iters` warm-started
Gauss-Newton iterations over the full fixed-capacity graph (slam/graph.py).
The factor arrays of the carry are written in place, frame after frame.

Randomness is injected: the runner takes the vehicle's draws for every frame
as tensors (`scan_draws` makes them in bulk from a torch.Generator on the
device).
"""

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..sim import vehicle as vehicle_mod
from ..sim.simulation import draw_frames, model_for_config, torch_dtype
from . import graph

DRAW_NAMES = ("odo_normals", "detect_u", "meas_normals", "clutter_draw", "clutter_u")


class ISAM2ScanCarry(NamedTuple):
    vstate: vehicle_mod.VehicleState
    gstate: graph.GraphState
    est_pose: torch.Tensor  # current pose estimate (dead-reckoning carrier)


def check_clutter_capacity(cfg, model, max_clutter):
    """A mis-sized replay must fail loudly, not truncate silently: the
    vehicle caps Poisson clutter at floor(10 * lambda)
    (SimulatedVehicle.cs:269-285); a scan whose static clutter slots are
    below that cap would quietly under-sample the cluttery configs."""
    lam = float(cfg.clutter_density) * float(model.volume(model.params))
    need = int(np.floor(10.0 * lam))
    if need > max_clutter:
        raise ValueError(
            f"max_clutter={max_clutter} cannot replay this config "
            f"faithfully: clutter rate lambda={lam:.3f} caps at "
            f"floor(10*lambda)={need} per frame; raise max_clutter"
        )


def scan_draws(model, cfg, world, frames, seed=0, dtype=torch.float32, max_clutter=8,
               device="cuda"):
    """The vehicle's draws of `frames` frames, each tensor with a leading
    frame axis, from a torch.Generator on the device seeded with `seed`."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    count = torch.as_tensor(
        cfg.clutter_density * float(model.volume(model.params)), dtype=dtype, device=dev
    )
    draws = draw_frames(
        gen, frames, landmarks=max(len(world.landmarks), 1), meas_dim=model.meas_dim,
        odo_dim=model.pose.odo_dim, particles=0, max_clutter=max_clutter,
        clutter_count=count, dtype=dtype, device=dev,
    )
    return {name: draws[name] for name in DRAW_NAMES}


def scan_setup(cfg, world, frames, dtype, max_clutter, max_landmarks, gn_iters, device):
    """What both scan runners share: the model, the vehicle's parameters and
    state, the graph's capacities, noise informations and empty state."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    model = model_for_config(cfg, world)
    lmax = max(len(world.landmarks), 1)
    check_clutter_capacity(cfg, model, max_clutter)
    m = lmax + max_clutter
    gcfg = graph.GraphConfig(
        max_poses=frames + 1, max_landmarks=max_landmarks or lmax, max_factors=frames * m,
        gn_iters=gn_iters, factors_per_pose=m,
    )

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=dev)

    vparams = vehicle_mod.make_params(model, cfg, dtype, dev)
    # diagonal noise like the reference bridge (ISAM2Navigator.cs:140-150)
    motion_sigma = cfg.measure_elapsed * np.sqrt(np.diag(cfg.motion_covariance))
    motion_info = t(np.diag(1.0 / motion_sigma**2))
    meas_info = t(np.diag(1.0 / np.diag(cfg.measurement_covariance)))
    meas_cov = t(cfg.measurement_covariance)

    lm = np.zeros((lmax, 3))
    lm[: len(world.landmarks)] = world.landmarks
    vstate = vehicle_mod.VehicleState(
        pose=t(world.pose),
        landmarks=t(lm),
        landmark_mask=torch.as_tensor(np.arange(lmax) < len(world.landmarks), device=dev),
    )
    gstate = graph.empty_state(model, gcfg, np.asarray(world.pose, np.float64), dtype, dev)
    return model, gcfg, m, vparams, vstate, gstate, (motion_info, meas_info, meas_cov)


@record_function("vehicle")
def vehicle_frame(model, vparams, vstate, command, draws, i, max_clutter):
    """Advance the true vehicle by frame i's command and measure."""
    vstate, noisy = vehicle_mod.update(model, vparams, vstate, command, draws["odo_normals"][i])
    z, mask, labels, _, _ = vehicle_mod.measure(
        model, vparams, vstate, draws["detect_u"][i], draws["meas_normals"][i],
        draws["clutter_draw"][i], draws["clutter_u"][i], max_clutter,
    )
    return vstate, noisy, z, mask, labels


def append_frame(model, st: graph.GraphState, m, pred, noisy, z, upd, labels):
    """Write frame t = st.n_poses into the graph, in place for the pose,
    between and factor arrays: the dead-reckoned pose, the odometry factor,
    the frame's M factor slots and the first-sighting landmark inits
    (isam2.cpp:182-189). `labels` are distinct wherever `upd` holds, so each
    init is written once; the others go to a slot that is cut off."""
    t = st.n_poses
    cap = st.landmarks.shape[0]
    safe = torch.clamp(labels, 0, cap - 1)
    backproj = model.to_map(model.params, pred[None, :], z)  # [M, 3]
    old = st.landmarks[safe]
    is_new = upd & ~st.lm_mask[safe]
    landmarks = torch.cat([st.landmarks, st.landmarks.new_zeros((1, 3))])
    landmarks[torch.where(is_new, safe, cap)] = old + (backproj - old)
    lm_mask = torch.cat([st.lm_mask, st.lm_mask.new_zeros((1,))])
    lm_mask.index_fill_(0, torch.where(upd, safe, cap), True)  # no host scalar is copied over

    base = (t - 1) * m
    st.poses[t] = pred
    st.between[t] = noisy
    st.between_mask[t].fill_(True)
    st.f_pose[base : base + m] = t
    st.f_lm[base : base + m] = safe
    st.f_z[base : base + m] = z.to(st.f_z.dtype)
    st.f_mask[base : base + m] = upd
    return st._replace(n_poses=t + 1, landmarks=landmarks[:cap], lm_mask=lm_mask[:cap])


def clone_carry(carry):
    """A deep copy, so that a run leaves the carry it started from intact."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[copy(v) for v in x])
        return x

    return copy(carry)


def build_isam2_scan_runner(cfg, world, frames, gn_iters=1, dtype=torch.float32, max_clutter=8,
                            device="cuda"):
    """Return (runner, init_carry, model). runner(carry, commands, draws)
    runs the vehicle + graph-SLAM frame pipeline over commands [N, O] with
    draws as scan_draws makes them; it returns the final carry and, per
    frame, (true_pose, estimated_pose)."""
    graph.assert_full_precision()
    model, gcfg, m, vparams, vstate, gstate, (motion_info, meas_info, _) = scan_setup(
        cfg, world, frames, dtype, max_clutter, None, gn_iters, device
    )

    def runner(carry: ISAM2ScanCarry, commands, draws):
        vstate, st, est = clone_carry(carry)
        n = commands.shape[0]
        true_poses = torch.zeros((n, st.poses.shape[1]), dtype=st.poses.dtype, device=st.poses.device)
        est_poses = torch.zeros_like(true_poses)
        for i in range(n):
            vstate, noisy, z, mask, labels = vehicle_frame(
                model, vparams, vstate, commands[i], draws, i, max_clutter
            )
            t = st.n_poses  # index of the pose this frame appends
            pred = model.pose.add_odometry(est, noisy)
            st = append_frame(model, st, m, pred, noisy, z, mask & (labels >= 0), labels)
            st = graph.gauss_newton(model, gcfg, st, motion_info, meas_info)
            est = st.poses[t]
            true_poses[i] = vstate.pose
            est_poses[i] = est
        return ISAM2ScanCarry(vstate, st, est), (true_poses, est_poses)

    init = ISAM2ScanCarry(vstate, gstate, vstate.pose.clone())
    return runner, init, model
