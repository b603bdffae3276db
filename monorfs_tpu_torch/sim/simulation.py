"""Headless simulation loop: couples a vehicle source with a navigator (the
torch twin of monorfs_tpu.sim.simulation; reference frame loop:
mono-rfs-lib/UI/Simulation.cs:498-723).

Per command the vehicle advances by the exact odometry, the navigator
consumes the noise-corrupted reading, and a measurement + SLAM update runs
every frame. In-band SLAM / mapping switches (the command element after the
odometry) collapse the particle set like StartSlam / StartMapping
(PHDNavigator.cs:214-236). The per-frame ancestry of the particle cloud is
recorded, so the best particle's full trajectory can be reconstructed for
estimate.out.

Algorithms: `phd`, `odometry`, `isam2` (graph backend, slam/isam2nav.py)
and `loopy` (offline smoother, slam/loopynav.py). Inputs: simulated,
replayed (a recording) and Kinect (an RGB-D source, frontend/kinect.py,
whose frames also become the recording's sidebar.avi). Models: PRM3D,
Linear2D, Linear1D and Kinect.

Randomness: the simulation owns a torch.Generator on its device, seeded with
`seed`; every frame's draws come from `draws.frame(i)`, by default a
GeneratorDraws over that generator. A Kinect run draws no vehicle noise
(the source is the vehicle), only the filter's. A caller may pass its own
`draws` (any object with frame(i) -> dict of tensors), e.g. to feed another
package's random numbers."""

import dataclasses
import io
import time
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device
from ..config import Config
from ..frontend.kinect import upload
from ..gm import mixture
from ..io import avi
from ..io.recording import Recording
from ..io.world import World
from ..models import get as get_model
from ..slam import loopy, phd
from ..spans import nested
from . import vehicle as vehicle_mod

DIRAC_COV = 0.001 * np.eye(3)
CHUNK = 50  # frames whose draws are made in one go
_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype):
    """torch.dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).name]


def model_for_config(cfg: Config, world: World):
    """The run's measurement model, with the world's measurer descriptor
    applied. A 10-value descriptor under PRM3D means the Kinect measurer
    (KinectMeasurer.cs:94-106)."""
    mp = world.measurer_params
    name = cfg.model
    if name == "PRM3D" and mp is not None and len(mp) == 10:
        name = "Kinect"
    model = get_model(name)
    if mp is not None:
        model = model.with_params(model.params.from_linear(mp))
    return model


def draw_frames(gen, n, landmarks, meas_dim, odo_dim, particles, max_clutter,
                clutter_count, dtype, device, vehicle=True):
    """Every random draw of n frames, made in bulk on the device, each
    tensor with a leading frame axis; without `vehicle` only the filter's
    (motion normals and resample uniforms)."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    if not vehicle:
        return dict(motion_normals=torch.randn((n, particles, odo_dim), **kw),
                    resample_u=torch.rand((n,), **kw))
    return dict(
        odo_normals=torch.randn((n, odo_dim), **kw),
        detect_u=torch.rand((n, landmarks), **kw),
        meas_normals=torch.randn((n, landmarks, meas_dim), **kw),
        clutter_draw=torch.poisson(clutter_count.expand(n), generator=gen),
        clutter_u=torch.rand((n, max_clutter, meas_dim), **kw),
        motion_normals=torch.randn((n, particles, odo_dim), **kw),
        resample_u=torch.rand((n,), **kw),
    )


class GeneratorDraws:
    """Per-frame draws from a torch.Generator, made CHUNK frames at a time."""

    def __init__(self, gen, **shape):
        self.gen, self.shape = gen, shape
        self.start, self.chunk = 0, None

    def frame(self, i):
        if self.chunk is None or not self.start <= i < self.start + CHUNK:
            self.start = i
            self.chunk = draw_frames(self.gen, CHUNK, **self.shape)
        return {name: t[i - self.start] for name, t in self.chunk.items()}


class Simulation:
    """Headless vehicle + navigator run."""

    def __init__(
        self,
        cfg: Config,
        world: World,
        commands: List[np.ndarray],
        algorithm: str = "phd",
        particles: int = 200,
        onlymapping: bool = False,
        dtype=torch.float64,
        phd_config: Optional[phd.PHDConfig] = None,
        seed: int = 0,
        collect_history: bool = True,
        replay=None,
        kinect_source=None,
        device="cuda",
        draws=None,
    ):
        """With `replay` (a Recording) the vehicle becomes a RecordVehicle
        (RecordVehicle.cs:64-349): the true trajectory, the noisy odometry
        and the measurement sets come from the recording, so different
        algorithms can be solved against identical data."""
        if algorithm not in ("phd", "odometry", "isam2", "loopy"):
            raise ValueError(f"unknown algorithm {algorithm}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.world = world
        self.replay = replay
        self.kinect = kinect_source
        if replay is not None and not commands:
            commands = [r for _, r in replay.odometry]
        if kinect_source is not None and not commands:
            odo = {"PRM3D": 6, "Linear2D": 2, "Linear1D": 1}[cfg.model]
            commands = [np.zeros(odo)] * len(kinect_source.dataset)
        self.commands = commands
        self.algorithm = algorithm
        self.dtype = torch_dtype(dtype)
        self.collect_history = collect_history
        self.model = model_for_config(cfg, world)
        self.onlymapping = onlymapping

        lmax = max(len(world.landmarks), 1)
        self.max_clutter = 8
        self.max_meas = lmax + self.max_clutter
        if kinect_source is not None:
            self.max_meas = 64  # the vision keypoint budget of a frame
        self.phd_cfg = phd_config or phd.PHDConfig(
            num_particles=particles,
            max_components=cfg.max_quantity,
            max_measurements=self.max_meas,
            **cfg.phd_budget(),
        )
        self.particles = particles

        dev, dt = self.device, self.dtype
        self.vparams = vehicle_mod.make_params(self.model, cfg, dt, dev)
        self.nparams = cfg.phd_params(dt, dev)

        lm = np.zeros((lmax, 3))
        lm[: len(world.landmarks)] = world.landmarks
        self.vstate = vehicle_mod.VehicleState(
            pose=self._tensor(world.pose),
            landmarks=self._tensor(lm),
            landmark_mask=torch.as_tensor(np.arange(lmax) < len(world.landmarks), device=dev),
        )

        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.draws = draws or GeneratorDraws(
            self.generator, landmarks=lmax, meas_dim=self.model.meas_dim,
            odo_dim=self.model.pose.odo_dim, particles=particles,
            max_clutter=self.max_clutter, clutter_count=self.vparams.clutter_count,
            dtype=dt, device=dev, vehicle=kinect_source is None,
        )
        self._build_navigator()

        # histories (host side)
        self.waypoints = []  # (t, true pose)
        self.way_odometry = []  # (t, noisy odometry)
        self.way_measurements = []  # (t, [z])
        self.way_sightings = []  # (t, [true label per z])
        self.way_maps = []  # (t, [(w, mean, cov)])
        self.way_vismaps = []  # (t, [(w, mean, cov)])
        self.frames = []  # per-frame dict: poses [P, S], parents [P], best
        self.sidebar_frames = []  # sensor-view JPEG payloads (Kinect runs), encoded at capture
        self.tags = []
        self.time = 0.0
        self.frame_index = 0
        self.reads = 0  # device-to-host reads of the frame path (_host), each a wait for the device

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype, device=self.device)

    def _host(self, x):
        """x as a numpy array on the host, counted in `reads`."""
        self.reads += 1
        return x.detach().cpu().numpy()

    # ------------------------------------------------------------------

    def _build_navigator(self):
        model = self.model
        if self.algorithm == "phd":
            self._step_slam = phd.make_slam_step(model, self.phd_cfg, slam=True)
            self._step_mapping = phd.make_slam_step(model, self.phd_cfg, slam=False)
            self.nstate = phd.init_state(
                model,
                dataclasses.replace(self.phd_cfg, num_particles=self.particles),
                self.world.pose,
                self.dtype,
                self.device,
            )
        elif self.algorithm == "isam2":
            from ..slam.isam2nav import ISAM2Navigator

            self.isam2 = ISAM2Navigator(
                model,
                self.cfg,
                np.asarray(self.world.pose, np.float64),
                max_poses=len(self.commands) + 2,
                max_landmarks=(256 if self.kinect is not None
                               else max(4 * len(self.world.landmarks), 64)),
                meas_per_frame=self.max_meas,
                onlymapping=self.onlymapping,
                device=self.device,
            )
        elif self.algorithm == "loopy":
            # offline smoother: the navigator is built in run(), from an
            # inner run's estimate (LoopyPHDNavigator.cs:223-246)
            self.loopy = None
        else:  # odometry
            self.nav_pose = self._tensor(self.world.pose)
        self.mode_mapping = self.onlymapping

    def _vehicle_frame(self, draws):
        """Advance the vehicle and sample (or replay, or see) a measurement set."""
        if self.kinect is not None:
            return self._kinect_frame()
        if self.replay is not None:
            return self._replay_frame()
        reading = self._tensor(self.current_command[: self.model.pose.odo_dim])
        self.vstate, noisy = vehicle_mod.update(
            self.model, self.vparams, self.vstate, reading, draws["odo_normals"]
        )
        z, mask, labels, visible, detected = vehicle_mod.measure(
            self.model, self.vparams, self.vstate, draws["detect_u"], draws["meas_normals"],
            draws["clutter_draw"], draws["clutter_u"], self.max_clutter,
        )
        if not self.cfg.use_odometry:
            noisy = torch.zeros_like(noisy)
        return noisy, z, mask, labels, visible, detected

    def _kinect_frame(self):
        """An RGB-D frontend frame (KinectVehicle.Measure, KinectVehicle.cs:301-344):
        measurements from the vision pipeline, no ground-truth pose, the
        odometry from the command stream; a depth-occlusion model gets the
        frame's depth map, uploaded without blocking the host."""
        zs, depth = self.kinect.measure(self.frame_index)
        self._sidebar_frame(depth, zs)
        if self.model.uses_depth:
            self.nparams = self.nparams._replace(depth_map=upload(depth, self.device, self.dtype))
        d = self.model.meas_dim
        z = np.zeros((self.max_meas, d))
        n = min(len(zs), self.max_meas)
        z[:n] = zs[:n, :d]
        mask = np.arange(self.max_meas) < n
        noisy = np.asarray(self.current_command[: self.model.pose.odo_dim], np.float64)
        lmax = self.vstate.landmarks.shape[0]
        none = torch.zeros(lmax, dtype=torch.bool, device=self.device)
        dev, dt = self.device, self.dtype
        return upload(noisy, dev, dt), upload(z, dev, dt), upload(mask, dev), None, none, none

    def _sidebar_frame(self, depth, zs):
        """One sensor-view frame: the normalised depth with the accepted
        keypoints marked (the reference draws the same overlay,
        KinectVehicle.cs:789-858), JPEG-encoded for the recording's
        sidebar.avi."""
        d = np.asarray(depth, np.float32)
        lo, hi = float(d.min()), float(d.max())
        img = ((d - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
        rgb = np.stack([img, img, img], axis=-1)
        h, w = img.shape
        for px, py, _ in np.asarray(zs).reshape(-1, 3):
            x, y = int(px + w / 2), int(py + h / 2)
            if 1 <= x < w - 1 and 1 <= y < h - 1:
                rgb[y - 1:y + 2, x - 1:x + 2] = (255, 64, 64)
        self.sidebar_frames.append(avi.jpeg_encode(rgb, quality=self.cfg.sidebar_jpeg_quality)[0])

    def _sidebar_avi(self):
        if not self.sidebar_frames:
            return b""
        buf = io.BytesIO()
        fps = max(int(round(1.0 / max(self.cfg.measure_elapsed, 1e-3))), 1)
        avi.write_mjpeg(buf, self.sidebar_frames, fps=fps)
        return buf.getvalue()

    def _replay_frame(self):
        """RecordVehicle playback (RecordVehicle.cs:150-240): pose from the
        recorded groundtruth, odometry and measurements as recorded."""
        i = self.frame_index
        rec = self.replay
        noisy = self._tensor(rec.odometry[i][1])
        self.vstate = self.vstate._replace(pose=self._tensor(rec.trajectory[i][1]))
        zs = rec.measurements[i][1] if i < len(rec.measurements) else []
        d = self.model.meas_dim
        z = np.zeros((self.max_meas, d))
        for k, zi in enumerate(zs[: self.max_meas]):
            z[k] = zi[:d]
        mask = np.arange(self.max_meas) < len(zs)
        # true association labels recorded with the run (sightings.out)
        labels = None
        if i < len(rec.sightings):
            ls = rec.sightings[i][1]
            labels = np.full(self.max_meas, vehicle_mod.CLUTTER_LABEL, np.int64)
            labels[: len(ls)] = ls[: self.max_meas]
            labels = torch.as_tensor(labels, device=self.device)
        lmax = self.vstate.landmarks.shape[0]
        none = torch.zeros(lmax, dtype=torch.bool, device=self.device)
        if not self.cfg.use_odometry:
            noisy = torch.zeros_like(noisy)
        return noisy, self._tensor(z), torch.as_tensor(mask, device=self.device), labels, none, none

    def _collapse(self):
        """StartSlam / StartMapping particle collapse (PHDNavigator.cs:214-236):
        every particle resets to the reference pose and the best particle's
        map."""
        best = int(self._host(self.nstate.best))
        p = self.particles
        lw = self.nstate.logweight
        self.nstate = phd.PHDState(
            pose=self.vstate.pose.expand(p, -1).clone(),
            logweight=torch.full_like(lw, -float(np.log(p))),
            maps=mixture.map_soa(lambda a: a[best].expand(a.shape).clone(), self.nstate.maps),
            best=torch.zeros((), dtype=torch.int64, device=self.device),
            ancestor=torch.full((p,), best, dtype=torch.int64, device=self.device),
        )

    def step(self, command: np.ndarray):
        """One frame."""
        odo_dim = self.model.pose.odo_dim
        self.current_command = command
        self.time += self.cfg.measure_elapsed
        t = self.time

        # in-band mode switches (Simulation.cs:575-634)
        if len(command) > odo_dim and self.algorithm == "phd":
            flag = command[odo_dim]
            if flag > 0 and self.mode_mapping:
                self.tags.append((t, "SLAM mode on"))
                self._collapse()
                self.mode_mapping = False
            elif flag < 0 and not self.mode_mapping:
                self.tags.append((t, "Mapping mode on"))
                self._collapse()
                self.mode_mapping = True

        with record_function("vehicle"):
            draws = self.draws.frame(self.frame_index)
            noisy, z, mask, labels, visible, detected = self._vehicle_frame(draws)

        if self.algorithm == "phd":
            step = self._step_mapping if self.mode_mapping else self._step_slam
            self.nstate = step(
                self.nparams, self.nstate, noisy, z[:, : self.model.meas_dim], mask,
                draws["motion_normals"], draws["resample_u"], true_pose=self.vstate.pose,
            )
        elif self.algorithm == "isam2":
            live = self._host(mask)
            self.isam2.predict(self._host(noisy), self._host(self.vstate.pose))
            zs = self._host(z)[live][:, : self.model.meas_dim]
            true_labels = self._host(labels)[live] if labels is not None else None
            self.isam2.slam_update(list(zs), true_labels)
        elif self.mode_mapping:
            self.nav_pose = self.vstate.pose
        else:
            self.nav_pose = self.model.pose.add_odometry(self.nav_pose, noisy)

        if self.collect_history:
            with record_function("record"):
                self._record(t, noisy, z, mask, labels, visible, detected)
        self.frame_index += 1

    def _record(self, t, noisy, z, mask, labels, visible, detected):
        """Append this frame to the host-side histories: the true pose, the
        reading, the measurements, and for `phd` the best particle's map and
        every pose. Its reads of device tensors come first, in the span
        `record.read`, whose host time is the wait for the frame's device work
        and the copies."""
        host = self._host
        replayed = self.replay is not None
        with nested("record.read"):
            pose, odo, live, zs = host(self.vstate.pose), host(noisy), host(mask), host(z)
            lab = host(labels) if labels is not None else None
            if not replayed:
                lms, vis, det = host(self.vstate.landmarks), host(visible), host(detected)
            if self.algorithm == "phd":
                best = int(host(self.nstate.best))
                leaves = host(torch.stack([leaf[best] for leaf in self.nstate.maps]))  # [10, K]
                poses, parents = host(self.nstate.pose), host(self.nstate.ancestor)
            elif self.algorithm != "isam2":
                nav = host(self.nav_pose)

        self.waypoints.append((t, pose.copy()))
        self.way_odometry.append((t, odo.copy()))
        zs = zs[live]
        self.way_measurements.append((t, [zi[: self.model.meas_dim] for zi in zs]))
        if lab is not None:
            self.way_sightings.append((t, [int(l) for l in lab[live]]))

        if replayed:
            # carry the recorded groundtruth visibility through
            i = self.frame_index
            self.way_vismaps.append(
                self.replay.vismaps[i] if i < len(self.replay.vismaps) else (t, [])
            )
        else:
            self.way_vismaps.append(
                (t, [(1.0 if det[i] else 0.0, lms[i], DIRAC_COV) for i in range(len(lms)) if vis[i]])
            )

        if self.algorithm == "phd":
            logw = leaves[9]
            mean_b = leaves[0:3].T
            cxx, cxy, cxz, cyy, cyz, czz = leaves[3:9]
            cov_b = np.stack([cxx, cxy, cxz, cxy, cyy, cyz, cxz, cyz, czz], -1).reshape(-1, 3, 3)
            comps = [
                (float(np.exp(logw[i])), mean_b[i], cov_b[i])
                for i in np.nonzero(logw > mixture.ALIVE_THRESHOLD)[0]
            ]
            self.way_maps.append((t, comps))
            self.frames.append({"poses": poses.copy(), "best": best, "parents": parents.copy()})
        elif self.algorithm == "isam2":
            means, covs = self.isam2.map_estimate
            self.way_maps.append((t, [(1.0, means[i], covs[i]) for i in range(len(means))]))
            self.frames.append({"poses": self.isam2.pose[None, :].copy(), "best": 0})
        else:
            self.way_maps.append((t, []))
            self.frames.append({"poses": nav[None, :].copy(), "best": 0})

    def run(self, progress=False, checkpoint_file=None, abort_flag=None):
        """Run all frames. With `checkpoint_file` the full recording is
        rewritten every CheckpointCycleTime seconds (Simulation.cs:500-510);
        `abort_flag` (a mutable [bool]) stops gracefully mid-run (the SIGINT
        path, Program.cs:65-87)."""
        if self.algorithm == "loopy":
            return self._run_loopy(progress)
        last_checkpoint = time.time()
        for i, cmd in enumerate(self.commands):
            if abort_flag is not None and abort_flag[0]:
                print("aborted; saving progress", flush=True)
                break
            self.step(cmd)
            if progress and (i + 1) % 50 == 0:
                print(f"{i + 1}/{len(self.commands)}", flush=True)
            if checkpoint_file and time.time() - last_checkpoint > self.cfg.checkpoint_cycle_time:
                self.save(checkpoint_file)
                last_checkpoint = time.time()
        return self

    def _run_loopy(self, progress=False):
        """The offline smoother: the initial estimate is the replayed
        recording's own estimate where it has one (the reference reads its
        "Loopy PHD initialization data from file", Simulation.cs:317-321,
        :360-366), else an inner PHD run's; then the sweeps. The recording
        gets the inner run's ground truth, the smoothed trajectory and the
        map filtered over it, frame by frame."""
        from ..slam.loopynav import LoopyPHDNavigator

        use_recorded = self.replay is not None and bool(self.replay.estimate)
        inner = Simulation(
            self.cfg, self.world, self.commands,
            algorithm="odometry" if use_recorded else "phd",
            particles=self.particles, onlymapping=self.onlymapping, dtype=self.dtype,
            phd_config=self.phd_cfg, replay=self.replay, device=self.device,
        )
        inner.run(progress=progress)
        if use_recorded:
            est_traj = [v for _, v in self.replay.estimate[-1][1]]  # the last snapshot
        else:
            est_traj = [f["poses"][f["best"]] for f in inner.frames]
        odometry = [o for _, o in inner.way_odometry]
        meas = [zs for _, zs in inner.way_measurements]
        t = len(est_traj)
        self.loopy = LoopyPHDNavigator(
            self.model, self.cfg, np.array(est_traj), odometry, meas, max_meas=self.max_meas,
            dtype=self.dtype, device=self.device,
            loopy_cfg=loopy.LoopyConfig(max_nodes=t, max_meas=self.max_meas),
        )
        # the sequential refit, then LoopySweeps - 1 Jacobi sweeps
        for s in range(self.cfg.loopy_sweeps):
            self.loopy.sweep()
            if progress:
                print(f"sweep {s + 1}/{self.cfg.loopy_sweeps}", flush=True)

        # ground-truth streams from the inner run; estimate and maps from the
        # smoother, the map history filtered over the final trajectory
        self.waypoints = inner.waypoints
        self.way_odometry = inner.way_odometry
        self.way_measurements = inner.way_measurements
        self.way_vismaps = inner.way_vismaps
        self.tags = inner.tags
        traj = self.loopy.trajectory
        self.frames = [{"poses": traj[i][None, :], "best": 0} for i in range(len(traj))]
        hist = self.loopy.map_history()
        self.way_maps = [
            (t, hist[i] if i < len(hist) else (hist[-1] if hist else []))
            for i, (t, _) in enumerate(inner.way_maps)
        ]
        return self

    # ------------------------------------------------------------------

    def estimate_history(self):
        """(time, best-particle trajectory) per frame: the exact
        clone-on-resample genealogy.

        The reference clones each particle's WayPoints on resample
        (Vehicle.cs:117-127; ResampleParticles, PHDNavigator.cs:724-760), so
        frame t's estimate is the best particle's full inherited pose
        history. The per-frame ancestor indices reproduce it: walk parents
        backward from the best particle of each frame, taking at each
        earlier frame the pose stored under the ancestor chain."""
        times = [w[0] for w in self.waypoints]
        out = []
        for i, frame in enumerate(self.frames):
            idx = frame["best"]
            traj = [None] * (i + 1)
            for s in range(i, -1, -1):
                fs = self.frames[s]
                traj[s] = (times[s], fs["poses"][idx])
                idx = fs.get("parents", np.arange(len(fs["poses"])))[idx]
            out.append((times[i], traj))
        return out

    def to_recording(self) -> Recording:
        return Recording(
            world=World(
                pose=np.asarray(self.world.pose),
                landmarks=np.asarray(self.world.landmarks),
                measurer_params=np.asarray(self.model.params.to_linear()),
            ),
            trajectory=self.waypoints,
            odometry=self.way_odometry,
            estimate=self.estimate_history(),
            maps=self.way_maps,
            vismaps=self.way_vismaps,
            measurements=self.way_measurements,
            tags=self.tags,
            config_text=self.cfg.to_descriptor(),
            sightings=self.way_sightings,
            sidebar=self._sidebar_avi(),
        )

    def save(self, filename):
        self.to_recording().save(filename)
