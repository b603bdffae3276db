"""The port's Kinect path against the JAX package's on the same seeded
inputs: the depth-occlusion model (models/kinect_model.py) and the Model
accessors, one make_slam_step frame with the Kinect model (the fused stage
off, the beam on), KinectSource.measure, and a small Simulation(kinect_source=
...) run with `-a isam2`.

Randomness: the port's RANSAC takes its sample rows from a `draw` callable;
here torch_parity.JaxDraws replays the JAX source's own key chain, so both
packages keep the same keypoints. The step gets JAX's own motion normals and
resample uniform, as tests/test_torch_phd_xla.py does.

Two decisions are not determined by float32 arithmetic, and may differ
between the packages: a LATCH bit whose two SSDs tie within rounding
(torch_parity.LATCH_TIE_RTOL), and a RANSAC hypothesis whose unnormalised
four-point DLT system has no float32-determined null vector (a repeated or
nearly collinear sample; torch_parity.DLT_ILL_CONDITIONED), on which the two
SVD implementations give other homographies. The source tests check every
frame's descriptors and inlier masks against the JAX package's on the same
inputs (the same keypoints; differing bits only at ties; differing
hypothesis counts only on ill-conditioned samples) and go on with the JAX
ones (torch_parity.FollowJaxTies, FollowJaxRansac), so one such decision
does not fork the runs.

Tolerances: the model's functions to 1e-12 in float64 and 1e-6 in float32
(visibility flags exactly); the step in float64 to 1e-9 slot for slot, in
float32 the fused-stage component-set tolerances; measurements to 1e-5; the
isam2 trajectory to 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.frontend.dataset import RGBDDataset as JDataset
from monorfs_tpu.frontend.dataset import synthesize_rgbd_parallax
from monorfs_tpu.frontend.kinect import KinectSource as JSource
from monorfs_tpu.io import World as JWorld
from monorfs_tpu.models import get as jget
from monorfs_tpu.models import kinect_model as jkm
from monorfs_tpu.sim import Simulation as JSimulation
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.frontend import latch as tlatch
from monorfs_tpu_torch.frontend import matching as tmatching
from monorfs_tpu_torch.frontend.dataset import RGBDDataset
from monorfs_tpu_torch.frontend.kinect import KinectSource
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.io import World
from monorfs_tpu_torch.models import get as tget
from monorfs_tpu_torch.models import kinect_model as tkm
from monorfs_tpu_torch.sim import Simulation
from monorfs_tpu_torch.sim.simulation import model_for_config
from monorfs_tpu_torch.slam import beam_kernel, fused_kernel, phd

from torch_parity import (FollowJaxRansac, FollowJaxTies, JaxDraws, assert_sets_close, np_,
                          random_state)

DTYPES = [(jnp.float32, torch.float32, 1e-6), (jnp.float64, torch.float64, 1e-12)]


def _depth_map(h=48, w=64, seed=0):
    """A wall at 1.4 m with a near box, a hole of NaN and a zero-depth strip."""
    rng = np.random.default_rng(seed)
    d = np.full((h, w), 1.4) + rng.normal(0, 0.01, (h, w))
    d[10:30, 20:40] = 0.7
    d[35:42, 5:15] = np.nan
    d[:, -3:] = 0.0
    return d


def _measurements(n=400, seed=1, res=(64.0, 48.0)):
    """Pixel-range measurements over and beyond the image and range limits."""
    rng = np.random.default_rng(seed)
    z = np.column_stack([rng.uniform(-0.7, 0.7, n) * res[0], rng.uniform(-0.7, 0.7, n) * res[1],
                         rng.uniform(0.0, 2.2, n)])
    z[:4, :2] = [[-32.0, -24.0], [31.9, 23.9], [-40.0, 30.0], [0.0, 0.0]]  # edges, outside, centre
    return z


PARAMS = dict(focal=57.58, film_left=-32.0, film_top=-24.0, film_width=64.0, film_height=48.0,
              range_min=0.1, range_max=2.0, res_x=64.0, res_y=48.0, border=2)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_kinect_model_functions(jdt, tdt, tol):
    jp, tp = jkm.Params(**PARAMS), tkm.Params(**PARAMS)
    depth, z = _depth_map(), _measurements()
    jd, jz = jnp.asarray(depth, jdt), jnp.asarray(z, jdt)
    td, tz = torch.tensor(depth, dtype=tdt), torch.tensor(z, dtype=tdt)
    ramp = np.array([3.0, 3.0, 0.05])
    jr, tr = jnp.asarray(ramp, jdt), torch.tensor(ramp, dtype=tdt)

    np.testing.assert_array_equal(tkm._depth_at(tp, tz, td).numpy(), np_(jkm._depth_at(jp, jz, jd)))
    np.testing.assert_array_equal(tkm.visible(tp, tz, td).numpy(), np_(jkm.visible(jp, jz, jd)))
    fv = tkm.fuzzy_visible(tp, tz, tr, td).numpy()
    np.testing.assert_allclose(fv, np_(jkm.fuzzy_visible(jp, jz, jr, jd)), rtol=tol, atol=tol)
    zl_j, zl_t = [jz[:, i].reshape(20, 20) for i in range(3)], [tz[:, i].reshape(20, 20) for i in range(3)]
    soa = tkm.fuzzy_visible_soa(tp, zl_t, tr, td).numpy()
    np.testing.assert_allclose(soa, np_(jkm.fuzzy_visible_soa(jp, zl_j, jr, jd)), rtol=tol, atol=tol)
    np.testing.assert_array_equal(soa.reshape(-1), fv)
    # every branch is reached: hidden behind the box, in the NaN hole, ramped, fully visible
    assert (fv == 0).any() and (fv == 1).any() and ((fv > 0) & (fv < 1)).any()
    assert tkm._depth_at(tp, tz, td).isnan().any()

    # descriptor round trip and the model's accessors
    assert tkm.Params.from_linear(tp.to_linear()) == tp
    assert tkm.Params.from_linear(tp.to_linear()[:7]) == tkm.Params(**{**PARAMS, "res_x": 640.0,
                                                                        "res_y": 480.0, "border": 24})
    jm, tm = jget("Kinect").with_params(jp), tget("Kinect").with_params(tp)
    assert tm.uses_depth and jm.uses_depth
    np.testing.assert_allclose(tm.fuzzy_visible_fn(td)(tp, tz, tr).numpy(),
                               np_(jm.fuzzy_visible_fn(jd)(jp, jz, jr)), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tm.visible_fn(td)(tp, tz).numpy(), np_(jm.visible_fn(jd)(jp, jz)))
    # no map: frustum visibility alone
    np.testing.assert_array_equal(tm.visible_fn()(tp, tz).numpy(), np_(jm.visible_fn()(jp, jz)))
    np.testing.assert_allclose(tm.fuzzy_visible_soa_fn(td)(tp, zl_t, tr).numpy(), soa)


def test_accessors_ignore_the_map_without_depth():
    """A model without depth occlusion gets its own functions back, so its
    results are bit-identical whatever map is bound."""
    dm = torch.zeros((3, 3))
    for name in ("PRM3D", "Linear2D", "Linear1D"):
        m = tget(name)
        assert not m.uses_depth
        assert m.fuzzy_visible_fn(dm) is m.fuzzy_visible and m.visible_fn(dm) is m.visible
        assert m.fuzzy_visible_soa_fn(dm) is m.fuzzy_visible_soa is m.fuzzy_visible_soa_fn()
    cfg = Config()
    p = cfg.phd_params(torch.float64, "cpu")
    assert p.depth_map.shape == (1, 1) and torch.isinf(p.depth_map).all()


def test_model_for_config_picks_kinect():
    cam = tkm.Params(**PARAMS)
    world = World(pose=np.array([0, 0, 0, 1, 0, 0, 0.0]), landmarks=np.zeros((0, 3)),
                  measurer_params=np.asarray(cam.to_linear()))
    model = model_for_config(Config(), world)
    assert model.name == "Kinect" and model.params == cam
    world7 = dataclasses.replace(world, measurer_params=np.asarray(cam.to_linear()[:7]))
    assert model_for_config(Config(), world7).name == "PRM3D"


# ---- one filter step ---------------------------------------------------------------

STEP_CFG = dict(num_particles=4, max_components=20, max_measurements=12, gate_top=6,
                estimate_cap=16, beam_width=12, beam_candidates=4, merge_rounds=4)


def _step_inputs(jdt):
    """A warm PRM3D-like state, its measurements and a 480 x 640 depth map:
    a near wall over the right half, a NaN hole, a far wall elsewhere."""
    jm = jget("Kinect")
    pose, maps, z, z_mask = random_state(jm, 20, 12, 5, 4, n_lm=10, dtype=jdt)
    depth = np.full((480, 640), 1.9)
    depth[:, 320:] = 0.5  # hides the right half of the image
    depth[300:, :200] = np.nan
    return jm, pose, maps, z, z_mask, depth


@pytest.mark.parametrize("jdt,tdt", [(jnp.float64, torch.float64), (jnp.float32, torch.float32)])
def test_step_with_kinect_model(jdt, tdt, monkeypatch):
    jm, pose, maps, z, z_mask, depth = _step_inputs(jdt)
    tm = tget("Kinect")
    jc = JConfig()
    jp = jc.phd_params(jdt)._replace(depth_map=jnp.asarray(depth, jdt))
    tp = convert.phd_params({k: np_(v) for k, v in jp._asdict().items()}, tdt, "cpu")
    assert tp.depth_map.shape == (480, 640)
    jcfg, tcfg = jphd.PHDConfig(**STEP_CFG), phd.PHDConfig(**STEP_CFG)
    p = STEP_CFG["num_particles"]
    jstate = jphd.PHDState(pose, jnp.full((p,), -np.log(p), jdt), maps, jnp.int32(0), jnp.arange(p, dtype=jnp.int32))
    tstate = phd.PHDState(torch.tensor(np_(pose), dtype=tdt), torch.full((p,), -float(np.log(p)), dtype=tdt),
                          SGM(*[torch.tensor(np_(x), dtype=tdt) for x in maps]),
                          torch.zeros((), dtype=torch.int64), torch.arange(p))
    key = jax.random.PRNGKey(3)
    kmotion, kresample = jax.random.split(key)
    normals = np_(jax.random.normal(kmotion, (p, 6), jdt))
    u = np_(jax.random.uniform(kresample, (), jdt))
    odo = np.array([0.002, 0.0, 0.001, 0.0, 0.001, 0.0])
    jstep = jax.jit(jphd.make_slam_step(jm, jcfg, pallas_beam=False, pallas_correct=False))
    jout = jstep(jp, jstate, jnp.asarray(odo, jdt), z, z_mask, key)

    # kernels=None: the fused stage stays off for the depth model, the beam
    # wrapper runs for float32 (its plain version on the CPU)
    calls = {"fused": 0, "beam": 0}
    real_beam = beam_kernel.beam_scan_batch

    def beam_spy(*a):
        calls["beam"] += 1
        return real_beam(*a)

    def fused_spy(*a, **k):
        calls["fused"] += 1
        raise AssertionError("the fused stage ran for a depth-occlusion model")

    monkeypatch.setattr(beam_kernel, "beam_scan_batch", beam_spy)
    monkeypatch.setattr(fused_kernel, "fused_stage", fused_spy)
    tstep = phd.make_slam_step(tm, tcfg)
    tout = tstep(tp, tstate, torch.tensor(odo, dtype=tdt), torch.tensor(np_(z), dtype=tdt),
                 torch.tensor(np_(z_mask)), torch.tensor(normals, dtype=tdt), torch.tensor(u, dtype=tdt))
    assert calls == {"fused": 0, "beam": int(tdt == torch.float32)}
    tref = phd.make_slam_step(tm, tcfg, kernels=False)(
        tp, tstate, torch.tensor(odo, dtype=tdt), torch.tensor(np_(z), dtype=tdt), torch.tensor(np_(z_mask)),
        torch.tensor(normals, dtype=tdt), torch.tensor(u, dtype=tdt))
    for a, b in zip(list(tout.maps) + [tout.pose, tout.logweight], list(tref.maps) + [tref.pose, tref.logweight]):
        assert torch.equal(a, b)

    tol = 1e-9 if tdt == torch.float64 else 2e-5
    np.testing.assert_allclose(tout.pose.numpy(), np_(jout.pose), rtol=0, atol=tol)
    np.testing.assert_allclose(tout.logweight.numpy(), np_(jout.logweight), rtol=0,
                               atol=tol if tdt == torch.float64 else 1e-3)
    if tdt == torch.float64:
        for name, a, b in zip(SGM._fields, jout.maps, tout.maps):
            np.testing.assert_allclose(b.numpy(), np_(a), rtol=1e-9, atol=1e-9, err_msg=name)
    else:
        assert_sets_close(jout.maps, tout.maps, p)
    # the depth map changed the result: the same step with a far wall differs
    far = phd.make_slam_step(tm, tcfg, kernels=False)(
        tp._replace(depth_map=torch.full((1, 1), float("inf"), dtype=tdt)), tstate,
        torch.tensor(odo, dtype=tdt), torch.tensor(np_(z), dtype=tdt), torch.tensor(np_(z_mask)),
        torch.tensor(normals, dtype=tdt), torch.tensor(u, dtype=tdt))
    assert not torch.equal(far.maps.logw, tref.maps.logw)


def test_kernels_true_refuses_depth_model():
    jm, pose, maps, z, z_mask, depth = _step_inputs(jnp.float32)
    tm = tget("Kinect")
    tcfg = phd.PHDConfig(**STEP_CFG)
    tp = Config().phd_params(torch.float32, "cpu")
    state = phd.init_state(tm, tcfg, np.array([0, 0, 0, 1, 0, 0, 0.0]), torch.float32, "cpu")
    with pytest.raises(ValueError, match="depth-occlusion"):
        phd.make_slam_step(tm, tcfg, kernels=True)(
            tp, state, torch.zeros(6), torch.tensor(np_(z), dtype=torch.float32), torch.tensor(np_(z_mask)),
            torch.zeros((4, 6)), torch.tensor(0.5))
    assert phd.route(tm, torch.float32).correct is phd.xla_stage
    assert phd.route(tget("PRM3D"), torch.float32).correct is fused_kernel.fused_stage
    assert phd.route(tget("PRM3D"), torch.float64).correct is phd.xla_stage


def test_depth_rebinding_does_not_repack(monkeypatch):
    """The fused path packs its parameter vector once while only the depth
    map is re-bound (the Kinect input re-binds it every frame), and again
    when another field changes."""
    tm = tget("PRM3D")
    cfg = phd.PHDConfig(num_particles=2, max_components=16, max_measurements=6, estimate_cap=8,
                        beam_width=6, beam_candidates=3)
    packs = []
    real = fused_kernel.pack_params
    monkeypatch.setattr(fused_kernel, "pack_params", lambda m, p: packs.append(1) or real(m, p))
    step = phd.make_slam_step(tm, cfg)
    params = Config().phd_params(torch.float32, "cpu")
    state = phd.init_state(tm, cfg, np.array([0, 0, 0, 1, 0, 0, 0.0]), torch.float32, "cpu")
    z = torch.tensor([[10.0, -5.0, 1.0]] * 6)
    args = (torch.zeros(6), z, torch.arange(6) < 3, torch.zeros((2, 6)), torch.tensor(0.5))
    for i in range(3):
        params = params._replace(depth_map=torch.full((4, 4), float(i)))
        state = step(params, state, *args)
    assert len(packs) == 1
    step(params._replace(pd=params.pd.clone()), state, *args)
    assert len(packs) == 2


# ---- the source and the simulation ------------------------------------------------

def _camera(module, h, w, focal):
    return module.Params(focal=focal, film_left=-w / 2, film_top=-h / 2, film_width=w, film_height=h,
                         range_min=0.1, range_max=5.0, res_x=w, res_y=h, border=1)


def test_kinect_source_measure(tmp_path, monkeypatch):
    """Four frames of the parallax render through both sources with the same
    RANSAC draws: the same measurement counts and values, and the same
    subsampled depth."""
    path, _ = synthesize_rgbd_parallax(tmp_path / "par.npz", frames=4, h=96, w=128, focal=160.0, seed=2)
    jcam, tcam = _camera(jkm, 96, 128, 160.0), _camera(tkm, 96, 128, 160.0)
    jsrc = JSource(JDataset(path), camera=jcam, delta=1, max_keypoints=64, threshold=40.0)
    tsrc = KinectSource(RGBDDataset(path), camera=tcam, delta=1, max_keypoints=64, threshold=40.0,
                        device="cpu", draw=JaxDraws(0))
    ties, ransac = FollowJaxTies(jsrc, tlatch), FollowJaxRansac(tmatching)
    monkeypatch.setattr(tlatch, "describe", ties.describe)
    monkeypatch.setattr(tmatching, "ransac_homography", ransac)
    filtered = 0
    for i in range(4):
        jz, jd = jsrc.measure(i)
        tz, td = tsrc.measure(i)
        assert tz.shape == jz.shape and len(tz) > 4
        np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(td, jd)
        filtered += i > 0
    assert tsrc.reads == 4 and filtered == 3 == ransac.calls


def test_kinect_source_draws_on_its_own_generator(tmp_path):
    """Without injected draws the source samples from its own seeded
    generator: two sources with one seed agree, and every frame has
    measurements."""
    path, _ = synthesize_rgbd_parallax(tmp_path / "par.npz", frames=3, h=96, w=128, focal=160.0, seed=2)
    cam = _camera(tkm, 96, 128, 160.0)
    a, b = (KinectSource(RGBDDataset(path), camera=cam, delta=1, max_keypoints=64, threshold=40.0,
                         device="cpu", seed=5) for _ in range(2))
    for i in range(3):
        za, zb = a.measure(i)[0], b.measure(i)[0]
        np.testing.assert_array_equal(za, zb)
        assert len(za) > 0


def test_simulation_kinect_isam2(tmp_path, monkeypatch):
    """Simulation(kinect_source=...) -a isam2 in float64 over six 96 x 128
    frames of the parallax render (at 60 x 80 the extractor's 24-pixel
    border leaves one keypoint a frame and no landmark), against the JAX run:
    the trajectory to 1e-6, the map's size, the recording's sidebar and the
    filter's draws."""
    h, w, frames, focal = 96, 128, 6, 160.0
    path, _ = synthesize_rgbd_parallax(tmp_path / "par.npz", frames=frames, h=h, w=w, focal=focal, seed=2,
                                       travel=0.1)
    jcam, tcam = _camera(jkm, h, w, focal), _camera(tkm, h, w, focal)
    jsrc = JSource(JDataset(path), camera=jcam, delta=1, max_keypoints=64, threshold=40.0)
    tsrc = KinectSource(RGBDDataset(path), camera=tcam, delta=1, max_keypoints=64, threshold=40.0,
                        device="cpu", draw=JaxDraws(0))
    ties, ransac = FollowJaxTies(jsrc, tlatch), FollowJaxRansac(tmatching)
    monkeypatch.setattr(tlatch, "describe", ties.describe)
    monkeypatch.setattr(tmatching, "ransac_homography", ransac)
    jworld = JWorld(pose=np.array([0, 0, 0, 1, 0, 0, 0.0]), landmarks=np.zeros((0, 3)),
                    measurer_params=np.asarray(jcam.to_linear()))
    tworld = World(pose=jworld.pose, landmarks=jworld.landmarks, measurer_params=jworld.measurer_params)
    jcfg, tcfg = JConfig(), Config()
    for c in (jcfg, tcfg):
        c.motion_covariance = np.diag([10.0, 10, 10, 0.1, 0.1, 0.1])
    jsim = JSimulation(jcfg, jworld, [], algorithm="isam2", particles=1, kinect_source=jsrc,
                       dtype=np.float64).run()
    tsim = Simulation(tcfg, tworld, [], algorithm="isam2", particles=1, kinect_source=tsrc,
                      dtype=torch.float64, device="cpu").run()
    assert tsim.model.name == "Kinect" and tsim.max_meas == 64
    assert [len(m) for _, m in tsim.way_measurements] == [len(m) for _, m in jsim.way_measurements]
    np.testing.assert_allclose(tsim.isam2.trajectory, jsim.isam2.trajectory, rtol=0, atol=1e-6)
    assert tsim.isam2.lm_mask_np.sum() == jsim.isam2.lm_mask_np.sum() > 0
    assert np.abs(tsim.isam2.trajectory[-1, 0] - tsim.isam2.trajectory[1, 0]) > 0.03
    assert not ties.frames and ransac.calls == frames - 1
    assert len(tsim.sidebar_frames) == frames
    assert set(tsim.draws.frame(0)) == {"motion_normals", "resample_u"}  # no vehicle noise
    assert tsim._vehicle_runner is None and tsim.vehicle_captures == tsim.vehicle_replays == 0
