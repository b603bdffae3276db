"""The port's Simulation, command line and postanalysis against the JAX
package's.

Replay: the JAX Simulation makes a short Linear2D recording; both packages
then replay it (replay=) in float64 with 4 particles and a small PHDConfig,
the port fed JAX's own draws (the key splits of Simulation.step and
make_slam_step replayed). Per frame: every pose to 1e-9, best particle and
ancestry exact, the best map's component count exact and its weights to
1e-9. Then the command line on the CPU for 1D mapping and 2D SLAM, whose
recordings both packages' postanalysis read to the same numbers (1e-12:
the OSPA distance table is computed by torch in the port, by numpy in the
reference). Unsupported algorithms and inputs raise NotImplementedError
(the graph backend, `isam2`, has its own file: test_torch_isam2_scan.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu import postanalysis as jpost
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io import Recording as JRecording
from monorfs_tpu.io import World as JWorld
from monorfs_tpu.io import parse_commands as jparse
from monorfs_tpu.sim import Simulation as JSimulation
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import cli, postanalysis
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording, World, parse_commands
from monorfs_tpu_torch.sim import Simulation
from monorfs_tpu_torch.slam import phd

PHD = dict(num_particles=4, max_components=32, max_measurements=33, gate_top=8,
           estimate_cap=16, beam_width=16, beam_candidates=4, merge_rounds=4)
FRAMES = 10


def _configs():
    out = []
    for c in (JConfig(), Config()):
        c.set_linear2d_defaults()
        c.motion_covariance = np.diag([0.05, 0.05])
        c.min_effective_particle = 0.9  # so that the run resamples
        out.append(c)
    return out


class JaxDraws:
    """The navigator's draws as the JAX Simulation makes them in replay: one
    split of the run key per frame, then make_slam_step's own split."""

    def __init__(self, seed, particles, odo_dim):
        self.key, self.shape = jax.random.PRNGKey(seed), (particles, odo_dim)

    def frame(self, i):
        self.key, knav = jax.random.split(self.key)
        kmotion, kresample = jax.random.split(knav)
        return dict(
            motion_normals=torch.tensor(np.asarray(jax.random.normal(kmotion, self.shape, jnp.float64))),
            resample_u=torch.tensor(np.asarray(jax.random.uniform(kresample, (), jnp.float64))),
        )


def test_replay_matches_jax(tmp_path):
    jcfg, tcfg = _configs()
    commands = jparse(open("assets/mov2d.in").read())[:FRAMES]
    source = JSimulation(jcfg, JWorld.from_file("assets/linear2d.world"), commands, particles=4,
                         dtype=np.float64, phd_config=jphd.PHDConfig(**PHD), seed=1)
    source.run()
    source.save(tmp_path / "src.zip")
    jrec, trec = JRecording.load(tmp_path / "src.zip"), Recording.load(tmp_path / "src.zip")

    jsim = JSimulation(jcfg, jrec.world, [], particles=4, dtype=np.float64,
                       phd_config=jphd.PHDConfig(**PHD), seed=5, replay=jrec).run()
    tsim = Simulation(tcfg, trec.world, [], particles=4, dtype=torch.float64,
                      phd_config=phd.PHDConfig(**PHD), seed=5, replay=trec, device="cpu",
                      draws=JaxDraws(5, 4, 2)).run()
    assert len(tsim.frames) == len(jsim.frames) == FRAMES
    resampled = 0
    for jf, tf, (_, jmap), (_, tmap) in zip(jsim.frames, tsim.frames, jsim.way_maps, tsim.way_maps):
        np.testing.assert_allclose(tf["poses"], jf["poses"], rtol=0, atol=1e-9)
        assert tf["best"] == jf["best"]
        np.testing.assert_array_equal(tf["parents"], jf["parents"])
        assert len(tmap) == len(jmap)
        np.testing.assert_allclose(sorted(w for w, _, _ in tmap), sorted(w for w, _, _ in jmap),
                                   rtol=1e-9, atol=1e-9)
        resampled += int(not np.array_equal(jf["parents"], np.arange(4)))
    assert resampled > 0 and len(tsim.way_maps[-1][1]) > 0
    # the histories the recording is made of
    for (ta, pa), (tb, pb) in zip(tsim.waypoints, jsim.waypoints, strict=True):
        assert ta == tb
        np.testing.assert_array_equal(pa, pb)
    assert tsim.way_sightings == jsim.way_sightings
    jest, test_ = jsim.estimate_history(), tsim.estimate_history()
    for (_, ja), (_, ta) in zip(jest, test_, strict=True):
        np.testing.assert_allclose(np.array([s for _, s in ta]), np.array([s for _, s in ja]), atol=1e-9)
    tsim.save(tmp_path / "port.zip")
    assert len(JRecording.load(tmp_path / "port.zip").estimate) == FRAMES


def _same_analysis(record):
    jres = jpost.analyze(JRecording.load(record))
    tres = postanalysis.analyze(Recording.load(record), device="cpu")
    assert set(jres) == set(tres)
    for name in jres:
        assert len(jres[name]) == len(tres[name]), name
        np.testing.assert_allclose(np.array(tres[name], float), np.array(jres[name], float),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    return tres


@pytest.mark.parametrize("name,argv,frames", [
    ("1d-mapping", ["-f", "assets/linear1d.world", "-c", "assets/mov1d.in", "-a", "phd", "-y", "-p", "1"], 20),
    ("2d-slam", ["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "phd", "-p", "6"], 20),
    ("2d-slam-f64", ["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "phd", "-p", "3",
                     "--dtype", "float64"], 6),
])
def test_cli_then_postanalysis(tmp_path, capsys, name, argv, frames):
    record = tmp_path / f"{name}.zip"
    if name == "2d-slam":  # an explicit cfg file (-g) wins over the defaults
        (tmp_path / "run.cfg").write_text("Model: Linear2D\nMaxQuantity: 64\n")
        argv = argv + ["-g", str(tmp_path / "run.cfg")]
    assert cli.main(argv + ["--device", "cpu", "--frames", str(frames), "-r", str(record)]) == 0
    assert "finished running" in capsys.readouterr().out
    rec = Recording.load(record)
    assert len(rec.trajectory) == len(rec.estimate) == len(rec.maps) == frames
    embedded = Config().apply_descriptor(rec.config_text.splitlines())
    assert embedded.model == ("Linear1D" if name.startswith("1d") else "Linear2D")
    assert embedded.max_quantity == (64 if name == "2d-slam" else 600)
    res = _same_analysis(record)
    assert postanalysis.main(["-f", str(record), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ATE loc RMSE" in out and "final OSPA" in out
    assert (tmp_path / f"{name}.zip.map.data").exists()
    if name == "1d-mapping":
        assert max(v for _, v in res["loc"]) == 0.0  # poses snap to the truth
        assert res["size"][-1][1] >= 1
    # replaying the recording through dead reckoning integrates its odometry
    replay = tmp_path / "odo.zip"
    cli.main(["-f", str(record), "-i", "record", "-a", "odometry", "--device", "cpu", "-r", str(replay)])
    got = np.array([s for _, s in Recording.load(replay).estimate[-1][1]])
    want = rec.world.pose + np.cumsum([o for _, o in rec.odometry], axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)  # float32 sums of 6-digit text


def test_in_band_mode_switch():
    """A command's element after the odometry switches mapping <-> SLAM and
    collapses the particles onto the best one (PHDNavigator.cs:214-236)."""
    cfg = _configs()[1]
    commands = parse_commands(open("assets/mov2d.in").read())[:6]
    commands[2] = np.append(commands[2], 1.0)
    commands[4] = np.append(commands[4], -1.0)
    sim = Simulation(cfg, World.from_file("assets/linear2d.world"), commands, particles=3,
                     onlymapping=True, dtype=np.float32, phd_config=phd.PHDConfig(**{**PHD, "num_particles": 3}),
                     device="cpu")
    sim.run()
    assert [msg for _, msg in sim.tags] == ["SLAM mode on", "Mapping mode on"]
    assert sim.mode_mapping
    poses = [f["poses"] for f in sim.frames]
    for i in (0, 1, 4, 5):  # mapping frames: every particle on the true pose
        np.testing.assert_allclose(poses[i], np.tile(sim.waypoints[i][1], (3, 1)))
    assert np.ptp(poses[3], axis=0).max() > 0  # SLAM frames: motion noise spreads them
    assert sim.frames[4]["best"] == 0


@pytest.mark.parametrize("algorithm", ["loopy"])
def test_unported_algorithms_raise(algorithm):
    world = World.from_file("assets/linear2d.world")
    cfg = _configs()[1]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg, world, [], algorithm=algorithm, device="cpu")
    with pytest.raises(NotImplementedError):
        cli.main(["-f", "assets/linear2d.world", "-a", algorithm, "--device", "cpu"])


def test_unported_inputs_raise():
    with pytest.raises(NotImplementedError, match="kinect"):
        cli.main(["-f", "assets/tum_real", "-i", "kinect", "--device", "cpu"])
    world = World(pose=np.array([0, 0, 0, 1, 0, 0, 0.0]), landmarks=np.zeros((0, 3)),
                  measurer_params=np.arange(10.0))
    with pytest.raises(NotImplementedError, match="Kinect"):
        Simulation(Config(), world, [], device="cpu")
    with pytest.raises(ValueError):
        Simulation(Config(), World.from_file("assets/sim3d.world"), [], algorithm="ekf", device="cpu")
    with pytest.raises(NotImplementedError):
        Simulation(Config(), World.from_file("assets/sim3d.world"), [], kinect_source=object(), device="cpu")
