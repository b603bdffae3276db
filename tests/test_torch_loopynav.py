"""The port's smoother navigator (slam/loopynav.py), Simulation(algorithm=
"loopy") and `cli.main -a loopy` against the JAX package's, over a 10-frame
Linear2D odometry recording made by the JAX command line on the CPU.

Both packages build their LoopyConfig inside Simulation; the tests hand
both the same test-size defaults (torch_parity.loopy_configs' sizes) by
patching the class each module constructs, so the JAX functions compile in
seconds. The full-width configuration runs on the card (chip_smoke.py).

float64 (LoopySweeps 3: the refit, the reversed refit and one Jacobi sweep,
frozen map messages): per-sweep objectives to 1e-8, the trajectory to 1e-6
(the acceptance bound; the recordings hold 6 significant digits), the map
history's component weights to 1e-6. float32 (the default single sweep,
the port with kernels=False): ATE and OSPA to 1e-3."""

import functools

import numpy as np
import pytest
import torch

from monorfs_tpu import postanalysis as jpost
from monorfs_tpu.cli import main as jcli
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io import Recording as JRecording
from monorfs_tpu.sim import Simulation as JSimulation
from monorfs_tpu.slam import loopy as jloopy
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch import cli, postanalysis
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording
from monorfs_tpu_torch.sim import Simulation
from monorfs_tpu_torch.slam import loopy
from monorfs_tpu_torch.slam import phd

FRAMES = 10
CFG = "experiments/configs/chap5-default2d.cfg"


def _small(module, phd_module, **extra):
    inner = phd_module.PHDConfig(num_particles=1, max_components=24, max_measurements=33, gate_top=4,
                                 estimate_cap=8, beam_width=8)
    return functools.partial(module.LoopyConfig, mix_cap=4, blocks=4, ga_iters=2, ga_steps=2,
                             jmap_cap=8, beam_width=8, refit_seeds=2, inner=inner, **extra)


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """A 10-frame odometry recording of the chap5 2D world, from the JAX CLI."""
    path = tmp_path_factory.mktemp("loopynav") / "odo.zip"
    jcli(["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "odometry", "-g", CFG,
          "-r", str(path), "--frames", str(FRAMES)])
    return path


@pytest.fixture
def small_configs(monkeypatch):
    monkeypatch.setattr(jloopy, "LoopyConfig", _small(jloopy, jphd))
    monkeypatch.setattr(loopy, "LoopyConfig", _small(loopy, phd))
    return monkeypatch


def _configs(sweeps):
    out = []
    for c in (JConfig.from_file(CFG), Config.from_file(CFG)):
        c.loopy_sweeps = sweeps
        out.append(c)
    return out


def test_navigator_three_sweeps_and_cli(recording, small_configs, tmp_path):
    jcfg, tcfg = _configs(3)
    jrec, trec = JRecording.load(recording), Recording.load(recording)
    jsim = JSimulation(jcfg, jrec.world, [], algorithm="loopy", dtype=np.float64, replay=jrec).run()
    tsim = Simulation(tcfg, trec.world, [], algorithm="loopy", dtype=torch.float64, replay=trec,
                      device="cpu").run()
    jnav, tnav = jsim.loopy, tsim.loopy
    assert tnav.sweeps == jnav.sweeps == 3
    np.testing.assert_allclose(tnav.best_objective, jnav.best_objective, rtol=1e-8)
    np.testing.assert_allclose(tnav.best_map_objective, jnav.best_map_objective, rtol=1e-8)
    np.testing.assert_allclose(tnav.objective(), jnav.objective(), rtol=1e-8)
    np.testing.assert_allclose(tnav.trajectory, jnav.trajectory, rtol=0, atol=1e-6)
    assert np.abs(jnav.trajectory - np.array([s for _, s in jrec.estimate[-1][1]])).max() > 1e-3
    for (ta, tm), (ja, jm) in zip(tsim.way_maps, jsim.way_maps, strict=True):
        assert ta == ja and len(tm) == len(jm)
        np.testing.assert_allclose(sorted(w for w, _, _ in tm), sorted(w for w, _, _ in jm), atol=1e-6)
    assert len(jsim.way_maps[-1][1]) > 0

    # the command line over the same recording (the cfg file sets LoopySweeps)
    cfgfile = tmp_path / "run.cfg"
    cfgfile.write_text(open(CFG).read() + "LoopySweeps: 3\n")
    out = tmp_path / "loopy.zip"
    assert cli.main(["-f", str(recording), "-i", "record", "-a", "loopy", "-g", str(cfgfile),
                     "--dtype", "float64", "--device", "cpu", "-r", str(out)]) == 0
    jsim.save(tmp_path / "jax.zip")
    got, want = Recording.load(out), JRecording.load(tmp_path / "jax.zip")
    est = np.array([s for _, s in got.estimate[-1][1]])
    np.testing.assert_allclose(est, np.array([s for _, s in want.estimate[-1][1]]), rtol=0, atol=1e-6)
    tres = postanalysis.analyze(got, device="cpu")
    jres = jpost.analyze(want)
    for name in ("loc", "map"):
        np.testing.assert_allclose(np.array(tres[name], float), np.array(jres[name], float), atol=1e-6)


def test_simulation_float32(recording, small_configs):
    small_configs.setattr(loopy, "LoopyConfig", _small(loopy, phd, kernels=False))  # the XLA semantics
    jcfg, tcfg = _configs(1)
    jrec, trec = JRecording.load(recording), Recording.load(recording)
    jsim = JSimulation(jcfg, jrec.world, [], algorithm="loopy", dtype=np.float32, replay=jrec).run()
    tsim = Simulation(tcfg, trec.world, [], algorithm="loopy", dtype=torch.float32, replay=trec,
                      device="cpu").run()
    jres = jpost.analyze(jsim.to_recording())
    tres = postanalysis.analyze(tsim.to_recording(), device="cpu")
    ate = [np.sqrt(np.mean(np.array([v for _, v in r["loc"]]) ** 2)) for r in (tres, jres)]
    ospa = [r["map"][-1][1] for r in (tres, jres)]
    np.testing.assert_allclose(ate[0], ate[1], atol=1e-3)
    np.testing.assert_allclose(ospa[0], ospa[1], atol=1e-3)
    assert 0 < ate[1] < 1 and ospa[1] < 1
