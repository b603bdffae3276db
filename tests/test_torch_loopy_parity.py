"""The port's smoother against the JAX package's over one recording: the
JAX package's own chap5 s2 odometry recording (tests/data/chap5_s2_odometry_
jax.zip, tests/data/README.md), `-i record -a loopy` with the chap5 config
at full width (the LoopyConfig defaults both packages build), float64 on the
CPU, over the first NODES nodes (the `--frames` cut of the command line).

Both the per-node trajectory and the postanalysis ATE and final OSPA agree
to 1e-6. The whole recording (270 nodes) runs on the GPU in float32 through
chip_smoke.py, phase 8, against the JAX package's ATE 0.251138 / OSPA
0.475211 on it.

A slow case holds the two smoothers to the same over a whole recording: the
JAX package's chap5 k3 odometry recording (experiments/out/chap5-k3, 328
nodes; about 22 minutes on a CPU, most of it the JAX package's)."""

import pathlib

import numpy as np
import pytest
import torch

from monorfs_tpu import postanalysis as jpost
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io import Recording as JRecording
from monorfs_tpu.sim import Simulation as JSimulation

from monorfs_tpu_torch import postanalysis
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording
from monorfs_tpu_torch.sim import Simulation

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORDING = ROOT / "tests" / "data" / "chap5_s2_odometry_jax.zip"
CFG = ROOT / "experiments" / "configs" / "chap5-default2d.cfg"
NODES = 10


def _cut(rec, n):
    """The command line's --frames cut of a replayed recording."""
    rec.odometry, rec.trajectory, rec.measurements = rec.odometry[:n], rec.trajectory[:n], rec.measurements[:n]
    rec.estimate = [(t, traj[:n]) for t, traj in rec.estimate[:n]]
    return rec


def _metrics(res):
    ate = float(np.sqrt(np.mean(np.array([v for _, v in res["loc"]]) ** 2)))
    return ate, float(res["map"][-1][1])


def _smooth(recording, cfg, nodes):
    """`-i record -a loopy` of both packages over the first `nodes` nodes of
    `recording`, float64 on the CPU, held node for node to 1e-6; returns the
    cut JAX recording, the JAX simulation and both (ATE, final OSPA)."""
    jrec, trec = _cut(JRecording.load(recording), nodes), _cut(Recording.load(recording), nodes)
    jsim = JSimulation(JConfig.from_file(str(cfg)), jrec.world, [], algorithm="loopy", dtype=np.float64,
                       replay=jrec).run()
    tsim = Simulation(Config.from_file(str(cfg)), trec.world, [], algorithm="loopy", dtype=torch.float64,
                      replay=trec, device="cpu").run()
    assert tsim.loopy.trajectory.shape == jsim.loopy.trajectory.shape == (nodes, 2)
    np.testing.assert_allclose(tsim.loopy.trajectory, jsim.loopy.trajectory, rtol=0, atol=1e-6)
    tate, tospa = _metrics(postanalysis.analyze(tsim.to_recording(), device="cpu"))
    jate, jospa = _metrics(jpost.analyze(jsim.to_recording()))
    np.testing.assert_allclose([tate, tospa], [jate, jospa], rtol=0, atol=1e-6)
    return jrec, jsim, (jate, jospa)


def test_smoother_over_the_jax_recording():
    assert len(Recording.load(RECORDING).odometry) == 270
    jrec, jsim, (jate, jospa) = _smooth(RECORDING, CFG, NODES)
    # the smoother moved the dead-reckoning estimate it started from
    start = np.array([v for _, v in jrec.estimate[-1][1]])
    assert np.abs(jsim.loopy.trajectory - start).max() > 1e-2
    assert 0.1 < jate < 0.5 and 0.1 < jospa < 1.0


@pytest.mark.slow
@pytest.mark.parametrize("recording, cfg, nodes", [
    (ROOT / "experiments" / "out" / "chap5-k3" / "odometry.zip", CFG, 328),
], ids=["chap5-k3"])
def test_smoother_over_a_whole_jax_recording(recording, cfg, nodes):
    assert len(Recording.load(recording).odometry) == nodes
    _smooth(recording, cfg, nodes)
