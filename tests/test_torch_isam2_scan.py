"""The port's scan runners (slam/isam2_scan.py, slam/isam2_scan_da.py)
against the JAX package's over 20 frames, the port fed JAX's own draws (the
three-way split of the carry key per frame, tests/torch_parity.py::
jax_scan_draws): identical factor layout, labels and landmark counts; true
and estimated poses within 1e-8 in float64 and 1e-3 in float32. The
Mahalanobis scan runs on the JAX scan's assignments (FollowJaxAuction),
each frame's profit matrix and auction held to JAX's. Then the
slice as a whole on the CPU: `cli -a isam2` on the 2D world, its recording
replayed by both packages' command lines, ATE and OSPA within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu import cli as jcli
from monorfs_tpu import postanalysis as jpost
from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io import Recording as JRecording
from monorfs_tpu.io import World as JWorld
from monorfs_tpu.io import parse_commands
from monorfs_tpu.slam.isam2_scan import build_isam2_scan_runner as jbuild_scan
from monorfs_tpu.slam.isam2_scan_da import build_mahalanobis_scan as jbuild_da

from monorfs_tpu_torch import bench_isam2, cli, convert, postanalysis
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording, World
from monorfs_tpu_torch.slam import isam2_scan, isam2_scan_da
from monorfs_tpu_torch.slam.isam2_scan import build_isam2_scan_runner
from monorfs_tpu_torch.slam.isam2_scan_da import build_mahalanobis_scan

from torch_parity import fields, jax_scan_draws, np_

FRAMES = 20
WORLDS = {"Linear2D": ("assets/linear2d.world", "assets/mov2d.in", 2, 2),
          "PRM3D": ("assets/sim3d.world", "assets/mov3d.in", 6, 3)}
CASES = [("Linear2D", "float64", 1e-8), ("PRM3D", "float64", 1e-8), ("PRM3D", "float32", 1e-3)]


def _setup(name, dtype):
    world_file, command_file, o, d = WORLDS[name]
    jc, tc = JConfig(), Config()
    if name != "PRM3D":
        jc.set_model_defaults(name)
        tc.set_model_defaults(name)
    jw, tw = JWorld.from_file(world_file), World.from_file(world_file)
    cmds = np.stack([c[:o] for c in parse_commands(open(command_file).read())])[:FRAMES]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return jc, tc, jw, tw, cmds, jdt, tdt, o, d


def _draws(jc, jm, jw, jdt, o, d, seed=0):
    count = jnp.asarray(jc.clutter_density * float(jm.volume(jm.params)), jdt)
    return jax_scan_draws(jax.random.PRNGKey(seed), FRAMES, len(jw.landmarks), d, o, 8, count, jdt)


def _same_graph(tst, jst):
    live = np_(jst.f_mask)
    np.testing.assert_array_equal(tst.f_mask.numpy(), live)
    np.testing.assert_array_equal(tst.f_pose.numpy()[live], np_(jst.f_pose)[live])
    np.testing.assert_array_equal(tst.f_lm.numpy()[live], np_(jst.f_lm)[live])
    np.testing.assert_array_equal(tst.lm_mask.numpy(), np_(jst.lm_mask))
    np.testing.assert_array_equal(tst.between_mask.numpy(), np_(jst.between_mask))
    assert tst.n_poses == int(jst.n_poses) == FRAMES + 1


@pytest.mark.parametrize("name,dtype,tol", CASES)
def test_known_label_scan_matches_jax(name, dtype, tol):
    jc, tc, jw, tw, cmds, jdt, tdt, o, d = _setup(name, dtype)
    jrun, jcarry, jm = jbuild_scan(jc, jw, frames=FRAMES, dtype=jdt)
    jout, (jtp, jep) = jrun(jcarry, jnp.asarray(cmds, jdt))
    trun, tcarry, _ = build_isam2_scan_runner(tc, tw, frames=FRAMES, dtype=tdt, device="cpu")
    draws = _draws(jc, jm, jw, jdt, o, d)
    tout, (ttp, tep) = trun(tcarry, torch.tensor(cmds, dtype=tdt), draws)
    assert tep.dtype == tdt and tep.shape == np_(jep).shape
    np.testing.assert_allclose(ttp.numpy(), np_(jtp), rtol=0, atol=tol)
    np.testing.assert_allclose(tep.numpy(), np_(jep), rtol=0, atol=tol)
    _same_graph(tout.gstate, jout.gstate)
    np.testing.assert_allclose(tout.gstate.landmarks.numpy(), np_(jout.gstate.landmarks), rtol=0, atol=tol)
    # the run left the carry it started from intact: a second run repeats it
    assert tcarry.gstate.n_poses == 1 and not bool(tcarry.gstate.f_mask.any())
    _, (_, again) = trun(tcarry, torch.tensor(cmds, dtype=tdt), draws)
    np.testing.assert_array_equal(again.numpy(), tep.numpy())


class FollowJaxAuction:
    """Runs the port's scan on the JAX scan's assignments (install with
    monkeypatch). The auction is optimal only to S * eps, and its bids tie
    exactly on the forced clutter and miss blocks, so a rounding-sized change
    of the profit matrix can move a measurement between two candidates: on
    the Linear2D float64 case, frame 18, uniform noise of 1.3e-14 on JAX's
    matrix gives JAX's assignment in 76 of 200 draws and the port's in 124.
    Each frame the port's profit matrix is held to JAX's, the port's auction
    run on JAX's matrix must return JAX's assignment, and its auction on its
    own matrix (the one `stats` counts) may differ only by an assignment
    within the auction's S * eps of JAX's; the port then goes on with JAX's.
    Rows that trade the zero-profit clutter / miss seats among themselves
    label nothing: a flip is a change of some measurement's owner (the
    first m columns)."""

    def __init__(self, jassign, tassign, profit_atol, m):
        self.jassign, self.tassign, self.atol, self.m = jassign, tassign, profit_atol, m
        self.frames, self.flips = [], 0

    def owners(self, col):
        """The row that holds each measurement column (-1: none)."""
        out = np.full(self.m, -1)
        seated = (col >= 0) & (col < self.m)
        out[col[seated]] = np.flatnonzero(seated)
        return out

    def jax_auction(self, profit, **kw):
        col = self.jassign(profit, **kw)
        jax.debug.callback(lambda p, c: self.frames.append((np.asarray(p), np.asarray(c))), profit, col,
                           ordered=True)
        return col

    def port_auction(self, profit, eps, stats=None):
        jprofit, jcol = self.frames.pop(0)
        np.testing.assert_allclose(profit.numpy(), jprofit, rtol=0, atol=self.atol)
        on_jax = self.tassign(torch.tensor(jprofit), eps=eps).numpy()
        np.testing.assert_array_equal(on_jax, jcol)
        own = self.tassign(profit, eps=eps, stats=stats).numpy()
        if not np.array_equal(self.owners(own), self.owners(jcol)):
            self.flips += 1
            rows, p = np.arange(len(own)), profit.numpy()
            assert abs(p[rows, own].sum() - p[rows, jcol].sum()) <= len(own) * eps
        return torch.tensor(jcol, dtype=torch.int64)


@pytest.mark.parametrize("name,dtype,tol", CASES)
def test_mahalanobis_scan_matches_jax(name, dtype, tol, monkeypatch):
    from monorfs_tpu.slam import assignment as jassignment

    jc, tc, jw, tw, cmds, jdt, tdt, o, d = _setup(name, dtype)
    follow = FollowJaxAuction(jassignment.auction_assign, isam2_scan_da.assignment.auction_assign,
                              1e-10 if dtype == "float64" else 1e-3, len(jw.landmarks) + 8)
    monkeypatch.setattr(jassignment, "auction_assign", follow.jax_auction)
    monkeypatch.setattr(isam2_scan_da.assignment, "auction_assign", follow.port_auction)
    jrun, jcarry, jm = jbuild_da(jc, jw, frames=FRAMES, dtype=jdt)
    jout, (jtp, jep, jn) = jrun(jcarry, jnp.asarray(cmds, jdt))
    jax.effects_barrier()
    assert len(follow.frames) == FRAMES
    trun, tcarry, _ = build_mahalanobis_scan(tc, tw, frames=FRAMES, dtype=tdt, device="cpu")
    stats = {"iterations": [], "reads": 0}
    tout, (ttp, tep, tn) = trun(tcarry, torch.tensor(cmds, dtype=tdt), _draws(jc, jm, jw, jdt, o, d),
                                stats=stats)
    assert not follow.frames
    np.testing.assert_array_equal(tn.numpy(), np_(jn))  # the landmark count of every frame
    assert int(tn[-1]) >= 3
    np.testing.assert_allclose(ttp.numpy(), np_(jtp), rtol=0, atol=tol)
    np.testing.assert_allclose(tep.numpy(), np_(jep), rtol=0, atol=tol)
    _same_graph(tout.gstate, jout.gstate)
    assert tout.da.next_label == int(jout.da.next_label) and tout.frame == int(jout.frame) == FRAMES
    np.testing.assert_array_equal(tout.da.cand_count.numpy(), np_(jout.da.cand_count))
    np.testing.assert_allclose(tout.da.cand_mean.numpy(), np_(jout.da.cand_mean), rtol=0, atol=tol)
    # the gate covariances: float32 marginals carry the float32 Cholesky's noise
    scale = np.abs(np_(jout.da.pl_cov)).max()
    np.testing.assert_allclose(tout.da.pl_cov.numpy(), np_(jout.da.pl_cov), rtol=0,
                               atol=(1e-7 if dtype == "float64" else 5e-3) * scale)
    # four auction phases a frame (16, 2, 0.25, then eps = 0.05), each counted
    assert len(stats["iterations"]) == 4 * FRAMES and stats["reads"] > sum(stats["iterations"])


def test_da_state_converts_and_continues():
    """A JAX carry after 10 frames, carried over with convert.graph_state /
    convert.da_state, continues in the port as the JAX run does."""
    jc, tc, jw, tw, cmds, jdt, tdt, o, d = _setup("Linear2D", "float64")
    jrun, jcarry, jm = jbuild_da(jc, jw, frames=FRAMES, dtype=jdt)
    jmid, _ = jrun(jcarry, jnp.asarray(cmds[:10], jdt))
    jout, (_, jep, jn) = jrun(jmid, jnp.asarray(cmds[10:], jdt))
    trun, tcarry, _ = build_mahalanobis_scan(tc, tw, frames=FRAMES, dtype=tdt, device="cpu")
    mid = isam2_scan_da.ScanDACarry(
        vstate=convert.vehicle_state(**fields(jmid.vstate), dtype=tdt, device="cpu"),
        gstate=convert.graph_state(fields(jmid.gstate), dtype=tdt, device="cpu"),
        da=convert.da_state(fields(jmid.da), dtype=tdt, device="cpu"),
        est_pose=torch.tensor(np_(jmid.est_pose)), frame=int(jmid.frame),
    )
    assert mid.da.next_label == int(jmid.da.next_label) and mid.da.cand_count.dtype == torch.int64
    draws = _draws(jc, jm, jw, jdt, o, d)
    _, (_, tep, tn) = trun(mid, torch.tensor(cmds[10:], dtype=tdt), {k: v[10:] for k, v in draws.items()})
    np.testing.assert_array_equal(tn.numpy(), np_(jn))
    np.testing.assert_allclose(tep.numpy(), np_(jep), rtol=0, atol=1e-8)


def test_clutter_capacity_raises():
    world = World.from_file("assets/sim3d.world")
    cfg = Config.from_file("experiments/configs/chap4-cluttery.cfg")
    # cluttery: lambda ~ 1.75 -> floor(10 lambda) = 17 > 8 default slots
    with pytest.raises(ValueError, match="max_clutter"):
        build_mahalanobis_scan(cfg, world, 10, max_clutter=8, device="cpu")
    with pytest.raises(ValueError, match="max_clutter"):
        build_isam2_scan_runner(cfg, world, 10, max_clutter=8, device="cpu")
    with pytest.raises(ValueError, match="floor"):
        isam2_scan.check_clutter_capacity(cfg, isam2_scan.model_for_config(cfg, world), 16)
    build_mahalanobis_scan(cfg, world, 4, max_clutter=18, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_mahalanobis_scan(Config(), world, 4)


def test_scan_draws_are_seeded():
    world, cfg = World.from_file("assets/sim3d.world"), Config()
    model = isam2_scan.model_for_config(cfg, world)
    a = isam2_scan.scan_draws(model, cfg, world, 6, seed=3, device="cpu")
    b = isam2_scan.scan_draws(model, cfg, world, 6, seed=3, device="cpu")
    c = isam2_scan.scan_draws(model, cfg, world, 6, seed=4, device="cpu")
    assert set(a) == set(isam2_scan.DRAW_NAMES)
    assert a["detect_u"].shape == (6, 40) and a["clutter_u"].shape == (6, 8, 3)
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["odo_normals"], c["odo_normals"])


@pytest.mark.parametrize("mode", ["scan", "scan-da", "navigator"])
def test_bench_isam2_modes_on_the_cpu(mode, capsys):
    argv = {"scan": ["--scan"], "scan-da": ["--scan-da", "--variant", "default"], "navigator": []}[mode]
    assert bench_isam2.main(argv + ["--frames", "12", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    import json

    line = json.loads(out.strip().splitlines()[-1])
    detail = json.loads(err.strip().splitlines()[-1])["detail"]
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert detail["frames"] == 12 and detail["card"] is None and np.isfinite(detail["ate_rmse_loc"])
    assert detail["ate_rmse_loc"] < 0.05 and detail["host_reads_per_frame"] >= 1
    if mode == "scan":
        assert detail["final_landmarks"] >= 30
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_isam2.main(argv + ["--frames", "2"])


def _analysis(module, recording_cls, record, **kw):
    return module.analyze(recording_cls.load(record), **kw)


def test_cli_isam2_then_both_replays(tmp_path, capsys):
    """cli -a isam2 on the CPU, postanalysis, then the recording replayed
    through -i record -a isam2 by both command lines."""
    run = tmp_path / "run.zip"
    assert cli.main(["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "isam2",
                     "--device", "cpu", "--frames", "25", "-r", str(run)]) == 0
    assert postanalysis.main(["-f", str(run), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "finished running" in out and "ATE loc RMSE" in out and "final OSPA" in out
    rec = Recording.load(run)
    assert len(rec.trajectory) == len(rec.estimate) == len(rec.maps) == 25
    assert len(rec.maps[-1][1]) >= 2  # landmarks were promoted and mapped

    port, ref = tmp_path / "port.zip", tmp_path / "ref.zip"
    assert cli.main(["-f", str(run), "-i", "record", "-a", "isam2", "--device", "cpu", "-r", str(port)]) == 0
    assert jcli.main(["-f", str(run), "-i", "record", "-a", "isam2", "--dtype", "float64", "-r", str(ref)]) == 0
    got = _analysis(postanalysis, Recording, port, device="cpu")
    want = _analysis(jpost, JRecording, ref)
    for name in ("loc", "rot", "map", "size"):
        assert len(got[name]) == len(want[name]) == 25
        np.testing.assert_allclose(np.array(got[name], float), np.array(want[name], float),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert got["loc"][-1][1] < 0.2 and got["map"][-1][1] < 0.6


def test_mapping_only_and_no_gpu(tmp_path):
    run = tmp_path / "map.zip"
    assert cli.main(["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "isam2", "-y",
                     "--device", "cpu", "--frames", "12", "-r", str(run)]) == 0
    res = _analysis(postanalysis, Recording, run, device="cpu")
    assert max(v for _, v in res["loc"]) == 0.0  # poses pinned to the truth
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-f", "assets/linear2d.world", "-c", "assets/mov2d.in", "-a", "isam2", "--frames", "2"])
