"""The port's NumPy-only copies against the JAX package's: Config descriptors
both ways, World round trips, and recordings saved by either package loading
in the other with equal fields. Exact: the code is a copy, text goes through
the same "g6" formatting."""

import dataclasses

import numpy as np
import pytest

from monorfs_tpu.config import Config as JConfig
from monorfs_tpu.io import Recording as JRecording
from monorfs_tpu.io import World as JWorld

from monorfs_tpu_torch import convert
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.io import Recording, World, parse_commands

MODELS = ["PRM3D", "Linear2D", "Linear1D"]


def _same_fields(a, b):
    for f in dataclasses.fields(JConfig):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("model", MODELS)
def test_descriptor_both_ways(model):
    jc, tc = JConfig(), Config()
    jc.set_model_defaults(model)
    tc.set_model_defaults(model)
    jc.birth_weight = tc.birth_weight = 0.07
    jc.perfect_still = tc.perfect_still = True
    assert tc.to_descriptor() == jc.to_descriptor()
    # each package reads the other's text
    _same_fields(JConfig().apply_descriptor(tc.to_descriptor().splitlines()),
                 Config().apply_descriptor(jc.to_descriptor().splitlines()))
    _same_fields(jc, Config().apply_descriptor(jc.to_descriptor().splitlines()))
    _same_fields(jc, convert.config(dataclasses.asdict(jc)))


def test_from_file_and_unknown_lines(tmp_path):
    text = "Model: Linear2D\nMotionCovariance: [0.05 0; 0 0.05]\nNoSuchKey: 3\nMaxQuantity: 64\nnot a pair\n"
    f = tmp_path / "run.cfg"
    f.write_text(text)
    tc, jc = Config.from_file(f), JConfig.from_file(f)
    _same_fields(jc, tc)
    assert tc.model == "Linear2D" and tc.max_quantity == 64
    with pytest.raises(ValueError):
        Config().set_model_defaults("Kinect9")


@pytest.mark.parametrize("name", ["sim3d", "linear2d", "linear2dloop", "linear1d"])
def test_world_round_trip(name):
    tw, jw = World.from_file(f"assets/{name}.world"), JWorld.from_file(f"assets/{name}.world")
    assert tw.serialize() == jw.serialize()
    back = World.parse(tw.serialize())
    np.testing.assert_allclose(back.pose, tw.pose, rtol=1e-5)
    np.testing.assert_allclose(back.landmarks, tw.landmarks, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(back.measurer_params, tw.measurer_params, rtol=1e-5)


def _recording(cls, world_cls):
    rng = np.random.default_rng(4)
    w = world_cls(pose=np.zeros(2), landmarks=rng.normal(size=(3, 3)), measurer_params=np.array([2.0]))
    times = [0.1 * (i + 1) for i in range(3)]
    traj = [(t, rng.normal(size=2)) for t in times]
    comps = [(0.8, rng.normal(size=3), np.eye(3) * 0.01), (1.7, rng.normal(size=3), np.eye(3) * 0.02)]
    return cls(
        world=w, trajectory=traj, odometry=[(t, rng.normal(size=2)) for t in times],
        estimate=[(t, traj[: i + 1]) for i, t in enumerate(times)],
        maps=[(t, comps[: i % 3]) for i, t in enumerate(times)],
        vismaps=[(t, comps[:1]) for t in times],
        measurements=[(t, [rng.normal(size=2) for _ in range(i)]) for i, t in enumerate(times)],
        tags=[(0.2, "SLAM mode on")], config_text=JConfig().to_descriptor(),
        sightings=[(t, [1, -2][:i]) for i, t in enumerate(times)],
    )


def _assert_recordings_equal(a, b):
    np.testing.assert_array_equal(a.world.pose, b.world.pose)
    np.testing.assert_array_equal(a.world.landmarks, b.world.landmarks)
    np.testing.assert_array_equal(a.world.measurer_params, b.world.measurer_params)
    for name in ("trajectory", "odometry"):
        for (ta, va), (tb, vb) in zip(getattr(a, name), getattr(b, name), strict=True):
            assert ta == tb
            np.testing.assert_array_equal(va, vb)
    for (ta, ja), (tb, jb) in zip(a.estimate, b.estimate, strict=True):
        assert ta == tb and len(ja) == len(jb)
        for (sa, pa), (sb, pb) in zip(ja, jb):
            assert sa == sb
            np.testing.assert_array_equal(pa, pb)
    for name in ("maps", "vismaps"):
        for (ta, ca), (tb, cb) in zip(getattr(a, name), getattr(b, name), strict=True):
            assert ta == tb and len(ca) == len(cb)
            for (wa, ma, pa), (wb, mb, pb) in zip(ca, cb):
                assert wa == wb
                np.testing.assert_array_equal(ma, mb)
                np.testing.assert_array_equal(pa, pb)
    for (ta, za), (tb, zb) in zip(a.measurements, b.measurements, strict=True):
        assert ta == tb and len(za) == len(zb)
        for x, y in zip(za, zb):
            np.testing.assert_array_equal(x, y)
    assert a.tags == b.tags and a.config_text == b.config_text and a.sightings == b.sightings


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_recording_loads_in_the_other_package(tmp_path, writer):
    f = tmp_path / "rec.zip"
    if writer == "port":
        _recording(Recording, World).save(f)
    else:
        _recording(JRecording, JWorld).save(f)
    _assert_recordings_equal(Recording.load(f), JRecording.load(f))
    assert len(Recording.load(f).maps) == 3


def test_parse_commands():
    cmds = parse_commands("0.1 0 0 0 0 0\n\n0 0 0 0 0 0 1\n")
    assert [len(c) for c in cmds] == [6, 7]
