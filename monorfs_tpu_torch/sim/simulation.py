"""Model selection for a run (the model_for_config half of
monorfs_tpu.sim.simulation); the port carries PRM3D only."""

from ..config import Config
from ..io.world import World
from ..models import PRM3D


def model_for_config(cfg: Config, world: World):
    """The run's measurement model, with the world's measurer descriptor
    applied. Only PRM3D is ported: a 10-value (Kinect) descriptor or another
    model name raises."""
    if cfg.model != "PRM3D":
        raise NotImplementedError(f"model {cfg.model} is not ported yet")
    mp = world.measurer_params
    if mp is None:
        return PRM3D
    if len(mp) != 7:
        raise NotImplementedError("Kinect (10-value descriptor) is not ported yet")
    return PRM3D.with_params(PRM3D.params.from_linear(mp))
