from . import base  # noqa: F401
from .base import Model, PoseOps, get, register  # noqa: F401
from .kinect_model import MODEL as KINECT  # noqa: F401
from .linear_models import MODEL_1D, MODEL_2D  # noqa: F401
from .prm3d import MODEL as PRM3D  # noqa: F401

register(PRM3D)
register(MODEL_2D)
register(MODEL_1D)
register(KINECT)
