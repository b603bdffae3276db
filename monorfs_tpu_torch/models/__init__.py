from .base import Model, PoseOps  # noqa: F401
from .prm3d import MODEL as PRM3D  # noqa: F401
