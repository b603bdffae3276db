from . import simulation, vehicle  # noqa: F401
from .simulation import Simulation  # noqa: F401
