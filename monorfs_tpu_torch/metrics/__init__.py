from . import errors  # noqa: F401
from .errors import ate_location, ate_rotation, hungarian, ospa, rmse  # noqa: F401
