from . import recording, world  # noqa: F401
from .recording import Recording  # noqa: F401
from .world import World, parse_commands  # noqa: F401
