"""Multi-device paths on torch.distributed (the torch twin of
monorfs_tpu.parallel): the particle-sharded PHD step (mesh), the
block-sharded smoother sweep (chain), the landmark-sharded Schur BA
(dist_ba) and the multi-process start (multihost); collectives is the one
module that calls torch.distributed."""

from . import mesh  # noqa: F401
from .mesh import make_mesh, make_sharded_step, shard_state  # noqa: F401
from . import dist_ba  # noqa: F401
from . import chain  # noqa: F401
from . import multihost  # noqa: F401
