"""Particle-sharded PHD filter over the ranks of a torch.distributed group
(the torch twin of monorfs_tpu.parallel.mesh).

The reference's only parallel axis is a Parallel.For over particles
(PHDNavigator.cs:326-339). Here every rank holds P/N particles and runs the
port's single-card step on them, weight update included
(phd._normalise_resample); what reduces over the particle axis, which the
JAX package leaves to XLA's sharding annotations, is handed to that update
as collectives (`reductions`, parallel/collectives.py):

  * the weight normalisation as a global log-sum-exp: pmax of the local
    maxima, then psum of the shifted sums;
  * the ESS test: psum of the local sums of squared weights;
  * best: the global argmax, lowest global index first; after a resampling
    the last drawn slot whose source holds the largest weight (phd.py:490
    of the JAX package);
  * systematic resampling: all_gather of the normalised log-weights, so
    every rank draws the same global sources from the one uniform, then
    all_gather of the particle payloads, of which each rank takes the rows
    it draws. Both branches of the ESS test are computed and selected with
    torch.where, as the single-card step does: no value goes to the host.

The draws are the global [P, T] motion normals and the one uniform the
single-card step takes; each rank reads its own rows, so N ranks compute
what one does. Each rank's step takes the port's default kernels: the
fused stage and the beam kernel in float32 on the card. (The JAX package
turns its beam kernel off under a mesh only because its SPMD partitioner
cannot see inside a pallas_call, mesh.py:63-67 there; per-rank code has no
such limit, and the beam computes the same function either way.)
"""

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..gm import mixture
from ..slam import phd
from . import collectives as C


@dataclasses.dataclass
class Mesh:
    """One rank's view of a one-axis mesh: the process group (None: the
    default world), its size and this rank, the device this rank computes
    on, the axis name, and the collectives' counter {op: [calls, bytes]}."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = "particles"
    comm: dict = dataclasses.field(default_factory=dict)


def make_mesh(device=None, axis="particles", group=None):
    """The mesh over every rank of `group` (torch.distributed must be up:
    parallel/multihost.initialize). device defaults to the current CUDA
    device under NCCL and to the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call parallel.multihost.initialize")
    if device is None:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), dev, axis)


def local_rows(mesh: Mesh, n):
    """The slice of a global axis of length n that this rank holds."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_state(state: phd.PHDState, mesh: Mesh):
    """This rank's P/N particles of a whole PHDState (best stays whole), on
    the mesh's device."""
    rows = local_rows(mesh, state.logweight.shape[0])
    take = lambda a: a[rows].to(mesh.device)
    return phd.PHDState(
        pose=take(state.pose), logweight=take(state.logweight),
        maps=mixture.map_soa(take, state.maps), best=state.best.to(mesh.device),
        ancestor=take(state.ancestor),
    )


def gather_state(state: phd.PHDState, mesh: Mesh):
    """The whole PHDState from every rank's shard (all_gather)."""
    return phd.PHDState(
        pose=C.all_gather(mesh, state.pose), logweight=C.all_gather(mesh, state.logweight),
        maps=_gather_maps(mesh, state.maps), best=state.best,
        ancestor=C.all_gather(mesh, state.ancestor),
    )


def _gather_maps(mesh, maps):
    """All ranks' maps, the ten SoA leaves packed into one all_gather."""
    packed = C.all_gather(mesh, torch.stack(list(maps), dim=1))
    return mixture.SGM(*packed.unbind(dim=1))


def reductions(mesh: Mesh, n):
    """phd.Reductions over every rank's particles of a global axis of n:
    the weight update's reductions written as collectives."""
    return phd.Reductions(
        max=lambda x: C.pmax(mesh, x), sum=lambda x: C.psum(mesh, x),
        gather=lambda x: C.all_gather(mesh, x), gather_maps=lambda maps: _gather_maps(mesh, maps),
        offset=local_rows(mesh, n).start,
    )


def make_sharded_step(model, cfg: phd.PHDConfig, mesh: Mesh, slam=True):
    """The PHD step on this rank's particles:
    (params, state, odometry [T], z [M, D], z_mask [M], motion_normals
    [P, T] (global), resample_u [], true_pose [S] = None) -> state, with
    state this rank's shard (shard_state) and best the global one.

    cfg.num_particles is the global count; the kernels are the port's
    default choice (phd.make_slam_step's kernels=None)."""
    normalise = functools.partial(phd._normalise_resample,
                                  reduce=reductions(mesh, cfg.num_particles))
    step = phd.make_slam_step(model, cfg, slam=slam, stages={"normalise": normalise})
    rows = local_rows(mesh, cfg.num_particles)

    def sharded(params, state, odometry, z, z_mask, motion_normals, resample_u, true_pose=None):
        if state.logweight.shape[0] != rows.stop - rows.start:
            raise ValueError("the state is not this rank's shard (shard_state)")
        normals = None if motion_normals is None else motion_normals[rows]
        out = step(params, state, odometry, z, z_mask, normals, resample_u, true_pose=true_pose)
        if not slam:  # the single-card step's identity ancestry, in global slots
            out = out._replace(ancestor=out.ancestor + rows.start)
        return out

    return sharded
