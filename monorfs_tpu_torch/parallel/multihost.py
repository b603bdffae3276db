"""Multi-process start (the torch twin of monorfs_tpu.parallel.multihost).

The reference is strictly single-process (its only parallelism is
Parallel.For threads, PHDNavigator.cs:326-339). Call `initialize` once in
every process, before building a mesh: it brings up torch.distributed, with
NCCL on the GPU, and the mesh builders (mesh.make_mesh,
chain.make_chain_mesh, dist_ba.make_landmark_mesh) then span every process.
One process drives one card: NCCL cannot run two ranks on one GPU.

Without a GPU the caller asks for the CPU (`device="cpu"`), and the ranks
talk over gloo: that is how the tests run N ranks on one host
(tests/torch_dist_runner.py).

The JAX helpers that assemble a global array from host-replicated values
become "take my shard" (shard_state_global, distribute) and "keep the
whole value" (replicated): a rank holds only its own rows.
"""

import datetime
import socket

import torch
import torch.distributed as dist

from .. import resolve_device
from .mesh import shard_state


TIMEOUT = datetime.timedelta(seconds=600)  # a rank's wait for the others


def initialize(init_method, world_size, rank, device="cuda", backend=None):
    """Bring up torch.distributed for one process of a run.

    init_method: "tcp://host:port" of rank 0 (or "host:port"). device:
    "cuda" (the default; rank r takes card r % the visible count) or "cpu".
    backend: NCCL for a CUDA device, gloo for the CPU; another choice must
    be asked for. A CUDA device with no GPU raises: the run never carries
    on quietly on the CPU. Returns the torch.device this rank computes on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "://" not in init_method:
        init_method = "tcp://" + init_method
    kwargs = dict(backend=backend, init_method=init_method, world_size=world_size, rank=rank,
                  timeout=TIMEOUT)
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    return dev


def free_port():
    """A free TCP port on this host, for a run whose ranks all start here."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shutdown():
    """Tear the process group down (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def distribute(host_value, mesh, axis=0):
    """This rank's rows (along `axis`) of a value every process holds whole,
    on the mesh's device."""
    value = torch.as_tensor(host_value)
    n = value.shape[axis]
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return value.narrow(axis, mesh.rank * per, per).to(mesh.device)


def shard_state_global(state, mesh):
    """A whole, host-replicated PHDState -> this rank's particles (the
    multi-process analogue of mesh.shard_state, which it is)."""
    return shard_state(state, mesh)


def replicated(value, mesh):
    """A value every process holds whole, kept whole on the mesh's device."""
    return torch.as_tensor(value).to(mesh.device)
