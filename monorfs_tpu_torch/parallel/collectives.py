"""The collectives of the sharded paths, on torch.distributed: the one place
the port calls it. Under a JAX mesh XLA inserts these from the sharding
annotations (the weight normalisation's psum, the resampling all-gather,
the chain's ppermute halos, the Schur BA's psum); here each sharded module
calls them by hand.

Every function takes a `Mesh` (parallel/mesh.py) and records its op and
bytes in the mesh's `comm` counter, {op: [calls, bytes]}, which
tools/comm_volume.py reads. The bytes are those of the op's result on this
rank, as the JAX tool reads them off the HLO (all_gather: the whole
gathered tensor; a halo: the element received).

Collectives are issued even with a world of one, so on the card they go
through NCCL. The halos are the exception: at N=1 the JAX twin's halo is
the scan carry itself (the block's own wrapped end), and so it is here,
with nothing sent.
"""

import torch
import torch.distributed as dist


def _record(mesh, op, result):
    calls, nbytes = mesh.comm.get(op, (0, 0))
    mesh.comm[op] = [calls + 1, nbytes + result.numel() * result.element_size()]


def _reduce(mesh, x, op, name):
    x = torch.as_tensor(x)
    buf = x.reshape(-1).clone()  # NCCL takes no 0-d tensor; the input stays
    _record(mesh, name, buf)
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.reshape(x.shape)


def psum(mesh, x):
    """Sum of x over the ranks of the mesh (every rank gets it)."""
    return _reduce(mesh, x, dist.ReduceOp.SUM, "psum")


def pmax(mesh, x):
    """Elementwise max of x over the ranks of the mesh."""
    return _reduce(mesh, x, dist.ReduceOp.MAX, "pmax")


def all_gather(mesh, x):
    """The ranks' x concatenated along axis 0 in rank order (JAX's
    all_gather(tiled=True)); a bool tensor travels as bytes."""
    if x.dtype == torch.bool:
        return all_gather(mesh, x.to(torch.uint8)).bool()
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _record(mesh, "all_gather", out)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=mesh.group)
    return out


def _permute(mesh, x, dst, src, name):
    """Send x to rank dst and receive the like-shaped tensor of rank src."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    _record(mesh, name, out)
    group_rank = lambda r: dist.get_global_rank(mesh.group, r) if mesh.group is not None else r
    ops = [dist.P2POp(dist.isend, x, group_rank(dst), mesh.group),
           dist.P2POp(dist.irecv, out, group_rank(src), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def halo_from_prev(mesh, x):
    """The last element of the previous rank's block (wraps at rank 0; the
    callers mask it), the ppermute (i -> i + 1) of chain.py:67-70."""
    n, r = mesh.size, mesh.rank
    return _permute(mesh, x[-1:], (r + 1) % n, (r - 1) % n, "halo")[0]


def halo_from_next(mesh, x):
    """The first element of the next rank's block (wraps at the last rank),
    the ppermute (i -> i - 1) of chain.py:73-76."""
    n, r = mesh.size, mesh.rank
    return _permute(mesh, x[:1], (r - 1) % n, (r + 1) % n, "halo")[0]
