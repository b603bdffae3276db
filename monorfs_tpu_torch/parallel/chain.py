"""Block-sharded Loopy-PHD smoother: the pose chain split over the ranks of
a torch.distributed group (the torch twin of monorfs_tpu.parallel.chain).

The reference smoother holds all T poses in one process and sweeps them
round-robin with stale neighbour messages (LoopyPHDNavigator.cs:369-377).
Here rank r holds the contiguous block of nodes [r T/N, (r + 1) T/N):

  * the forward and backward sweeps run the sequential recursion INSIDE
    each block (the step functions of slam/loopy.py), while a block
    boundary takes the neighbour's pre-sweep fused belief, one halo
    exchange a direction (collectives.halo_from_prev / halo_from_next):
    block-Jacobi across blocks, as the reference's own schedule is stale;
  * the B leave-block-out cavity maps are computed B/N a rank, in one
    mapping run whose fused stage takes a [B/N, M] mask a frame, and
    all_gathered; the first-pass causal maps are sequential over T and are
    computed whole on every rank, each keeping its slice;
  * the per-node map-message fits are node-local, on the owner rank;
  * the shear gauge fix reduces its moments with psum.

With N=1 the halo is the block's own wrapped end, as the JAX twin's scan
carry, and the sweep is the sequential one (loopy.make_sweep, then
loopy.relinearize when the config asks).
"""

import torch

from ..gm import gaussian
from ..slam import loopy
from ..slam.loopy import LoopyState
from . import collectives as C
from .mesh import local_rows, make_mesh


def make_chain_mesh(device=None, group=None):
    """The `chain` mesh over every rank of the group."""
    return make_mesh(device=device, axis="chain", group=group)


def shard_loopy_inputs(mesh, state: LoopyState, odometry, z, z_mask):
    """This rank's block of the smoother state and the per-frame data
    (axis 0 = trajectory nodes), on the mesh's device."""
    rows = local_rows(mesh, state.lp.shape[0])
    take = lambda x: x[rows].to(mesh.device)
    return LoopyState(*[take(x) for x in state]), take(odometry), take(z), take(z_mask)


def _shift_down(local, halo):
    """Local view of roll(global, 1): [halo, local[0], ..., local[-2]]."""
    return torch.cat([halo[None], local[:-1]], dim=0)


def _shift_up(local, halo):
    """Local view of roll(global, -1): [local[1], ..., local[-1], halo]."""
    return torch.cat([local[1:], halo[None]], dim=0)


def _gidx(mesh, state):
    tb = state.lp.shape[0]
    return mesh.rank * tb, mesh.rank * tb + torch.arange(tb, device=state.lp.device)


def _forward_block(model, mesh, state: LoopyState, odometry, motion_cov):
    step = loopy.make_forward_step(model, motion_cov)
    offset, gidx = _gidx(mesh, state)
    prev = lambda x: _shift_down(x, C.halo_from_prev(mesh, x))
    lp_prev, odo_prev = prev(state.lp), prev(odometry)
    fut_prev_mean, fut_prev_cov = prev(state.future_mean), prev(state.future_cov)
    active = (gidx >= 1) & state.node_mask
    # cross-block carry: the neighbour's PRE-sweep fused belief (one stale
    # value a boundary a sweep). Rank 0's wrapped halo is never read: node 0
    # is inactive and its fused is re-fused below.
    carry = (C.halo_from_prev(mesh, state.fused_mean), C.halo_from_prev(mesh, state.fused_cov))
    outs = []
    for i in range(state.lp.shape[0]):
        inputs = (lp_prev[i], state.lp[i], fut_prev_mean[i], fut_prev_cov[i], odo_prev[i],
                  state.past_mean[i], state.past_cov[i], state.future_mean[i],
                  state.future_cov[i], state.map_const[i], state.map_mean[i], state.map_cov[i],
                  state.map_logw[i], active[i])
        carry, out = step(carry, inputs)
        outs.append(out)
    past_mean, past_cov, fused_mean, fused_cov = (torch.stack(x) for x in zip(*outs))
    if offset == 0:
        # node 0 keeps its Dirac past message and re-fuses in place
        past_mean[0], past_cov[0] = state.past_mean[0], state.past_cov[0]
        f0 = loopy._fuse3_single(model, state._replace(past_mean=past_mean, past_cov=past_cov), 0)
        fused_mean[0], fused_cov[0] = f0
    return state._replace(past_mean=past_mean, past_cov=past_cov, fused_mean=fused_mean,
                          fused_cov=fused_cov)


def _backward_block(model, mesh, state: LoopyState, odometry, motion_cov):
    step = loopy.make_backward_step(model, motion_cov)
    _, gidx = _gidx(mesh, state)
    n_nodes = C.psum(mesh, torch.sum(state.node_mask))
    nxt = lambda x: _shift_up(x, C.halo_from_next(mesh, x))
    lp_next, past_next_mean, past_next_cov = nxt(state.lp), nxt(state.past_mean), nxt(state.past_cov)
    active = (gidx < n_nodes - 1) & state.node_mask
    carry = (C.halo_from_next(mesh, state.fused_mean), C.halo_from_next(mesh, state.fused_cov))
    tb = state.lp.shape[0]
    outs = [None] * tb
    for i in range(tb - 1, -1, -1):
        inputs = (state.lp[i], lp_next[i], past_next_mean[i], past_next_cov[i], odometry[i],
                  state.future_mean[i], state.future_cov[i], state.past_mean[i],
                  state.past_cov[i], state.map_const[i], state.map_mean[i], state.map_cov[i],
                  state.map_logw[i], active[i])
        carry, outs[i] = step(carry, inputs)
    fut_mean, fut_cov, fused_mean, fused_cov = (torch.stack(x) for x in zip(*outs))
    return state._replace(future_mean=fut_mean, future_cov=fut_cov, fused_mean=fused_mean,
                          fused_cov=fused_cov)


def _map_block(model, cfg, mesh, params, state: LoopyState, z, z_mask, temperature, grad_clip,
               grad_rate, causal):
    """The map-message stage on this rank's block: the trajectory-wide map
    filters over the gathered trajectory (causal maps whole on every rank,
    cavity maps cfg.blocks / N a rank and all_gathered), the fits local."""
    offset, gidx = _gidx(mesh, state)
    tb = state.lp.shape[0]
    pf_mean, pf_cov = loopy._fuse(state.past_mean, state.past_cov, state.future_mean,
                                  state.future_cov)
    lp_g, fused_g = C.all_gather(mesh, state.lp), C.all_gather(mesh, state.fused_mean)
    z_g, zm_g = C.all_gather(mesh, z), C.all_gather(mesh, z_mask)
    nm_g = C.all_gather(mesh, state.node_mask)
    map_poses = model.pose.add(lp_g, fused_g)
    if causal:
        # sequential over T: computed whole, this block's slice kept
        jm, jc, jv = loopy.causal_maps(model, cfg, params, map_poses, z_g, zm_g, nm_g)
        jmaps = (jm[offset : offset + tb], jc[offset : offset + tb], jv[offset : offset + tb])
        block_ids = torch.arange(tb, device=gidx.device)
    else:
        if cfg.blocks % mesh.size:
            raise ValueError("cfg.blocks must divide by the number of ranks")
        bl = cfg.blocks // mesh.size
        mine = list(range(mesh.rank * bl, (mesh.rank + 1) * bl))
        jm, jc, jv = loopy._cavity_passes(model, cfg, params, map_poses, z_g, zm_g, mine, nm_g,
                                          contiguous=False)
        jmaps = (C.all_gather(mesh, jm), C.all_gather(mesh, jc), C.all_gather(mesh, jv))
        block_ids = gidx % cfg.blocks
    return loopy.fit_map_messages(model, cfg, params, state, pf_mean, pf_cov, jmaps, block_ids,
                                  z, z_mask, temperature, grad_clip, grad_rate)


def _gauge_fix_block(mesh, state: LoopyState):
    """The shear gauge fix (loopy.gauge_fix_shear) with psum'd moments."""
    _, gidx = _gidx(mesh, state)
    ts = torch.where(state.node_mask, gidx.to(state.fused_mean.dtype),
                     torch.zeros((), dtype=state.fused_mean.dtype, device=gidx.device))
    num = C.psum(mesh, torch.sum(ts[:, None] * state.fused_mean, dim=0))
    b = num / torch.clamp(C.psum(mesh, torch.sum(ts * ts)), min=1.0)
    fixed = state.fused_mean - ts[:, None] * b[None, :]
    return state._replace(fused_mean=torch.where(state.node_mask[:, None], fixed, state.fused_mean))


def make_sharded_sweep(model, cfg: loopy.LoopyConfig, mesh, causal=False, damping=0.6):
    """One block-parallel Jacobi sweep on this rank's block, the signature
    of loopy.make_sweep's sweep: (params, state, odometry, z, z_mask,
    temperature, grad_clip, grad_rate, motion_cov) -> state, with the
    [T, ...] axes of state / odometry / z / z_mask this rank's block
    (shard_loopy_inputs). Forward, backward, map messages, damping, the
    gauge fix and, when cfg.relinearize, the relinearisation (node-local)."""
    if cfg.max_nodes % mesh.size:
        raise ValueError("cfg.max_nodes must divide by the number of ranks")

    def sweep(params, state, odometry, z, z_mask, temperature, grad_clip, grad_rate, motion_cov):
        old_mean, old_cov = state.fused_mean, state.fused_cov
        state = _forward_block(model, mesh, state, odometry, motion_cov)
        state = _backward_block(model, mesh, state, odometry, motion_cov)
        state = _map_block(model, cfg, mesh, params, state, z, z_mask, temperature, grad_clip,
                           grad_rate, causal)
        if damping < 1.0:
            a = torch.as_tensor(damping, dtype=state.fused_mean.dtype)
            inew = gaussian.inv(state.fused_cov)
            iold = gaussian.inv(old_cov)
            cov = gaussian.inv(a * inew + (1 - a) * iold)
            vec = a * loopy._mv(inew, state.fused_mean) + (1 - a) * loopy._mv(iold, old_mean)
            state = state._replace(fused_mean=loopy._mv(cov, vec), fused_cov=cov)
        if cfg.gauge_fix:
            state = _gauge_fix_block(mesh, state)
        if cfg.relinearize:
            state = loopy.relinearize(model, state)
        return state

    return sweep
