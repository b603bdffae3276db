"""Linear assignment on the device: a synchronous (Jacobi) auction with
epsilon-scaling [Bertsekas 1988] over the dense padded profit matrix (the
torch twin of monorfs_tpu.slam.assignment).

The reference solves its data-association profit matrix with a host
Hungarian (GraphCombinatorics.LinearAssignment, GraphCombinatorics.cs:52-175
via ISAM2Navigator.FindLabels, ISAM2Navigator.cs:256-441); the scan runner
(slam/isam2_scan_da.py) keeps the matrix on the device and solves it here.

Properties:
  * maximizes total profit to within S*eps of the optimum (ties may resolve
    differently from the Hungarian);
  * all rows end assigned to distinct columns (a permutation) when the
    iteration cap suffices; unconverged rows return -1 (callers treat
    unassigned source rows as misses);
  * rows bid in parallel, columns accept the best bid, prices only rise
    within a phase. Epsilon-scaling (coarse-to-fine bid increments, prices
    carried across phases) avoids the price war when many rows value tied
    columns equally.

Each iteration's stopping test (`any row unassigned`) is one read of a flag
from the device; `stats` counts the iterations of each phase and the reads.
Ties resolve to the lowest index, by an explicit rank: torch.argmax on CUDA
does not promise the first maximum.
"""

import torch
from torch.profiler import record_function

# Forbidden-pair profit. Deliberately moderate: with a -1e20 sentinel the
# auction's bid increments (v1 - v2 can reach the sentinel scale) drive
# column prices to ~1e20, where float eps-increments are absorbed and all
# values collapse to the sentinel. -1e4 is far below any real log-likelihood
# profit while keeping prices in a range where eps-bids still resolve in
# float32.
NEG = -1e4
MAX_JUMP = 2e4  # bid-increment clamp (> any finite-profit span incl. NEG)


def first_argmax(values, dim):
    """(max, lowest index holding it) along `dim`."""
    vmax = values.amax(dim=dim, keepdim=True)
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    idx = torch.arange(n, device=values.device).view(shape)
    first = torch.where(values == vmax, idx, n).amin(dim=dim)
    return vmax.squeeze(dim), first


def _auction_phase(profit, price, eps, max_iters, stats):
    s = profit.shape[0]
    dev = profit.device
    rows = torch.arange(s, device=dev)
    neg_inf = torch.full((), -float("inf"), dtype=profit.dtype, device=dev)
    col = torch.full((s,), -1, dtype=torch.int64, device=dev)
    owner = torch.full((s,), -1, dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        unassigned = col < 0
        if stats is not None:
            stats["reads"] += 1
        if not bool(unassigned.any()):  # a read from the device
            break
        values = profit - price[None, :]  # [S, S]
        v1, best = first_argmax(values, 1)
        masked = torch.where(rows[None, :] == best[:, None], neg_inf, values)
        v2 = masked.amax(dim=1)
        v2 = torch.where(torch.isfinite(v2), v2, v1 - 1.0)  # s=1 guard
        # clamp the increment: a jump beyond the finite-profit span already
        # guarantees the row keeps the column; larger jumps only push prices
        # toward float-absorption territory
        bid = price[best] + torch.clamp(v1 - v2, max=MAX_JUMP) + eps  # [S]

        # columns accept the highest bid among unassigned bidders
        bid_matrix = torch.where(
            unassigned[:, None] & (best[:, None] == rows[None, :]), bid[:, None], neg_inf
        )  # [S rows, S cols]
        col_best_bid, col_winner = first_argmax(bid_matrix, 0)
        has_bid = col_best_bid > neg_inf

        # outbid previous owners lose their column; rebuild row->col from
        # the column ownership (single source of truth). Owners are distinct,
        # unowned columns write to the cut-off slot s.
        owner = torch.where(has_bid, col_winner, owner)
        price = torch.where(has_bid, col_best_bid, price)
        ext = torch.full((s + 1,), -1, dtype=torch.int64, device=dev)
        ext[torch.where(owner >= 0, owner, s)] = torch.where(owner >= 0, rows, -1)
        col = ext[:s]
        it += 1
    if stats is not None:
        stats["iterations"].append(it)
    return col, price


@record_function("graph.auction")
def auction_assign(profit, eps=1e-3, max_iters=400, scale_from=16.0, scale_factor=8.0,
                   stats=None):
    """Maximize sum_i profit[i, col_i] over permutations.

    profit: [S, S] (use finite NEG, not -inf, for forbidden pairs; every row
    should have at least one reasonable column, e.g. a miss slot). Returns
    col [S] int64 (the assignment; -1 for rows still unassigned at the
    iteration cap; callers treat those as misses).

    Epsilon-scaling: phases run the auction at eps = scale_from,
    scale_from/scale_factor, ... down to `eps`, carrying prices forward
    (assignments reset each phase). `stats`, when given, is a dict with
    "iterations" (a list, one entry appended per phase) and "reads" (the
    count of flags read from the device)."""
    s = profit.shape[0]
    price = torch.zeros((s,), dtype=profit.dtype, device=profit.device)
    e = float(scale_from)
    while e > eps:
        _, price = _auction_phase(profit, price, e, max_iters, stats)
        e /= scale_factor
    col, _ = _auction_phase(profit, price, eps, max_iters, stats)
    return col
