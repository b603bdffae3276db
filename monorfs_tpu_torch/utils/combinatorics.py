"""Assignment combinatorics: connected components, k-best assignments (the
torch twin of monorfs_tpu.utils.combinatorics).

The reference's GraphCombinatorics toolbox
(mono-rfs-lib/Maths/GraphCombinatorics.cs:42-792): Hungarian linear
assignment (metrics.errors.hungarian), Murty's lazy k-best assignment
enumeration (:241-272), lexicographical enumeration (:280-334) and
connected-component partitioning (:358-425).

The PHD step uses the fixed-shape beam search (slam/association.py) instead;
the host-side NumPy versions here serve the graph navigator, OSPA, tests and
any small offline problem. `connected_components_jax` keeps its name from the
JAX package and is a tensor function: label propagation on the device."""

import heapq
import itertools

import numpy as np
import torch

from ..metrics.errors import hungarian  # noqa: F401 (re-export)

NEG = -1.0e30


def connected_components_jax(adjacency, iterations=None):
    """Label propagation on an [N, N] bool adjacency tensor: returns [N]
    int64 labels (the minimum reachable index), after a fixed number of
    sweeps."""
    n = adjacency.shape[0]
    dev = adjacency.device
    adj = adjacency | torch.eye(n, dtype=torch.bool, device=dev)
    labels = torch.arange(n, device=dev)
    big = torch.full((), n, dtype=labels.dtype, device=dev)
    iters = iterations or max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    for _ in range(iters):
        gathered = torch.where(adj, labels[None, :], big)
        labels = torch.minimum(labels, gathered.amin(dim=1))
        # propagate through the transpose too (undirected closure)
        gathered_t = torch.where(adj.T, labels[None, :], big)
        labels = torch.minimum(labels, gathered_t.amin(dim=1))
    return labels


def connected_components(profit):
    """Partition a sparse profit matrix (entries > NEG are edges) into
    connected bipartite components (GraphCombinatorics.cs:358-425).

    Returns a list of (rows, cols) index arrays."""
    profit = np.asarray(profit)
    n, m = profit.shape
    edges = profit > NEG / 2
    # union-find over rows+cols
    parent = list(range(n + m))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    rs, cs = np.nonzero(edges)
    for r, c in zip(rs, cs):
        union(r, n + c)
    groups = {}
    for r in range(n):
        if edges[r].any():
            groups.setdefault(find(r), [[], []])[0].append(r)
    for c in range(m):
        if edges[:, c].any():
            groups.setdefault(find(n + c), [[], []])[1].append(c)
    return [
        (np.asarray(v[0], int), np.asarray(v[1], int))
        for v in groups.values()
        if v[0] or v[1]
    ]


def assignment_value(profit, assignment):
    """Sum of profits along an assignment (GraphCombinatorics.cs:183-197)."""
    return float(sum(profit[i, j] for i, j in enumerate(assignment)))


def murty(profit, k=None):
    """Murty's k-best assignment enumeration on a square profit matrix
    (maximize; GraphCombinatorics.cs:241-272 with lazy priority queue).

    Yields (assignment, value) in descending value order."""
    profit = np.asarray(profit, float)
    n = profit.shape[0]

    def solve(forced, banned):
        p = profit.copy()
        for i, j in banned:
            p[i, j] = NEG
        for i, j in forced.items():
            p[i, :] = NEG
            p[i, j] = profit[i, j]
        assign = hungarian(-p)
        val = sum(p[i, assign[i]] for i in range(n))
        if val < NEG / 2:
            return None, -np.inf
        return assign, float(val)

    count = 0
    heap = []
    a0, v0 = solve({}, [])
    if a0 is None:
        return
    heapq.heappush(heap, (-v0, count, a0, {}, []))
    count += 1
    emitted = set()
    while heap and (k is None or len(emitted) < k):
        nv, _, assign, forced, banned = heapq.heappop(heap)
        key = tuple(assign)
        if key in emitted:
            continue
        emitted.add(key)
        yield np.asarray(assign), -nv
        # partition (Murty subdivision)
        new_forced = dict(forced)
        for i in range(n):
            if i in forced:
                continue
            nb = banned + [(i, assign[i])]
            a, v = solve(new_forced, nb)
            if a is not None:
                heapq.heappush(heap, (-v, count, a, dict(new_forced), nb))
                count += 1
            new_forced[i] = assign[i]


def lexicographical_pairing(profit, nlandmarks):
    """Exhaustive enumeration of assignments on a (padded square) profit
    matrix (GraphCombinatorics.cs:280-334). Yields (assignment, value)."""
    profit = np.asarray(profit, float)
    n = profit.shape[0]
    for perm in itertools.permutations(range(n)):
        val = 0.0
        ok = True
        for i, j in enumerate(perm):
            if profit[i, j] < NEG / 2:
                ok = False
                break
            val += profit[i, j]
        if ok:
            yield np.asarray(perm), val
