"""Post-analysis error metrics: ATE, odometry drift, OSPA: the port's own
copy of monorfs_tpu.metrics.errors (NumPy only; reference:
postanalysis/Plot.cs:325-582). The OSPA metric uses an optimal
transport (Hungarian) assignment between the map estimate and the visited
groundtruth landmarks with cutoff C and exponent p, split into spatial and
cardinality terms.
"""

from typing import List, Tuple

import numpy as np


def hungarian(cost: np.ndarray) -> np.ndarray:
    """O(n^3) Hungarian algorithm (minimize); returns column assigned to each
    row. Dense replacement for GraphCombinatorics.LinearAssignment
    (GraphCombinatorics.cs:52-175)."""
    cost = np.asarray(cost, dtype=float)
    n, m = cost.shape
    size = max(n, m)
    if n != m:
        pad = np.full((size, size), cost.max() if cost.size else 0.0)
        pad[:n, :m] = cost
        cost = pad
    u = np.zeros(size + 1)
    v = np.zeros(size + 1)
    p = np.zeros(size + 1, dtype=int)
    way = np.zeros(size + 1, dtype=int)
    for i in range(1, size + 1):
        p[0] = i
        j0 = 0
        minv = np.full(size + 1, np.inf)
        used = np.zeros(size + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = np.inf
            j1 = -1
            cur_row = cost[i0 - 1]
            for j in range(1, size + 1):
                if not used[j]:
                    cur = cur_row[j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(size + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    assign = np.full(size, -1, dtype=int)
    for j in range(1, size + 1):
        if p[j] > 0:
            assign[p[j] - 1] = j - 1
    return assign[:n]


def ospa(estimate: np.ndarray, truth: np.ndarray, c: float, p: float = 1.0, dist=None):
    """OSPA(C, p) metric (Plot.cs:533-582).

    Returns (total, spatial, cardinality). Spatial = assignment cost over
    min-cardinality matching with distances clipped at C; cardinality =
    penalty C for each unmatched element; total = the usual OSPA mean with
    exponent p over the larger cardinality. dist: the [n, m] Euclidean
    distance table, when the caller has computed it already."""
    est = np.atleast_2d(np.asarray(estimate, float))
    tru = np.atleast_2d(np.asarray(truth, float))
    n, m = len(est) if est.size else 0, len(tru) if tru.size else 0
    if n == 0 and m == 0:
        return 0.0, 0.0, 0.0
    if n == 0 or m == 0:
        card = c ** p * max(n, m)
        total = (card / max(n, m)) ** (1.0 / p)
        return total, 0.0, total
    if dist is None:
        dist = np.linalg.norm(est[:, None, :] - tru[None, :, :], axis=-1)
    dist = np.minimum(dist, c) ** p
    if n <= m:
        assign = hungarian(dist)
        spatial = dist[np.arange(n), assign].sum()
    else:
        assign = hungarian(dist.T)
        spatial = dist.T[np.arange(m), assign].sum()
    card = c ** p * abs(n - m)
    total = ((spatial + card) / max(n, m)) ** (1.0 / p)
    return total, (spatial / max(n, m)) ** (1.0 / p), (card / max(n, m)) ** (
        1.0 / p
    )


def _interp_state(traj: List[Tuple[float, np.ndarray]], t: float):
    """Nearest-previous interpolation of a timed trajectory."""
    times = np.array([x[0] for x in traj])
    idx = np.searchsorted(times, t, side="right") - 1
    idx = np.clip(idx, 0, len(traj) - 1)
    return traj[idx][1]


def align_at(estimate, truth, reftime):
    """Rigidly align the estimate to groundtruth at the pose nearest
    `reftime` (postanalysis -t flag, Program.cs:67 + Plot.cs:99-101): the
    reference computes every ATE value relative to the reference-index pose
    (error_i = diff(g_i - g_ref, e_i - e_ref), Plot.cs:371-404), which is
    equivalent to re-anchoring the estimate at that pose. Linear states are
    translated; 7-state poses are rotated about the reference pose by the
    quaternion correction and translated."""
    if not estimate:
        return estimate
    idx = min(
        range(len(estimate)), key=lambda i: abs(estimate[i][0] - reftime)
    )
    e_ref = np.asarray(estimate[idx][1], float)
    g_ref = np.asarray(_interp_state(truth, estimate[idx][0]), float)
    if len(e_ref) >= 7 and len(g_ref) >= 7:
        q_corr = _quat_mul(g_ref[3:7], _quat_conj(e_ref[3:7]))
        q_corr = q_corr / np.linalg.norm(q_corr)
        rot = _quat_to_matrix(q_corr)
        out = []
        for t, s in estimate:
            s = np.asarray(s, float)
            loc = g_ref[:3] + rot @ (s[:3] - e_ref[:3])
            quat = _quat_mul(q_corr, s[3:7])
            out.append((t, np.concatenate([loc, quat, s[7:]])))
        return out
    d = min(len(e_ref), len(g_ref))
    delta = g_ref[:d] - e_ref[:d]
    return [
        (t, np.asarray(s, float)[:d] + delta) for t, s in estimate
    ]


def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def ate_location(estimate, truth, reftime=None):
    """Per-frame location error estimate vs time-aligned groundtruth
    (Plot.cs:371-387). Both are [(t, state)]; locations are state[:3] (or the
    full state for linear models). reftime (seconds) aligns the estimate to
    groundtruth at that pose first (the -t flag semantics)."""
    if reftime is not None:
        estimate = align_at(estimate, truth, reftime)
    out = []
    for t, s in estimate:
        g = _interp_state(truth, t)
        d = min(len(s), len(g), 3)
        out.append((t, float(np.linalg.norm(s[:d] - g[:d]))))
    return out


def _quat_angle(qa, qb):
    dq = abs(float(np.dot(qa, qb)))
    dq = min(dq, 1.0)
    return 2.0 * np.arccos(dq)


def ate_rotation(estimate, truth, reftime=None):
    """Per-frame rotation error (quaternion geodesic angle) for 7-state
    poses; zero for linear models (Plot.cs:389-404)."""
    if reftime is not None:
        estimate = align_at(estimate, truth, reftime)
    out = []
    for t, s in estimate:
        g = _interp_state(truth, t)
        if len(s) >= 7 and len(g) >= 7:
            out.append((t, _quat_angle(s[3:7], g[3:7])))
        else:
            out.append((t, 0.0))
    return out


def rmse(series):
    vals = np.array([v for _, v in series])
    return float(np.sqrt(np.mean(vals**2))) if len(vals) else 0.0


def path_length(traj):
    """Cumulative travelled distance (Plot.cs:273-291)."""
    locs = np.array([s[:3] if len(s) >= 3 else s for _, s in traj])
    if len(locs) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(np.diff(locs, axis=0), axis=1)))
