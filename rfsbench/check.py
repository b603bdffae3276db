"""What decides `correct`: the frames the window sampled, worked out again by
the reference (reference/frame.py) and held against what the port's timed
step produced.

The reference works in the configuration's `reference_dtype` (float64, one
step above the configuration's float32). The filter resamples, so two
float32 runs part ways after a few frames; the reference therefore follows
the port frame by frame from the state the port started the frame from, and
checks that start by itself at each sequence's first frame (the filter's
initial state). Within a frame it follows stage by stage: the weight inputs
of a particle whose corrected map the port handed on start from that map,
and the correct stage is judged by itself (`map`). Four numbers, each the
largest over the sampled frames:

  meas    the simulated vehicle's true pose, noisy odometry and measurement
          set (from the true pose the frame started at); relative gaps, 1
          where a measurement is missing or extra;
  pose    every particle's pose against the reference's prediction of the
          particle it was drawn from (relative gap); at a first frame also
          the initial state;
  weight  normalise and resample, in units of 1/P. Where the port resampled:
          the largest gap between the offspring count of a particle and the
          count that the systematic draw gives on the reference's weights
          with the same uniform (ancestors out of order: BRANCH); otherwise
          P times the largest gap of a normalised weight. And the best
          particle's weight gap. BRANCH where the port took the other branch
          of the ESS test. A particle the port did not draw and whose MAP
          estimate nearly ties (mixture.map_margin under the traffic's
          `tie`) is held at 1/P where the reference gives it more: float32
          may have chosen the other estimate, which moves its weight by a
          factor, and a particle not drawn took under 1/P;
  map     each particle's corrected map against the reference's map of its
          source particle: live counts (1 where they differ), log-weights in
          weight order, each mean against the nearest unused reference mean
          (absolute, map units) and its covariance (relative); a quantile
          over particles.

The map's quantile lets a particle or two whose float32 arithmetic lands on
the other side of a threshold (a merge, the MaxQuantity cut) through; the
traffic file gives the quantile with the limits."""

import numpy as np
import torch

from . import harness
from .reference import frame as ref
from .reference.mixture import DEAD, SGM

BRANCH = 1000.0  # the weight number for another ESS branch or ancestors out of order
NUMBERS = ("meas", "pose", "weight", "map")
DIAGNOSTICS = ("weight_gap", "weight_best", "tied", "free", "resampled", "live")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((torch.abs(a - b) / torch.clamp(torch.abs(b), min=1.0)).max()) if a.numel() else 0.0


def meas_gap_vehicle(prog, want):
    """prog / want: (true pose, noisy odometry, z [L+C, D], mask)."""
    (tp, nz, z, m), (tr, nr, zr, mr) = prog, want
    if not torch.equal(m.cpu(), mr.cpu()):
        return 1.0
    return max(_rel(tp, tr), _rel(nz, nr), _rel(z[m], zr[mr]))


def pose_gap(post_pose, want_pose, ancestor):
    return _rel(post_pose, want_pose[ancestor.to(want_pose.device)])


def start_gap(pre, start):
    """The filter's first state against the reference's."""
    gap = max(_rel(pre.pose, start["pose"]), _rel(pre.logweight, start["logweight"]))
    live = (pre.maps.logw > DEAD / 2).any()
    return max(gap, 1.0 if bool(live) else 0.0)


def port_maps(post, p):
    """The port's corrected map of every particle that its step handed on:
    (SGM [P, K] with each particle's map at its own slot, held [P] bool).
    A particle the resample drew is found at the first slot it was drawn
    into; one it did not draw is not held."""
    anc = post.ancestor
    first = torch.full((p,), p, dtype=torch.int64, device=anc.device)
    first.scatter_reduce_(0, anc, torch.arange(p, device=anc.device), reduce="amin")
    held = first < p
    take = torch.clamp(first, max=p - 1)
    return SGM(*[leaf[take] for leaf in post.maps]), held


def weight_values(post, out, p, resample_u, tie):
    """(the weight gap, the best particle's gap, diagnostics) in units of
    1/P (see the module's `weight`)."""
    w = torch.exp(out["logweight"])
    dev = w.device
    lw = post.logweight.double().to(dev)
    anc = post.ancestor.to(dev)
    ar = torch.arange(p, device=dev)
    uniform = torch.full_like(lw, float(torch.tensor(-np.log(p), dtype=post.logweight.dtype)))
    resampled = bool(torch.equal(lw, uniform))
    near = abs(out["ess"] - out["ess_threshold"]) <= 1e-3 * out["ess_threshold"]
    tied = out["margin"].to(dev) < tie
    info = dict(tied=int(tied.sum()), free=0)
    if (resampled != out["depleted"] and not near) or (not resampled and not torch.equal(anc, ar)):
        return BRANCH, BRANCH, info
    if not resampled:
        gap = p * float(torch.abs(torch.exp(lw) - w).max())
        return gap, p * float(w.max() - w[int(post.best)]), info
    if bool((anc[1:] < anc[:-1]).any()):  # the systematic draw hands its slots on in order
        return BRANCH, BRANCH, info
    n = torch.bincount(anc, minlength=p)
    # a particle not drawn took under 1/P of the weight; where the reference
    # gives it more and its MAP estimate nearly ties, float32 may have chosen
    # the other estimate: hold it at 1/P
    free = tied & (n == 0) & (w > 1.0 / p)
    info["free"] = int(free.sum())
    w = torch.where(free, torch.full_like(w, 1.0 / p), w)
    w = w / w.sum()
    want = torch.bincount(ref.systematic(w, resample_u.to(dev)), minlength=p)
    gap = float(torch.abs(n - want).max())
    drawn = torch.where(n > 0, w, torch.zeros_like(w))
    best = p * float(drawn.max() - w[int(anc[int(post.best)])])
    return gap, best, info


def map_values(post_maps, want_maps, ancestor, block=250):
    """Per-particle map gaps [P] (see the module's `map`)."""
    p = post_maps.logw.shape[0]
    out = []
    for lo in range(0, p, block):
        rows = slice(lo, min(p, lo + block))
        g = torch.stack([leaf[rows].double() for leaf in post_maps], -1)
        dev = g.device
        r = torch.stack([leaf[ancestor[rows].to(leaf.device)].double() for leaf in want_maps], -1).to(dev)
        out.append(_map_block(g, r))
    return torch.cat(out)


def _by_weight(x, alive):
    key = torch.where(alive, x[..., 9], torch.full_like(x[..., 9], -float("inf")))
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices
    return torch.gather(x, 1, idx[..., None].expand_as(x))


def _map_block(g, r):
    g_live, r_live = g[..., 9] > DEAD / 2, r[..., 9] > DEAD / 2
    n, n_ref = g_live.sum(1), r_live.sum(1)
    g, r = _by_weight(g, g_live), _by_weight(r, r_live)
    pb, k = g.shape[:2]
    slot = torch.arange(k, device=g.device)[None, :] < n[:, None]
    gap = torch.where(slot, torch.abs(g[..., 9] - r[..., 9]), 0.0).amax(1)
    used = ~(torch.arange(k, device=g.device)[None, :] < n_ref[:, None])
    rows = torch.arange(pb, device=g.device)
    for j in range(int(n.max()) if pb else 0):
        act = j < n
        d = torch.linalg.norm(r[..., :3] - g[:, j:j + 1, :3], dim=-1) + torch.where(used, 1e30, 0.0)
        jj = torch.argmin(d, dim=1)
        used[rows[act], jj[act]] = True
        m = r[rows, jj]
        dm = torch.abs(g[:, j, :3] - m[:, :3]).amax(1)
        scale = torch.clamp(torch.abs(m[:, 3:9]).amax(1), min=1e-30)
        dc = torch.abs(g[:, j, 3:9] - m[:, 3:9]).amax(1) / scale
        gap = torch.where(act, torch.maximum(gap, torch.maximum(dm, dc)), gap)
    return torch.where(n == n_ref, gap, torch.ones_like(gap))


def quantile(values, q):
    return float(torch.quantile(values.double().cpu(), q, interpolation="higher"))


class Judge:
    """Works out the sampled frames again and keeps, per number, the largest
    reading over them (and every frame's, for the readings tool)."""

    def __init__(self, inputs, limits, device):
        config = inputs.config
        dtype = harness.dtype_of(dict(dtype=config["reference_dtype"]))
        self.inputs, self.limits, self.device, self.dtype = inputs, limits, device, dtype
        self.config = config
        self.model = ref.pose_model(config)
        self.cfg = ref.phd_config(config, inputs.particles)
        self.params = ref.phd_params(config, dtype, device)
        self.vparams = ref.vehicle_params(config, self.model, dtype, device)
        lm = np.zeros((inputs.landmarks, 3))
        lm[: len(inputs.world.landmarks)] = inputs.world.landmarks
        self.landmarks = torch.as_tensor(lm, dtype=dtype, device=device)
        self.frames = []

    def frame(self, seq, t, draws_t, cap, candidate=None):
        """Judge frame t of sequence seq. cap: the port's capture (see
        harness.Capture); candidate: a stand-in for what the port produced
        (the control): dict(vehicle=(noisy, z, mask), true_post, post)."""
        inp, config, dt, dev = self.inputs, self.config, self.dtype, self.device
        prod = candidate or cap
        noisy, z, mask = prod["vehicle"]
        want = ref.vehicle_frame(config, self.model, self.vparams, cap["true_pre"].to(dev, dt),
                                 self.landmarks, inp.commands[t], draws_t)
        meas = meas_gap_vehicle((prod["true_post"], noisy, z, mask), want)
        pre, post = cap["pre"], prod["post"]
        p = inp.particles
        state = dict(pose=pre.pose.to(dev, dt), logweight=pre.logweight.to(dev, dt),
                     maps=SGM(*[leaf.to(dev, dt) for leaf in pre.maps]))
        corrected_in, held = port_maps(post, p)
        out = ref.slam_frame(config, self.model, self.cfg, self.params, state, noisy.to(dev), z.to(dev),
                             mask.to(dev), draws_t["motion_normals"].to(dev), draws_t["resample_u"].to(dev),
                             corrected_in=SGM(*[leaf.to(dev) for leaf in corrected_in]), held=held.to(dev))
        pose = pose_gap(post.pose.to(dev), out["pose"], post.ancestor)
        if t == 0:
            start = ref.init_state(config, p, inp.world.pose, dt, dev)
            pose = max(pose, start_gap(pre, start))
        gap, best, info = weight_values(post, out, p, draws_t["resample_u"], self.limits["weight"]["tie"])
        per_m = map_values(post.maps, out["maps"], post.ancestor)
        row = dict(seq=seq, t=t, meas=meas, pose=pose, weight=max(gap, best), weight_gap=gap,
                   weight_best=best, map=quantile(per_m, self.limits["map"]["quantile"]),
                   map_q={q: quantile(per_m, q) for q in (0.99, 0.995, 0.999, 1.0)},
                   resampled=out["depleted"], live=int((out["maps"].logw > DEAD / 2).sum(1).max()), **info)
        self.frames.append(row)
        return row, out

    def numbers(self):
        """{name: (largest reading, limit)} over the judged frames."""
        return {name: (max((f[name] for f in self.frames), default=float("nan")), self.limits[name]["limit"])
                for name in NUMBERS}

    def correct(self):
        nums = self.numbers()
        return bool(self.frames) and all(v <= lim for v, lim in nums.values())


def control_candidate(judge, seq, t, draws_t, cap, dtype=torch.bfloat16, tf32=False):
    """The control: the reference itself in the port's place, from the same
    start, computed in `dtype` (bfloat16: the precision below the
    configuration's float32 for a path with no matrix product to speak of;
    see PERF.md), or in float32 with TF32 matrix products (tf32=True)."""
    inp, config, dev, model = judge.inputs, judge.config, judge.device, judge.model
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = ref.phd_params(config, dtype, dev)
        vp = ref.vehicle_params(config, model, dtype, dev)
        true_post, noisy, z, mask = ref.vehicle_frame(
            config, model, vp, cap["true_pre"].to(dev, dtype), judge.landmarks.to(dtype),
            inp.commands[t], draws_t)
        pre = cap["pre"]
        state = dict(pose=pre.pose.to(dev, dtype), logweight=pre.logweight.to(dev, dtype),
                     maps=SGM(*[leaf.to(dev, dtype) for leaf in pre.maps]))
        out = ref.slam_frame(config, model, judge.cfg, params, state, noisy, z, mask,
                             draws_t["motion_normals"], draws_t["resample_u"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    nxt = out["next"]

    class Post:
        pose, logweight, maps = nxt["pose"], nxt["logweight"], nxt["maps"]
        ancestor, best = nxt["ancestor"], nxt["best"]

    return dict(vehicle=(noisy, z, mask), true_post=true_post, post=Post)


def sample(inputs, traffic, seed):
    """The sampled frames, (sequence, frame) pairs drawn from the seed: the
    first frame of the first sequence (the filter's start), and
    `traffic.check.frames` more from the first `traffic.check.sequences`
    sequences."""
    chk = traffic["check"]
    rng = np.random.default_rng(harness.seq_seed(seed, 0, 3))
    pool = [(s, t) for s in range(chk["sequences"]) for t in range(1, inputs.frames)]
    pick = rng.choice(len(pool), size=min(chk["frames"], len(pool)), replace=False)
    return sorted({(0, 0)} | {pool[i] for i in pick})
