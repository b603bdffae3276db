"""The weight stage's association options for all particles (kernel:
csrc/assoc_options.cu). It replaces no Pallas kernel: in the JAX package the
stage is XLA (monorfs_tpu/slam/phd.py's weight inputs).

assoc_options launches the CUDA kernel for CUDA tensors and runs
assoc_options_plain, the same function in plain PyTorch, for CPU tensors.
They give the same opt_delta, word_k and bit_k bit for bit; base, the sum of
the valid MAP rows' log miss, differs only in the order of that sum
(csrc/assoc_options.cu's note). The Kinect model's depth-occlusion
visibility reads the live depth image, which no other model does: it takes
the plain version (phd.route), as it takes the XLA-semantics correct stage."""

import ctypes
import functools

import torch

from .. import _build
from ..gm import smallmat
from . import association

# csrc/assoc_options.cu's constants of the launch shape
_THREADS = 256
_CMAX = 32  # the largest candidate list a thread keeps


def live_first(z_mask, n):
    """Indices of the first n slots in live-first stable order."""
    return torch.argsort((~z_mask).to(torch.uint8), stable=True)[:n]


def assoc_options_plain(model, cfg, params, pose, jmeans, jvalid, z, z_mask, packed=None):
    """The association beam's option tensors (PHDNavigator.cs:415-453) of
    every particle: pose [P, S]; the MAP means jmeans (3-list of [P, E]) over
    the rows jvalid [P, E] holds; the step's measurement slots z [Mz, D] and
    z_mask [Mz]. Returns (base [P], opt_delta [P, M, C+1], word_k [P, M, C]
    int32, bit_k [P, M, C] int32) with M = min(beam_meas_cap or Mz, Mz) and
    C = min(beam_candidates, E) (association.prepare_options). packed, the
    kernel's parameter vector, is not read."""
    mp = model.params
    # valid measurements first, capped at the beam length
    order = live_first(z_mask, cfg.beam_meas_cap or z.shape[0])
    zc = torch.where(torch.isfinite(z), z, torch.zeros_like(z))[order]
    zc_mask = z_mask[order]

    # gated association log-likelihood [P, E, M] (PHDNavigator.cs:415-453)
    mu = model.measure_soa(mp, pose, jmeans)
    pdv = model.fuzzy_visible_soa_fn(params.depth_map)(mp, mu, params.visibility_ramp) * params.pd
    pdv = torch.clamp(pdv, 1e-30, 1.0 - 1e-7)
    log_pd, log_miss = torch.log(pdv), torch.log1p(-pdv)
    r = smallmat.from_tensor(params.meas_cov)
    det_r = smallmat.det(r)
    r_inv = smallmat.inv(r, det_r)
    logmult = smallmat.log_multiplier(r, det_r)
    diffz = [zc[:, i][None, None, :] - mi[:, :, None] for i, mi in enumerate(mu)]
    d2 = smallmat.quadform(diffz, r_inv)
    ll = log_pd[..., None] + logmult - 0.5 * d2
    neg = torch.full_like(ll, association.NEG)
    ll = torch.where(d2 < 25.0, ll, neg)  # Mahalanobis gate 5
    ll = torch.where(zc_mask[None, None, :], ll, neg)
    base, od, wk, bk, _ = association.prepare_options(
        ll, log_miss, torch.log(params.clutter_density), jvalid, zc_mask,
        cfg.beam_candidates,
    )
    return base, od, wk, bk


def pack_params(model, params):
    """PHDParams -> flat [3 + D + D*D] f32 (layout read by
    csrc/assoc_options.cu): log clutter density, PD, the measurement
    covariance's log-multiplier, the visibility ramp [D] and the
    covariance's inverse [D, D], computed by smallmat's functions as the
    plain version computes them, so both read the same numbers."""
    d = model.meas_dim
    r = smallmat.from_tensor(params.meas_cov)
    det_r = smallmat.det(r)
    r_inv = smallmat.inv(r, det_r)
    parts = [torch.log(params.clutter_density), params.pd, smallmat.log_multiplier(r, det_r),
             params.visibility_ramp[:d]] + [x for row in r_inv for x in row]
    return torch.cat([x.reshape(-1).to(torch.float32) for x in parts])


def launch_shape(e, m, mz, d):
    """(particles a block takes, shared memory bytes it asks for) at this
    shape: the Python copy of assoc_options_particles_per_block and
    assoc_options_smem_bytes. A block takes 256 // M particles (at least
    one), fewer where their landmark tables ((D + 2) fields of E + 1 words
    each) beside the rows' and the slots' words do not fit its shared
    memory; (0, 0) where one particle's do not (E past ~9,000 at D = 3)."""
    words, fixed, per = _build.SMEM_LIMIT // 4, m + mz, (d + 2) * (e + 1)
    if fixed + per > words:
        return 0, 0
    pb = min(_THREADS // m if 0 < m < _THREADS else 1, (words - fixed) // per)
    return pb, 4 * (pb * per + fixed)


@functools.cache
def particles_per_block(e, m, mz, d):
    """assoc_options_particles_per_block of the built library (on the card)."""
    fn = _build.function("assoc_options_particles_per_block", [ctypes.c_int] * 4)
    return fn(e, m, mz, d)


@functools.cache
def smem_bytes(e, m, mz, d):
    """assoc_options_smem_bytes of the built library (on the card)."""
    fn = _build.function("assoc_options_smem_bytes", [ctypes.c_int] * 4, ctypes.c_size_t)
    return fn(e, m, mz, d)


@functools.cache
def _launcher():
    return _build.function(
        "assoc_options_launch",
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_float] * 8 + [ctypes.c_void_p] * 5,
    )


def _check(model, cfg, pose, jmeans, jvalid, z, z_mask):
    """Raise on what the kernel does not take; returns (M, C)."""
    if model.kernel_params is None:
        raise ValueError(f"the association kernel takes no {model.name} model")
    p, e = jvalid.shape
    d, s = model.meas_dim, model.pose.state_dim
    dev = jvalid.device
    for name, t, dt, shape in (("pose", pose, torch.float32, (p, s)), ("jvalid", jvalid, torch.bool, (p, e)),
                               ("z", z, torch.float32, (z.shape[0], d)),
                               ("z_mask", z_mask, torch.bool, (z.shape[0],))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    strides = jmeans[0].stride()
    for i, x in enumerate(jmeans):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (p, e) or x.stride() != strides:
            raise ValueError(f"jmeans[{i}]: expected float32 {(p, e)} on {dev} with strides {strides}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device} with strides {x.stride()}")
    mz = z.shape[0]
    m, c = min(cfg.beam_meas_cap or mz, mz), min(cfg.beam_candidates, e)
    if c > _CMAX or launch_shape(e, m, mz, d)[0] < 1:
        raise ValueError(f"the association kernel takes no E={e} M={m} slots={mz} C={c} at D={d}: "
                         f"C past {_CMAX} or a landmark table past a block's shared memory")
    return m, c


def assoc_options(model, cfg, params, pose, jmeans, jvalid, z, z_mask, packed=None):
    """assoc_options_plain for CPU tensors; for CUDA tensors one launch of
    the kernel. Either raises on what the kernel does not take: pose [P, S],
    jvalid [P, E], z [Mz, D] and z_mask [Mz] contiguous, float32 and bool;
    jmeans 3 float32 [P, E] sharing one stride (views of one [P, E, 3]
    tensor too); C up to 32; E up to what a block's shared memory holds.
    packed: pack_params(model, params) on the device, when the caller keeps
    it across calls."""
    m, c = _check(model, cfg, pose, jmeans, jvalid, z, z_mask)
    dev = jvalid.device
    if dev.type == "cpu":
        return assoc_options_plain(model, cfg, params, pose, jmeans, jvalid, z, z_mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    d = model.meas_dim
    prm = pack_params(model, params) if packed is None else packed
    if prm.device != dev or prm.dtype != torch.float32 or prm.shape != (3 + d + d * d,):
        raise ValueError(f"packed params: expected float32 ({3 + d + d * d},) on {dev}")
    p, e = jvalid.shape
    base = torch.empty((p,), dtype=torch.float32, device=dev)
    od = torch.empty((p, m, c + 1), dtype=torch.float32, device=dev)
    wk = torch.empty((p, m, c), dtype=torch.int32, device=dev)
    bk = torch.empty((p, m, c), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            d, prm.data_ptr(), pose.data_ptr(), *[x.data_ptr() for x in jmeans], *jmeans[0].stride(),
            jvalid.data_ptr(), z.data_ptr(), z_mask.data_ptr(), z.shape[0], p, e, m, c,
            *model.kernel_params(model.params), base.data_ptr(), od.data_ptr(), wk.data_ptr(), bk.data_ptr(),
            stream,
        )
    _build.check(err, "assoc_options_launch")
    assoc_options.launches += 1
    return base, od, wk, bk


assoc_options.launches = 0
