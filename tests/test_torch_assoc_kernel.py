"""The weight stage's association options (slam/assoc_kernel.py): the plain
version is the code the weight inputs ran before the kernel, bit for bit,
for the three model families in float32 and float64 at the main path's
shapes and on the edge cases the kernel is held to on the card
(kernel_cases.ASSOC_CASES: ties, no gated pair, no valid MAP row, dead
slots); the wrapper runs it for CPU tensors and raises on what the kernel
does not take; the step's `kernels` switch (phd.route, tests/test_torch_route.py);
the Python copy of the kernel's launch shape.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it to
assoc_options_plain on the same cases."""

import pytest
import torch

from monorfs_tpu_torch import _build
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm import smallmat
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.kernel_cases import ASSOC_CASES, assoc_case, fused_state
from monorfs_tpu_torch.models import get as get_model
from monorfs_tpu_torch.slam import assoc_kernel, association, fused_kernel, phd
from monorfs_tpu_torch.slam.assoc_kernel import assoc_options, assoc_options_plain

DTYPES = [torch.float32, torch.float64]


def _params(model_name, dtype=torch.float32):
    conf = Config()
    conf.set_model_defaults(model_name)
    return conf.phd_params(dtype, "cpu")


def _inputs(name, dtype=torch.float32, seed=0):
    """(model, cfg, params, pose, jmeans, jvalid, z, z_mask) of a case."""
    mname, p, e, mz, n_live, cap, c, kw = ASSOC_CASES[name]
    pose, jm, jv, z, zm = assoc_case(seed, p, e, mz, n_live, model=mname, **kw)
    cfg = phd.PHDConfig(num_particles=p, estimate_cap=e, max_measurements=mz, beam_meas_cap=cap,
                        beam_candidates=c)
    as_t = lambda x, dt=dtype: torch.as_tensor(x, dtype=dt)  # noqa: E731
    jm = as_t(jm).permute(1, 2, 0).contiguous()  # [P, E, 3], as the weight inputs' gather
    return (get_model(mname), cfg, _params(mname, dtype), as_t(pose), [jm[..., i] for i in range(3)],
            as_t(jv, torch.bool), as_t(z), as_t(zm, torch.bool))


def _before(model, cfg, params, pose, jmeans, jvalid, z, z_mask):
    """The weight inputs' association lines before the kernel
    (phd.weight_inputs' `phd.weight_inputs.assoc` range), as they stood."""
    mp = model.params
    # valid measurements first, capped at the beam length
    order = torch.argsort((~z_mask).to(torch.uint8), stable=True)[: cfg.beam_meas_cap or z.shape[0]]
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(ASSOC_CASES))
def test_plain_is_the_code_it_replaced(name, dtype):
    args = _inputs(name, dtype)
    out = assoc_options_plain(*args)
    want = _before(*args)
    for a, b in zip(out, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cfg, z, jvalid = args[1], args[6], args[5]
    m, c = min(cfg.beam_meas_cap or z.shape[0], z.shape[0]), min(cfg.beam_candidates, jvalid.shape[1])
    p = jvalid.shape[0]
    assert out[1].shape == (p, m, c + 1) and out[2].shape == out[3].shape == (p, m, c)


def test_cases_hold_what_they_name():
    """The edge cases reach what the kernel is held to: rows with more gated
    landmarks than C, equal deltas in a row, NEG-only live rows, dead rows,
    clamped visibility."""
    gated = lambda od: (od[..., 1:] > association.NEG / 2).sum(-1)  # noqa: E731
    base, od, _, _ = assoc_options_plain(*_inputs("ties"))
    g = od[..., 1:]
    assert ((g[..., 1:] == g[..., :-1]) & (g[..., 1:] > association.NEG / 2)).any()  # a tie kept in order
    assert gated(od).max() == od.shape[-1] - 1  # a row full of gated candidates
    for name in ("no-gated-pair", "all-invalid", "all-slots-dead"):
        base, od, _, _ = assoc_options_plain(*_inputs(name))
        assert gated(od).max() == 0, name
    base, od, wk, bk = assoc_options_plain(*_inputs("all-slots-dead"))
    assert torch.equal(od[..., 0], torch.zeros_like(od[..., 0]))
    assert torch.equal(bk, (1 << torch.arange(bk.shape[-1], dtype=torch.int32)).expand_as(bk))
    base, _, _, _ = assoc_options_plain(*_inputs("all-invalid"))
    assert torch.equal(base, torch.zeros_like(base))
    model, cfg, params, pose, jmeans, jvalid, z, z_mask = _inputs("chap3")
    mu = model.measure_soa(model.params, pose, jmeans)
    fuzzy = model.fuzzy_visible_soa(model.params, mu, params.visibility_ramp)
    assert (fuzzy == 0).any() and ((fuzzy > 0) & (fuzzy < 1)).any()


@pytest.mark.parametrize("name", ["bench", "chap3", "lin1d", "ties", "e-below-c"])
def test_wrapper_runs_the_plain_version_on_the_cpu(name):
    args = _inputs(name)
    before = assoc_options.launches
    for a, b in zip(assoc_options(*args), assoc_options_plain(*args)):
        assert torch.equal(a, b)
    assert assoc_options.launches == before


def _bad(args, **change):
    names = ("model", "cfg", "params", "pose", "jmeans", "jvalid", "z", "z_mask")
    out = dict(zip(names, args))
    out.update(change)
    return [out[n] for n in names]


@pytest.mark.parametrize("change,match", [
    ("meta", "unsupported device"),
    ("float64", "expected torch.float32"),
    ("pose-shape", "pose: expected"),
    ("pose-strided", "pose must be contiguous"),
    ("z-mask-per-particle", "z_mask: expected"),
    ("jmeans-strides", "jmeans\\[1\\]"),
    ("c-past-32", "C=33"),
    ("e-past-shared-memory", "E=20000"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, match):
    args = _inputs("bench")
    model, cfg, params, pose, jmeans, jvalid, z, z_mask = args
    if change == "meta":
        meta = lambda x: x.to("meta")  # noqa: E731
        args = _bad(args, pose=meta(pose), jmeans=list(map(meta, jmeans)), jvalid=meta(jvalid), z=meta(z),
                    z_mask=meta(z_mask))
    elif change == "float64":
        args = _bad(args, pose=pose.double())
    elif change == "pose-shape":
        args = _bad(args, pose=pose[:, :3].contiguous())
    elif change == "pose-strided":
        args = _bad(args, pose=torch.cat([pose, pose], 1)[:, ::2])
    elif change == "z-mask-per-particle":
        args = _bad(args, z_mask=z_mask.expand(pose.shape[0], -1).contiguous())
    elif change == "jmeans-strides":
        args = _bad(args, jmeans=[jmeans[0], jmeans[1].contiguous(), jmeans[2]])
    elif change == "c-past-32":
        e = 40
        args = _bad(args, cfg=phd.PHDConfig(beam_candidates=33, estimate_cap=e),
                    jmeans=[torch.zeros((pose.shape[0], e))] * 3, jvalid=torch.ones((pose.shape[0], e), dtype=torch.bool))
    else:
        e = 20_000
        args = _bad(args, jmeans=[torch.zeros((pose.shape[0], e))] * 3,
                    jvalid=torch.ones((pose.shape[0], e), dtype=torch.bool))
    with pytest.raises(ValueError, match=match):
        assoc_options(*args)


@pytest.mark.parametrize("model_name", ["PRM3D", "Linear2D", "Linear1D"])
def test_packed_params_are_the_plain_versions_numbers(model_name):
    """The kernel's parameter vector holds the numbers the plain version
    computes, bit for bit: log clutter, PD, log-multiplier, ramp, inverse."""
    model, params = get_model(model_name), _params(model_name)
    d = model.meas_dim
    r = smallmat.from_tensor(params.meas_cov)
    det_r = smallmat.det(r)
    want = torch.stack([torch.log(params.clutter_density), params.pd, smallmat.log_multiplier(r, det_r),
                        *params.visibility_ramp[:d], *[x for row in smallmat.inv(r, det_r) for x in row]])
    got = assoc_kernel.pack_params(model, params)
    assert got.dtype == torch.float32 and got.shape == (3 + d + d * d,) and torch.equal(got, want)


def test_launch_shape():
    """The Python copy of the kernel's launch shape (chip_smoke.py holds it
    to the built library's): 256 // M particles a block, fewer where their
    landmark tables do not fit, none past a block's shared memory."""
    ls = assoc_kernel.launch_shape
    assert ls(48, 24, 48, 3) == (10, 4 * (10 * 5 * 49 + 72))  # the flagship and bench shape
    assert ls(128, 48, 48, 3) == (5, 4 * (5 * 5 * 129 + 96))  # chap3 and the command line
    assert ls(128, 48, 48, 1)[0] == 5 and ls(128, 0, 0, 2)[0] == 1 and ls(48, 300, 300, 3)[0] == 1
    pb, nbytes = ls(7000, 24, 48, 3)  # tables of 140 KB: two do not fit
    assert pb == 1 and nbytes <= _build.SMEM_LIMIT < 2 * 4 * 5 * 7001
    assert ls(11_600, 24, 48, 3)[0] == 1 and ls(11_700, 24, 48, 3) == (0, 0)
    for e, m, mz, d in [(48, 24, 48, 3), (128, 48, 48, 3), (4, 12, 12, 2), (2000, 1, 188, 3), (9000, 64, 64, 3)]:
        pb, nbytes = ls(e, m, mz, d)
        assert pb >= 1 and nbytes <= _build.SMEM_LIMIT and pb * m <= max(256, m)


@pytest.mark.parametrize("kernels", [None, False, True])
def test_step_kernel_switch_on_cpu(kernels):
    """make_slam_step with kernels None, False or True gives equal states on
    CPU tensors over a few frames (every wrapper's CPU route is its plain
    version; the correct stage is pinned to the fused stage's semantics so
    the three settings share it), the association's parameter vector packed
    once for all of them."""
    model, params = get_model("PRM3D"), _params("PRM3D")
    cfg = phd.PHDConfig(num_particles=5, max_components=48, max_measurements=12, estimate_cap=16,
                        beam_width=16, beam_candidates=6, beam_meas_cap=8)
    pose, leaves, z, z_mask = fused_state(7, 5, 48, 12, 12)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    state0 = phd.PHDState(f32(pose), torch.full((5,), -1.6094379), SGM(*[f32(x) for x in leaves]),
                          torch.zeros((), dtype=torch.int64), torch.arange(5))
    z, z_mask = f32(z), torch.as_tensor(z_mask)

    def correct(pose, maps, z, z_mask):
        return fused_kernel.fused_stage_plain(model, cfg, params, pose, maps, z, z_mask)

    def run(kernels):
        step = phd.make_slam_step(model, cfg, kernels=kernels, stages={"correct": correct})
        gen = torch.Generator().manual_seed(3)
        state = state0
        for _ in range(3):
            normals = torch.randn((5, 6), generator=gen)
            state = step(params, state, torch.zeros(6), z, z_mask, normals, torch.rand((), generator=gen))
        return state

    got, want = run(kernels), run(False)
    for a, b in zip(list(got[:2]) + list(got.maps) + list(got[3:]), list(want[:2]) + list(want.maps) + list(want[3:])):
        assert torch.equal(a, b)
    assert torch.isfinite(got.logweight).all()
