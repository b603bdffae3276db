"""The weight stage's mixture likelihoods (slam/mixture_kernel.py): the plain
version is the composition the weight inputs ran before the kernel, bit for
bit in float32 and float64; it agrees with an independent float64 numpy
evaluation on the edge cases the kernel is held to on the card
(kernel_cases.MIXTURE_EDGES); the wrapper runs it for CPU tensors; the
weight inputs through the kernels' route give the plain route's outputs.

The CUDA kernel itself runs only on the card: chip_smoke.py holds it to
mixture_rest_plain on the same cases."""

import math

import numpy as np
import pytest
import torch

from monorfs_tpu_torch import _build
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm import mixture
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.kernel_cases import MIXTURE_EDGES, fused_state, mixture_case
from monorfs_tpu_torch.models import get as get_model
from monorfs_tpu_torch.slam import fused_kernel, mixture_kernel, phd
from monorfs_tpu_torch.slam.mixture_kernel import LOG_EVAL_FLOOR, mixture_rest, mixture_rest_plain

# name: (P, KP, KC, E, mixture_case keywords); "chap3" is the grid's
# capacities (K0 500, 48 slots, MAP cap 128) at a few particles
CASES = dict(MIXTURE_EDGES, chap3=(3, 548, 500, 128, dict(live_p=330, live_c=280)))
DTYPES = [torch.float32, torch.float64]


def _inputs(name, dtype, seed=0):
    p, kp, kc, e, kw = CASES[name]
    pred, cor, jm, jv = mixture_case(seed, p, kp, kc, e, **kw)
    as_sgm = lambda leaves: SGM(*torch.as_tensor(leaves, dtype=dtype).unbind(0))  # noqa: E731
    return as_sgm(pred), as_sgm(cor), list(torch.as_tensor(jm, dtype=dtype).unbind(0)), torch.as_tensor(jv)


def _before(predicted, corrected, jmeans, jvalid):
    """The weight inputs' lines before the kernel (phd.weight_inputs), as
    they stood."""

    def mixture_loglike(gm):
        lv = torch.clamp(mixture.log_evaluate_many_soa(gm, jmeans), min=LOG_EVAL_FLOOR)
        return torch.sum(torch.where(jvalid, lv, torch.zeros_like(lv)), dim=-1)

    return (mixture_loglike(predicted) - mixture.expected_size(predicted)) - (
        mixture_loglike(corrected) - mixture.expected_size(corrected)
    )


def _numpy_term(leaves, jm, jv):
    """LL - N of one map in float64 numpy, particle by particle: each valid
    row's log-sum-exp over the live components whose covariance has a
    positive determinant (the others' density is not finite), floored at
    LOG_EVAL_FLOOR; a row with none reads the floor."""
    mean, logw = np.stack(leaves[:3], -1), leaves[9]
    c = leaves[3:9]
    cov = np.stack([np.stack([c[0], c[1], c[2]], -1), np.stack([c[1], c[3], c[4]], -1),
                    np.stack([c[2], c[4], c[5]], -1)], -2)
    out = np.zeros(logw.shape[0])
    for p in range(logw.shape[0]):
        live = logw[p] > mixture.ALIVE_THRESHOLD
        out[p] = -np.exp(logw[p][live]).sum()
        det = np.linalg.det(cov[p][live]) if live.any() else np.zeros(0)
        ok = np.flatnonzero(live)[det > 0]
        inv = np.linalg.inv(cov[p][ok])
        logmult = -0.5 * (3 * math.log(2 * math.pi) + np.log(det[det > 0]))
        for e in np.flatnonzero(jv[p]):
            d = np.stack([jm[i][p, e] for i in range(3)]) - mean[p][ok]
            s = logw[p][ok] + logmult - 0.5 * np.einsum("ka,kab,kb->k", d, inv, d)
            lv = s.max() + np.log(np.exp(s - s.max()).sum()) if len(s) else -np.inf
            out[p] += max(lv, LOG_EVAL_FLOOR)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_is_the_composition_it_replaced(name, dtype):
    args = _inputs(name, dtype)
    out = mixture_rest_plain(*args)
    assert out.dtype == dtype and out.shape == (CASES[name][0],)
    assert torch.equal(out, _before(*args))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_against_numpy_float64(name):
    pred, cor, jm, jv = _inputs(name, torch.float64)
    np_leaves = lambda m: [x.numpy() for x in m]  # noqa: E731
    jm_np, jv_np = [x.numpy() for x in jm], jv.numpy()
    want = _numpy_term(np_leaves(pred), jm_np, jv_np) - _numpy_term(np_leaves(cor), jm_np, jv_np)
    got = mixture_rest_plain(pred, cor, jm, jv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6)
    assert np.isfinite(got).all()


def test_edge_cases_read_as_the_clamps_say():
    """A map with no live slot reads LOG_EVAL_FLOOR on every valid row and
    N = 0; with no valid row only the expected sizes are left; singular
    covariances add nothing (their density is DEAD)."""
    pred, cor, jm, jv = _inputs("no-live-predicted", torch.float64)
    lv = mixture.log_evaluate_many_soa(pred, jm)
    assert torch.equal(lv, torch.full_like(lv, mixture.DEAD))
    lv_cor = torch.clamp(mixture.log_evaluate_many_soa(cor, jm), min=LOG_EVAL_FLOOR)
    ll_cor = torch.sum(torch.where(jv, lv_cor, torch.zeros_like(lv_cor)), dim=-1)
    want = LOG_EVAL_FLOOR * jv.sum(1).to(torch.float64) - (ll_cor - mixture.expected_size(cor))
    assert torch.equal(mixture_rest_plain(pred, cor, jm, jv), want)
    pred, cor, jm, jv = _inputs("no-live", torch.float64)
    assert torch.equal(mixture_rest_plain(pred, cor, jm, jv), torch.zeros(pred.logw.shape[0], dtype=torch.float64))
    pred, cor, jm, jv = _inputs("all-invalid", torch.float32)
    want = -mixture.expected_size(pred) + mixture.expected_size(cor)
    assert torch.equal(mixture_rest_plain(pred, cor, jm, jv), want)
    pred, cor, jm, jv = _inputs("singular-covariance", torch.float64)
    assert torch.isfinite(mixture_rest_plain(pred, cor, jm, jv)).all()


@pytest.mark.parametrize("name", ["chap3", "more-live-than-a-tile", "one-row", "no-live"])
def test_wrapper_runs_the_plain_version_on_the_cpu(name):
    args = _inputs(name, torch.float32)
    before = mixture_rest.launches
    assert torch.equal(mixture_rest(*args), mixture_rest_plain(*args))
    assert mixture_rest.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    pred, cor, jm, jv = _inputs("one-row", torch.float32)
    meta = lambda x: x.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        mixture_rest(SGM(*map(meta, pred)), SGM(*map(meta, cor)), list(map(meta, jm)), meta(jv))


def test_layout():
    """The Python copies of the kernel's tile and shared-memory sizes (the
    card's chip_smoke.py holds them to the built library's): the grid's
    maps fit one tile; a larger map is walked in tiles of at most 2048."""
    assert mixture_kernel.tile_size(548) == 576
    assert mixture_kernel.tile_size(152) == 256  # at least one chunk of 256 slots
    assert mixture_kernel.tile_size(2500) == 2048
    assert mixture_kernel.layout_bytes(548, 128) == 4 * (11 * 576 + 256 + 16) + 32
    assert mixture_kernel.layout_bytes(10**6, 128) < _build.SMEM_LIMIT // 2
    assert mixture_kernel.layout_bytes(548, 60_000) > _build.SMEM_LIMIT


@pytest.mark.parametrize("kernels", [None, True])
def test_weight_inputs_kernel_switch_on_cpu(kernels):
    """weight_inputs through the route of kernels=None or True gives the
    outputs of kernels=False's on CPU tensors (the wrapper's CPU route is
    the plain version)."""
    model = get_model("PRM3D")
    cfg = phd.PHDConfig(num_particles=5, max_components=48, max_measurements=12, estimate_cap=16,
                        beam_width=16, beam_candidates=6)
    conf = Config()
    conf.set_model_defaults("PRM3D")
    params = conf.phd_params(torch.float32, "cpu")
    pose, leaves, z, z_mask = fused_state(7, 5, 48, 12, 12)
    maps = SGM(*[torch.as_tensor(x, dtype=torch.float32) for x in leaves])
    pose, z, z_mask = torch.as_tensor(pose, dtype=torch.float32), torch.as_tensor(z, dtype=torch.float32), \
        torch.as_tensor(z_mask)
    predicted, corrected = fused_kernel.fused_stage_plain(model, cfg, params, pose, maps, z, z_mask)
    want = phd.weight_inputs(model, cfg, params, pose, predicted, corrected, z, z_mask,
                             phd.route(model, torch.float32, False))
    got = phd.weight_inputs(model, cfg, params, pose, predicted, corrected, z, z_mask,
                            phd.route(model, torch.float32, kernels))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isfinite(got[0]).all()
