"""The port's prepare_options and plain beam against monorfs_tpu's
association.beam_scan and beam_pallas.beam_scan_batch(interpret=True):
exactly equal, float32, on random gated instances. The cases at B=200 C=8
(4 words, 48 steps: the default PHDConfig, which the CUDA kernel's block
design serves) hold the plain beam to the JAX scan alone: the JAX package
never runs its Pallas beam above B=64 (beam_pallas.recommended)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monorfs_tpu.slam import association as jassoc
from monorfs_tpu.slam import beam_pallas

from monorfs_tpu_torch.kernel_cases import beam_ties
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.slam import association, beam_kernel, phd


def _instances(seed, p, n, m):
    rng = np.random.default_rng(seed)
    ll = rng.normal(0, 3, (p, n, m)).astype(np.float32)
    ll = np.where(rng.random((p, n, m)) < 0.7, np.float32(jassoc.NEG), ll)
    log_miss = rng.normal(-1, 0.5, (p, n)).astype(np.float32)
    n_mask = rng.random((p, n)) < 0.8
    m_mask = rng.random((p, m)) < 0.8
    return ll, log_miss, n_mask, m_mask, np.float32(-2.5)


def _jax_prepare(ll, log_miss, n_mask, m_mask, log_clutter, c):
    prep = jax.vmap(
        lambda l, lm, nm, mm: jassoc.prepare_options(l, lm, log_clutter, nm, mm, c)
    )
    return prep(jnp.asarray(ll), jnp.asarray(log_miss), jnp.asarray(n_mask), jnp.asarray(m_mask))


@pytest.mark.parametrize(
    "seed,p,n,m,c,b", [(3, 9, 48, 17, 6, 32), (5, 4, 40, 24, 6, 32), (7, 3, 96, 12, 8, 64),
                       (11, 4, 128, 48, 8, 200), (13, 5, 32, 33, 8, 32)]
)
def test_prepare_options_and_beam_exact(seed, p, n, m, c, b):
    ll, log_miss, n_mask, m_mask, log_clutter = _instances(seed, p, n, m)
    jbase, jod, jwk, jbk, _ = _jax_prepare(ll, log_miss, n_mask, m_mask, log_clutter, c)
    n_words = (n + 31) // 32
    base, od, wk, bk, tw = association.prepare_options(
        torch.from_numpy(ll), torch.from_numpy(log_miss), log_clutter,
        torch.from_numpy(n_mask), torch.from_numpy(m_mask), c,
    )
    assert tw == n_words
    # base is a float32 sum over landmarks: the summation order differs
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=1e-6)
    np.testing.assert_array_equal(od.numpy(), np.asarray(jod))
    np.testing.assert_array_equal(wk.numpy(), np.asarray(jwk))
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jbk).view(np.int32))

    ref_scan = jax.vmap(
        lambda b_, o, w, k: jassoc.beam_scan(b_, o, w, k, b, n_words)
    )(jbase, jod, jwk, jbk)
    # the same option tensors into both beams: bit-identical scores
    out = beam_kernel.beam_scan_batch(
        torch.from_numpy(np.array(jbase)), od, wk, bk, b, n_words
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_scan))
    if beam_pallas.recommended(b):
        ref_pallas = beam_pallas.beam_scan_batch(jbase, jod, jwk, jbk, b, n_words, interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_pallas))


@pytest.mark.parametrize("seed,p,m,c,n_words,b", [(5, 6, 24, 6, 2, 32), (9, 3, 12, 8, 3, 64),
                                                  (15, 4, 48, 8, 4, 200), (17, 5, 33, 8, 1, 32)])
def test_beam_ties_exact(seed, p, m, c, n_words, b):
    """Tie-heavy options (kernel_cases.beam_ties, the inputs chip_smoke.py
    holds the CUDA kernel to): hundreds of exactly equal candidates a step,
    most landmarks used, word indices out of range. The plain beam equals
    JAX's scan and its Pallas kernel (interpret mode) bit for bit."""
    base, od, wk, bk = beam_ties(seed, p, m, c, n_words)
    out = beam_kernel.beam_scan_batch(*[torch.from_numpy(x) for x in (base, od, wk, bk)], b, n_words)
    jargs = (jnp.asarray(base), jnp.asarray(od), jnp.asarray(wk), jnp.asarray(bk.view(np.uint32)))
    ref_scan = jax.vmap(lambda b_, o, w, k: jassoc.beam_scan(b_, o, w, k, b, n_words))(*jargs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_scan))
    if beam_pallas.recommended(b):
        ref_pallas = beam_pallas.beam_scan_batch(*jargs, b, n_words, interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_pallas))
    # the case is what it claims: whole runs of equal scores survive
    assert (np.diff(out.numpy(), axis=1) == 0).sum() > p * b // 4


def test_bit31_words():
    """Landmark 31 of a word sets the sign bit of the int32 word, and the
    membership test still sees it (uint32 in JAX)."""
    bits = association.bit_of(torch.tensor([0, 31, 32, 63]))
    assert bits.dtype == torch.int32
    assert bits.tolist() == [1, -(2**31), 1, -(2**31)]
    assert ((bits & bits[1]) != 0).tolist() == [False, True, False, True]
    assert np.array_equal(bits.numpy().view(np.uint32), np.array([1, 2**31, 1, 2**31], np.uint32))


def test_set_log_likelihood_matches_jax():
    """The beam set likelihood of each particle, float32. The beam scores are
    identical; the two logsumexp implementations round differently, by a few
    float32 ulps of the score magnitude (~30): atol 1e-5."""
    ll, log_miss, n_mask, m_mask, log_clutter = _instances(11, 3, 20, 6)
    out = association.set_log_likelihood(
        torch.from_numpy(ll), torch.from_numpy(log_miss), log_clutter,
        torch.from_numpy(n_mask), torch.from_numpy(m_mask), 64, max_candidates=8,
    )
    for i in range(3):
        ref = jassoc.set_log_likelihood(
            jnp.asarray(ll[i]), jnp.asarray(log_miss[i]), jnp.asarray(log_clutter),
            jnp.asarray(n_mask[i]), jnp.asarray(m_mask[i]), 64, max_candidates=8,
        )
        np.testing.assert_allclose(out[i].item(), float(ref), rtol=0, atol=1e-5)


KINECT_PARAMS = dict(focal=57.58, film_left=-32.0, film_top=-24.0, film_width=64.0, film_height=48.0,
                     range_min=0.1, range_max=2.0, res_x=64.0, res_y=48.0, border=2)


def _fuzzy_inputs(seed, n=60):
    rng = np.random.default_rng(seed)
    q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.05, 4)
    pose = np.concatenate([rng.normal(0, 0.05, 3), q / np.linalg.norm(q)])
    means = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(-0.2, 2.4, n)])
    a = rng.normal(0, 1, (3, 3))
    meas_cov = a @ a.T * 0.01 + np.eye(3) * 0.01
    depth = np.full((48, 64), 1.4) + rng.normal(0, 0.01, (48, 64))
    depth[10:30, 20:40] = 0.7
    depth[35:42, 5:15] = np.nan
    return pose, means, meas_cov, depth


@pytest.mark.parametrize("model_name", ["PRM3D", "Kinect"])
@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float64, torch.float64, 1e-12), (jnp.float32, torch.float32, 1e-5)])
def test_fuzzy_pd_matches_jax(model_name, jdt, tdt, tol):
    """association_matrices(..., fuzzy_pd=True) against the JAX function:
    PD is the model's fuzzy visibility times pd, the Kinect model's through
    its depth map; the constant-PD default is unchanged."""
    from monorfs_tpu.models import get as jget
    from monorfs_tpu.models import kinect_model as jkm
    from monorfs_tpu_torch.models import get as tget
    from monorfs_tpu_torch.models import kinect_model as tkm

    jm, tm = jget(model_name), tget(model_name)
    if model_name == "Kinect":
        jm, tm = jm.with_params(jkm.Params(**KINECT_PARAMS)), tm.with_params(tkm.Params(**KINECT_PARAMS))
    ramp = np.array([3.0, 3.0, 0.05]) if model_name == "Kinect" else np.array([30.0, 30.0, 0.1])
    for seed in range(3):
        pose, means, meas_cov, depth = _fuzzy_inputs(seed)
        jdepth = jnp.asarray(depth, jdt) if model_name == "Kinect" else None
        tdepth = torch.tensor(depth, dtype=tdt) if model_name == "Kinect" else None
        for fuzzy in (True, False):
            want = jassoc.association_matrices(
                jm, jnp.asarray(pose, jdt), jnp.asarray(means, jdt), jnp.ones(len(means), bool),
                jnp.asarray(meas_cov, jdt), 0.9, jnp.asarray(ramp, jdt), 5.0, fuzzy, jdepth)
            got = association.association_matrices(
                tm, torch.tensor(pose, dtype=tdt), torch.tensor(means, dtype=tdt), torch.tensor(meas_cov, dtype=tdt),
                0.9, fuzzy_pd=fuzzy, ramp=torch.tensor(ramp, dtype=tdt), depth_map=tdepth)
            for g, w in zip(got, want):
                np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=tol, atol=tol)
            if fuzzy:  # visible, hidden and ramped landmarks all occur
                log_pd = got[1].numpy()
                assert (log_pd < np.log(0.9) - 1).any() and (np.isclose(log_pd, np.log(0.9))).any()


@pytest.mark.parametrize("m,c,b,n_words,bytes_", [
    (24, 8, 910, 4, 47264),    # the 256-thread block's largest B at C=8: 8,190 candidates
    (24, 8, 911, 4, 47312),    # 8,199 candidates: the 1024-thread block, 16 a thread
    (24, 8, 1000, 4, 51584),   # chip_smoke.py's wide beam
    (24, 8, 4768, 4, 232448),  # the largest B at C=8, 4 words: all of a block's shared memory
    (24, 8, 4769, 4, 0),
    (24, 8, 7281, 1, 178320),  # the largest at 1 word: 65,529 candidates
    (24, 8, 7282, 1, 0),       # 65,538 candidates: past the block scan's 16-bit counts
    (24, 7, 32, 1, 8480),      # the warp design's edge: B=32, C+1=8 (four particles a block)
    (24, 7, 33, 1, 4080),      # B=33: the block design
    (24, 8, 32, 1, 4352),      # C+1=9: the block design
    (48, 8, 200, 4, 15584),    # the default PHDConfig's 200 x 8 on 48 slots
])
def test_beam_takes_edges(m, c, b, n_words, bytes_):
    """beam_kernel.layout_bytes, the Python copy of csrc/beam_scan.cu's
    shape decision (chip_smoke.py holds it against beam_scan_smem_bytes
    over a grid of shapes), at the edges of the designs."""
    assert beam_kernel.layout_bytes(m, c, b, n_words) == bytes_
    assert beam_kernel.takes(m, c, b, n_words) == (bytes_ > 0)


def test_beam_pick_and_wide_scan():
    """The beam the route picks for a float32 step (phd.route; its table in
    tests/test_torch_route.py) takes the default 200 x 8 and B=1000 C=8
    alike (the block design takes both). The wrapper at B=1000 (the plain
    version on CPU tensors) equals the JAX scan bit for bit."""
    assert phd.route(PRM3D, torch.float32).beam is beam_kernel.beam_scan_batch
    assert beam_kernel.takes(48, 8, 200, 4) and beam_kernel.takes(24, 8, 1000, 4)

    ll, log_miss, n_mask, m_mask, log_clutter = _instances(19, 2, 128, 24)
    jbase, jod, jwk, jbk, _ = _jax_prepare(ll, log_miss, n_mask, m_mask, log_clutter, 8)
    base, od, wk, bk, n_words = association.prepare_options(
        torch.from_numpy(ll), torch.from_numpy(log_miss), log_clutter,
        torch.from_numpy(n_mask), torch.from_numpy(m_mask), 8,
    )
    out = beam_kernel.beam_scan_batch(torch.from_numpy(np.array(jbase)), od, wk, bk, 1000, n_words)
    ref = jax.vmap(lambda b_, o, w, k: jassoc.beam_scan(b_, o, w, k, 1000, n_words))(jbase, jod, jwk, jbk)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_step_and_quasi_ll_wide_beams():
    """A float32 SLAM step at B=1000 C=8 (bench_core on the 3D asset world,
    CPU) runs with kernels=None and gives finite weights; a step built with
    kernels=True gives the same bits (on CPU tensors both run the plain
    versions). The value-only quasi likelihood at B=1000 equals the plain
    beam's."""
    import pathlib

    from monorfs_tpu_torch import bench_core

    assets = pathlib.Path(__file__).resolve().parent.parent / "assets"
    pcfg = phd.PHDConfig(num_particles=4, max_components=32, max_measurements=48, meas_compact=24,
                         beam_width=1000, beam_candidates=8)
    runner, carry, cmds = bench_core.setup(assets / "sim3d.world", assets / "mov3d.in", 4, 2,
                                           phd_cfg=pcfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = bench_core.draw_chunk(runner, gen, 2, carry.vstate.landmarks.shape[0], torch.float32)
    out, _ = bench_core.run_frames(runner, carry, cmds, draws)
    assert torch.isfinite(out.nstate.logweight).all()
    strict = runner._replace(step=phd.make_slam_step(runner.model, pcfg, kernels=True))
    out_strict, _ = bench_core.run_frames(strict, carry, cmds, draws)
    assert torch.equal(out_strict.nstate.logweight, out.nstate.logweight)

    rng = np.random.default_rng(23)
    lm = torch.tensor(rng.uniform(-0.5, 0.5, (3, 40, 3)) + np.array([0, 0, 1.0]), dtype=torch.float32)
    pose = torch.tensor([[0, 0, 0, 1, 0, 0, 0]] * 3, dtype=torch.float32)
    z = PRM3D.measure(PRM3D.params, pose[:, None, :], lm[:, :24])
    args = (PRM3D, torch.eye(3) * 0.01, 0.9, -4.0, pose, lm, torch.ones(3, 40, dtype=torch.bool), z,
            torch.ones(3, 24, dtype=torch.bool))
    ll = association.quasi_set_log_likelihood(*args, beam_width=1000)
    assert torch.isfinite(ll).all()
    assert torch.equal(ll, association.quasi_set_log_likelihood(*args, beam_width=1000,
                                                                beam=association.beam_scan))
