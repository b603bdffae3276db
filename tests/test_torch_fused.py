"""The port's fused births + correct + prune stage (plain PyTorch, float32)
against monorfs_tpu's Pallas kernel in interpret mode, on the states and
with the tolerances of tests/test_fused_pallas.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monorfs_tpu.gm import mixture as jmixture
from monorfs_tpu.models import get as get_model
from monorfs_tpu.slam import fused_pallas
from monorfs_tpu.slam import phd as jphd

from monorfs_tpu_torch.gm import mixture
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.kernel_cases import fused_state
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.slam import fused_kernel, phd

from torch_parity import assert_sets_close, np_, params_pair, random_state, sgm_to_torch, t32


def _run_both(jcfg, seed, p, n_lm=12):
    jmodel = get_model("PRM3D")
    tcfg = phd.PHDConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jparams, tparams = params_pair()
    pose, maps, z, z_mask = random_state(
        jmodel, jcfg.max_components, jcfg.max_measurements, seed, p, n_lm
    )
    jpred, jcor = fused_pallas.fused_stage(
        jmodel, jcfg, jparams, pose, maps, z, z_mask, interpret=True, bp=4
    )
    tpred, tcor = fused_kernel.fused_stage(
        PRM3D, tcfg, tparams, t32(pose), sgm_to_torch(maps), t32(z),
        torch.tensor(np.array(z_mask)),
    )
    return (jpred, jcor), (tpred, tcor)


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_plain_matches_pallas(seed):
    cfg = jphd.PHDConfig(
        num_particles=5, max_components=48, max_measurements=10, gate_top=8, merge_rounds=4
    )
    (jpred, jcor), (tpred, tcor) = _run_both(cfg, seed, 5)
    # predicted mixture: the same elementwise math, rtol/atol 2e-5
    for name, a, b in zip(jpred._fields, jpred, tpred):
        aa, bb = np_(a), b.numpy()
        live = aa > -0.25e30 if name == "logw" else np.ones_like(aa, bool)
        np.testing.assert_allclose(bb[live], aa[live], rtol=2e-5, atol=2e-5)
    assert_sets_close(jcor, tcor, 5)


def test_fused_plain_cap_binds():
    """MaxQuantity binds: the bisection cut keeps the same components."""
    cfg = jphd.PHDConfig(
        num_particles=3, max_components=16, max_measurements=10, gate_top=4, merge_rounds=4
    )
    (_, jcor), (_, tcor) = _run_both(cfg, 7, 3, n_lm=14)
    n_t = (tcor.logw.numpy() > -0.25e30).sum(-1)
    assert (n_t <= cfg.max_components).all()
    assert_sets_close(jcor, tcor, 3)
    e_j = np_(jmixture.expected_size(jmixture.aos_of(jcor)))
    np.testing.assert_allclose(
        np.exp(tcor.logw.numpy()).sum(-1), e_j, rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize(
    "name,fields,state",
    [
        # every landmark in two slots with one mean, all weights equal: ties in
        # the cut, the gate_top selection and the merge's leader order
        ("merge-ties", dict(num_particles=4, max_components=48, max_measurements=10,
                            gate_top=8, merge_rounds=4), (13, 4, 48, 10, 12, True)),
        # a second shape: KP = 104 components, 40 measurement slots
        ("K64-M40", dict(num_particles=3, max_components=64, max_measurements=40,
                         gate_top=6, merge_rounds=3), (11, 3, 64, 40, 20, False)),
    ],
)
def test_fused_plain_matches_pallas_cases(name, fields, state):
    """The kernel_cases states chip_smoke.py holds the CUDA kernel to: the
    plain version against the Pallas kernel in interpret mode."""
    jcfg = jphd.PHDConfig(**fields)
    tcfg = phd.PHDConfig(**fields)
    p = fields["num_particles"]
    pose, leaves, z, z_mask = fused_state(*state)
    jparams, tparams = params_pair()
    jpred, jcor = fused_pallas.fused_stage(
        get_model("PRM3D"), jcfg, jparams, jnp.asarray(pose, jnp.float32),
        jmixture.SGM(*[jnp.asarray(x, jnp.float32) for x in leaves]),
        jnp.asarray(z, jnp.float32), jnp.asarray(z_mask), interpret=True, bp=4,
    )
    tpred, tcor = fused_kernel.fused_stage(
        PRM3D, tcfg, tparams, t32(pose), SGM(*[t32(x) for x in leaves]), t32(z),
        torch.tensor(z_mask),
    )
    for field, a, b in zip(jpred._fields, jpred, tpred):
        aa, bb = np_(a), b.numpy()
        live = aa > -0.25e30 if field == "logw" else np.ones_like(aa, bool)
        np.testing.assert_allclose(bb[live], aa[live], rtol=2e-5, atol=2e-5)
    assert_sets_close(jcor, tcor, p)
    if name == "merge-ties":
        lw = leaves[9][0][leaves[9][0] > -0.25e30]
        assert len(np.unique(lw)) == 1 and len(lw) == 24


def _pallas_ready(jmodel):
    """The JAX linear models' to_map_soa broadcasts to the measurements'
    shape [1, M], which fails inside the Pallas kernel, where the pose is
    [bp, 1]: fused_pallas.supported() accepts the linear models, but the
    kernel cannot be traced for them. The reference stays as it is; the
    test hands the kernel the same function broadcasting both ways."""
    import dataclasses

    d = jmodel.meas_dim
    if d == 3:
        return jmodel

    def to_map_soa(p, pose, z):
        lm = [pose[..., i : i + 1] + z[i] for i in range(d)]
        return lm + [jnp.zeros_like(lm[0])] * (3 - d)

    return dataclasses.replace(jmodel, to_map_soa=to_map_soa)


def test_reference_pallas_kernel_cannot_trace_linear_models():
    """The fault above, pinned: the unpatched reference raises."""
    jmodel = get_model("Linear2D")
    cfg = jphd.PHDConfig(num_particles=4, max_components=16, max_measurements=6)
    pose, leaves, z, z_mask = fused_state(1, 4, 16, 6, 3, model="Linear2D")
    jc = __import__("monorfs_tpu.config", fromlist=["Config"]).Config()
    jc.set_model_defaults("Linear2D")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        fused_pallas.fused_stage(
            jmodel, cfg, jc.phd_params(jnp.float32), jnp.asarray(pose, jnp.float32),
            jmixture.SGM(*[jnp.asarray(x, jnp.float32) for x in leaves]),
            jnp.asarray(z, jnp.float32), jnp.asarray(z_mask), interpret=True, bp=4,
        )


def _both_on_case(model_name, fields, state, jc=None):
    """(JAX Pallas interpret (pred, cor), port plain (pred, cor), the JAX
    XLA-path corrected mixture) on one kernel_cases state."""
    from monorfs_tpu.config import Config as JConfig
    from monorfs_tpu_torch.models import get as tget

    jc = jc or JConfig()
    jc.set_model_defaults(model_name)
    jmodel, tmodel = _pallas_ready(get_model(model_name)), tget(model_name)
    jcfg, tcfg = jphd.PHDConfig(**fields), phd.PHDConfig(**fields)
    pose, leaves, z, z_mask = fused_state(*state, model=model_name)
    jparams, tparams = params_pair(jc)
    jpose, jz = jnp.asarray(pose, jnp.float32), jnp.asarray(z, jnp.float32)
    jmaps = jmixture.SGM(*[jnp.asarray(x, jnp.float32) for x in leaves])
    jout = fused_pallas.fused_stage(
        jmodel, jcfg, jparams, jpose, jmaps, jz, jnp.asarray(z_mask), interpret=True, bp=4
    )
    tout = fused_kernel.fused_stage(
        tmodel, tcfg, tparams, t32(pose), SGM(*[t32(x) for x in leaves]), t32(z),
        torch.tensor(z_mask),
    )
    return jout, tout, (jmodel, jcfg, jparams, jpose, jmaps, jz, jnp.asarray(z_mask))


def _assert_pred_close(jpred, tpred):
    for field, a, b in zip(jpred._fields, jpred, tpred):
        aa, bb = np_(a), b.numpy()
        live = aa > -0.25e30 if field == "logw" else np.ones_like(aa, bool)
        np.testing.assert_allclose(bb[live], aa[live], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("model_name", ["Linear2D", "Linear1D"])
def test_fused_plain_linear_matches_pallas(model_name):
    """The linear families through the plain version and the Pallas kernel
    in interpret mode (the JAX suite runs that kernel on PRM3D only; see
    _pallas_ready), to the PRM3D cases' tolerances; the cap does not bind, so the XLA path's global
    top-K cut keeps the same components and is held to them too."""
    import jax

    fields = dict(num_particles=4, max_components=48, max_measurements=12, gate_top=8,
                  merge_rounds=4)
    (jpred, jcor), (tpred, tcor), jargs = _both_on_case(model_name, fields, (21, 4, 48, 12, 10))
    _assert_pred_close(jpred, tpred)
    assert_sets_close(jcor, tcor, 4)
    jmodel, jcfg, jparams, jpose, jmaps, jz, jmask = jargs
    d = jmodel.meas_dim
    fns = (jmodel.measure_soa_fn(), jmodel.jac_landmark_soa_fn(), jmodel.to_map_soa_fn(),
           jmodel.fuzzy_visible_soa_fn(jparams.depth_map))
    zl = [jz[:, i] for i in range(d)]

    def one(pose, maps):
        births = jphd._births_soa(jmodel, fns[2], jparams, pose, maps, zl, jmask)
        return jphd._correct_prune_soa(
            jmodel, jcfg, jparams, fns, pose, jmixture.concat_soa(maps, births), zl, jmask)

    assert_sets_close(jax.vmap(one)(jpose, jmaps), tcor, 4)
    assert (tcor.logw.numpy() > -0.25e30).sum() >= 4 * 8


def test_fused_plain_k600_matches_pallas():
    """The command-line default capacity (K0 = 600, 48 measurement slots,
    gate_top 16, 8 merge rounds) at two particles, PRM3D."""
    fields = dict(num_particles=2, max_components=600, max_measurements=48)
    (jpred, jcor), (tpred, tcor), _ = _both_on_case("PRM3D", fields, (17, 2, 600, 48, 40))
    _assert_pred_close(jpred, tpred)
    assert_sets_close(jcor, tcor, 2)


def _xla_semantics(model, cfg, params, pose, maps, z, z_mask):
    """The float64 path's births + correct + prune (phd._births_soa +
    _correct_prune_soa), as the step runs them."""
    zl = [z[:, i] for i in range(model.meas_dim)]
    births = phd._births_soa(model, params, pose, maps, zl, z_mask)
    return phd._correct_prune_soa(model, cfg, params, pose, mixture.concat_soa(maps, births), zl, z_mask)


@pytest.mark.parametrize("semantics", ["kernel", "xla"])
@pytest.mark.parametrize("model_name", ["PRM3D", "Linear2D"])
def test_fused_mask_per_particle(semantics, model_name):
    """A [P, M] measurement mask (the smoother's leave-block-out passes as
    particles) equals P separate calls with each particle's [M] mask, and a
    [P, M] mask of identical rows equals the [M] call, for the kernel's
    semantics (fused_stage_plain) and the XLA path's (float64)."""
    from monorfs_tpu_torch.config import Config
    from monorfs_tpu_torch.models import get as tget

    p, k0, m = 5, 32, 12
    dtype = torch.float32 if semantics == "kernel" else torch.float64
    cfg = phd.PHDConfig(num_particles=p, max_components=k0, max_measurements=m, gate_top=6,
                        merge_rounds=4)
    pose, leaves, z, z_mask = fused_state(31, p, k0, m, 10, model=model_name)
    pose = np.repeat(pose[:1], p, axis=0)  # every pass at the same pose, as the smoother snaps them
    c = Config()
    c.set_model_defaults(model_name)
    params = c.phd_params(dtype, "cpu")
    model = tget(model_name)
    t = lambda x: torch.tensor(np.asarray(x), dtype=dtype)  # noqa: E731
    maps, pose, z = SGM(*[t(x) for x in leaves]), t(pose), t(z)
    z_mask = torch.tensor(z_mask)
    rows = z_mask[None, :] & (torch.arange(m)[None, :] % p != torch.arange(p)[:, None])  # [P, M]
    if semantics == "kernel":
        run = lambda pp, mm, zm: fused_kernel.fused_stage(model, cfg, params, pp, mm, z, zm)  # noqa: E731
    else:
        run = lambda pp, mm, zm: (_xla_semantics(model, cfg, params, pp, mm, z, zm),)  # noqa: E731
    batched = run(pose, maps, rows)
    for i in range(p):
        one = run(pose[i : i + 1], SGM(*[leaf[i : i + 1] for leaf in maps]), rows[i])
        for out_b, out_1 in zip(batched, one):
            for a, b in zip(out_b, out_1):
                torch.testing.assert_close(a[i : i + 1], b, rtol=0, atol=0)
    shared = run(pose, maps, z_mask)
    same_rows = run(pose, maps, z_mask.expand(p, m))
    for out_s, out_r in zip(shared, same_rows):
        for a, b in zip(out_s, out_r):
            assert torch.equal(a, b)
    assert not torch.equal(batched[-1].logw, shared[-1].logw)  # the masks mattered


@pytest.mark.parametrize("k0", [128, 500, 600, 663, 1000])
@pytest.mark.parametrize("m", [24, 48, 180, 188])
def test_layout_sizes_finite(k0, m):
    """fused_kernel's Python copies of csrc/fused_stage.cu's sizes
    (chip_smoke.py holds them against fused_stage_smem_bytes and
    fused_stage_workspace_floats over a grid of shapes): every (K0, M)
    launches with 72,064 bytes of shared memory (three blocks an SM), which
    does not grow with K0, and a workspace that holds each of LiveWs's
    tables at its largest."""
    from monorfs_tpu_torch import _build

    smem, ws = fused_kernel.layout_bytes(k0, m), fused_kernel.workspace_floats(k0, m)
    assert smem == 72064 and 3 * smem <= _build.SMEM_LIMIT
    kp, nwk = k0 + m, (k0 + 31) // 32
    # z and its rows 9 M; mixture 10, EKF 30, pair table M and the cut's list
    # 1 + M a local component; output slots 10, sources, weights, ranks 3,
    # rank-ordered means and metrics 9, leader bits and the relation a slot
    assert ws == 9 * m + (10 + 30 + m + 1 + m) * kp + (10 + 1 + 2 + 9) * k0 + nwk + k0 * nwk
    assert len(fused_kernel.PHASES) == 9


def test_layout_designs():
    """The bench, scaling and command-line shapes all ask the same 72,064
    bytes (chip_smoke.py prints them as smem_bytes): one design for every
    shape."""
    shapes = [(128, 24), (128, 48), (600, 48), (500, 48)]  # bench, bench_scaling / flagship, CLI, grid
    assert {fused_kernel.layout_bytes(k0, m) for k0, m in shapes} == {72064}


def _insert_dead(leaves, slots, rng):
    """The map's leaves with dead components (DEAD weight, random mean and
    covariance entries, not a covariance) inserted before the given slots."""
    out = []
    for i, leaf in enumerate(leaves):
        fill = np.full(len(slots), mixture.DEAD) if i == 9 else rng.normal(0, 5, len(slots))
        out.append(np.stack([np.insert(row, slots, fill) for row in leaf]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dead_slots_change_nothing(seed):
    """The invariant the live design rests on: dead components at random
    slots of a warm map leave fused_stage_plain's corrected set as it was
    (the cap does not bind), and its predicted mixture differs only at
    those slots."""
    rng = np.random.default_rng(seed)
    p, k0, m, extra = 4, 48, 12, 20
    pose, leaves, z, z_mask = fused_state(40 + seed, p, k0, m, 14)
    slots = np.sort(rng.integers(0, k0 + 1, extra))
    wide = _insert_dead(leaves, slots, rng)
    kept = np.ones(k0 + extra + m, bool)
    kept[slots + np.arange(extra)] = False
    _, tparams = params_pair()
    out = []
    for lv, k in ((leaves, k0), (wide, k0 + extra)):
        cfg = phd.PHDConfig(num_particles=p, max_components=k, max_measurements=m, gate_top=8,
                            merge_rounds=4)
        out.append(fused_kernel.fused_stage_plain(PRM3D, cfg, tparams, t32(pose), SGM(*[t32(x) for x in lv]),
                                                  t32(z), torch.tensor(z_mask)))
    (pred, cor), (wpred, wcor) = out
    for a, b in zip(pred, wpred):
        assert torch.equal(b[:, kept], a)
    n, wn = (cor.logw > -0.25e30).sum(1), (wcor.logw > -0.25e30).sum(1)
    assert torch.equal(n, wn) and (n > 0).all()
    assert (wcor.logw[:, k0:] < -0.25e30).all()
    assert_sets_close(jmixture.SGM(*[jnp.asarray(x.numpy()) for x in cor]), wcor, p)
    if seed == 0:  # the wide map through the Pallas kernel in interpret mode
        jcfg = jphd.PHDConfig(num_particles=p, max_components=k0 + extra, max_measurements=m, gate_top=8,
                              merge_rounds=4)
        jparams, _ = params_pair()
        jpred, jcor = fused_pallas.fused_stage(
            get_model("PRM3D"), jcfg, jparams, jnp.asarray(pose, jnp.float32),
            jmixture.SGM(*[jnp.asarray(x, jnp.float32) for x in wide]), jnp.asarray(z, jnp.float32),
            jnp.asarray(z_mask), interpret=True, bp=4)
        _assert_pred_close(jpred, wpred)
        assert_sets_close(jcor, wcor, p)


def test_fused_plain_k600_m180_matches_pallas():
    """K0 = 600 with 180 measurement slots (a 172-landmark world at the
    command line's default capacity, past what the kernel's block layout
    held), two particles, PRM3D."""
    fields = dict(num_particles=2, max_components=600, max_measurements=180)
    (jpred, jcor), (tpred, tcor), _ = _both_on_case("PRM3D", fields, (27, 2, 600, 180, 172))
    _assert_pred_close(jpred, tpred)
    assert_sets_close(jcor, tcor, 2)
    assert (tcor.logw.numpy() > -0.25e30).sum() >= 2 * 100
