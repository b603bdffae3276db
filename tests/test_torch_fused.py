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
