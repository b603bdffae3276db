"""The frozen work counts equal the port's own (kernel_bounds) at small
shapes, and the frame's count is the sum of its stages."""

import numpy as np
import pytest
import torch

from monorfs_tpu_torch import kernel_bounds
from monorfs_tpu_torch.gm.mixture import SGM
from monorfs_tpu_torch.kernel_cases import fused_state
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.slam import fused_kernel, phd
from rfsbench.work import frame as work_frame
from rfsbench.work import kernels


@pytest.mark.parametrize("p,m,c,b,n_words", [(3, 5, 4, 16, 1), (7, 24, 6, 32, 2), (2, 48, 8, 200, 4)])
def test_beam_work_equals_the_ports(p, m, c, b, n_words):
    inputs = (torch.zeros(p), torch.zeros(p, m, c + 1), torch.zeros(p, m, c, dtype=torch.int32),
              torch.zeros(p, m, c, dtype=torch.int32))
    assert kernels.beam_work(p, m, c, b, n_words) == kernel_bounds.beam_work(inputs, b)


def _fused_case(seed, p, k0, m, n_lm):
    pose, leaves, z, z_mask = fused_state(seed, p, k0, m, n_lm)
    cfg = phd.PHDConfig(num_particles=p, max_components=k0, max_measurements=m)
    params = phd.make_params(
        motion_cov=np.eye(6) * 1e-3, meas_cov=np.diag([2.0, 2.0, 1e-3]), pd=0.9, clutter_density=3e-7,
        birth_weight=0.05, birth_cov=np.eye(3) * 0.01, min_weight=1e-3, merge_threshold=1.5,
        exploration_threshold=1e-5, density_radius=0.5, min_effective_particle=0.3,
        visibility_ramp=[4.24, 4.24, 0.095], dt=1 / 30, dtype=torch.float32, device="cpu")
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    maps = SGM(*[t(x) for x in leaves])
    pred, cor = fused_kernel.fused_stage_plain(PRM3D, cfg, params, t(pose), maps, t(z), torch.as_tensor(z_mask))
    return cfg, params, t(pose), maps, pred, cor, torch.as_tensor(z_mask)


@pytest.mark.parametrize("seed,p,k0,m,n_lm", [(0, 3, 64, 12, 10), (1, 5, 128, 24, 30), (2, 2, 96, 16, 60)])
def test_fused_work_equals_the_ports(seed, p, k0, m, n_lm):
    cfg, params, pose, maps, pred, cor, z_mask = _fused_case(seed, p, k0, m, n_lm)
    want = kernel_bounds.fused_work(p, k0, m, 3, 7, maps, pred, z_mask, cor, params)
    got = kernels.fused_work(p, k0, m, 3, 7, list(maps), list(pred), z_mask, list(cor),
                             float(params.density_radius))
    assert got == want
    assert got[1] == kernel_bounds.fused_ops(maps, pred, z_mask, cor, params, m)


def test_least_time_equals_the_ports_bound():
    peaks = {"hbm_bytes_s": kernel_bounds.HBM_BYTES_S, "fp32_ops_s": kernel_bounds.FP32_OPS_S}
    for nbytes, ops in ((4e6, 1e6), (1e3, 5e9)):
        assert kernels.least_ms(nbytes, ops, peaks) == kernel_bounds.bound(nbytes, ops)


def test_frame_count_is_the_sum_of_its_stages():
    cfg, params, pose, maps, pred, cor, z_mask = _fused_case(3, 4, 128, 24, 30)
    ops = work_frame.stage_ops(4, 6, list(maps), list(pred), z_mask, list(cor), 0.5, 24, 128, 200, 8, 4)
    assert set(ops) == {"predict", "correct", "weight", "beam", "resample"}
    assert ops["correct"] == kernel_bounds.fused_ops(maps, pred, z_mask, cor, params, 24)
    assert ops["beam"] == kernels.beam_work(4, 24, 8, 200, 4)[1]
    assert ops["predict"] == 4 * (2 * work_frame.POSE_COMPOSE + 2 * 36)
    e = work_frame.map_estimate_size(cor.logw, 128)
    assert torch.all(e >= 0) and torch.all(e <= 128)
    assert all(v > 0 for v in ops.values())
