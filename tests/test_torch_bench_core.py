"""The port's frame loop end to end on the CPU (plain kernel versions), and
its device rules: entry points default to CUDA and raise without a GPU;
kernel wrappers take the plain version only for CPU tensors."""

import numpy as np
import pytest
import torch

from monorfs_tpu_torch.bench_core import run_benchmark
from monorfs_tpu_torch.config import Config
from monorfs_tpu_torch.gm.mixture import empty_soa
from monorfs_tpu_torch.models import PRM3D
from monorfs_tpu_torch.sim import vehicle
from monorfs_tpu_torch.slam import beam_kernel, fused_kernel, phd

SMALL = phd.PHDConfig(num_particles=4, max_components=32, max_measurements=48, gate_top=8,
                      estimate_cap=16, beam_width=16, beam_meas_cap=12, beam_candidates=6,
                      merge_rounds=4, meas_compact=12)


def test_run_benchmark_cpu():
    """10 frames, 4 particles, float32: the result dict of the JAX bench and
    a location error within a few centimetres of the true path."""
    before = (beam_kernel.beam_scan_batch.launches, fused_kernel.fused_stage.launches)
    r = run_benchmark("assets/sim3d.world", "assets/mov3d.in", particles=4, frames=10,
                      phd_cfg=SMALL, device="cpu")
    assert set(r) == {"frames", "particles", "elapsed_s", "fps", "warmup_s", "ate_rmse_loc", "device"}
    assert r["frames"] == 10 and r["particles"] == 4 and r["device"] == "cpu"
    assert np.isfinite(r["fps"]) and r["fps"] > 0
    assert np.isfinite(r["ate_rmse_loc"]) and r["ate_rmse_loc"] < 0.05
    # the CPU run took the plain versions: no kernel launched
    assert (beam_kernel.beam_scan_batch.launches, fused_kernel.fused_stage.launches) == before


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_benchmark("assets/sim3d.world", "assets/mov3d.in", particles=4, frames=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Config().phd_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        phd.init_state(PRM3D, SMALL, np.zeros(7))
    with pytest.raises(RuntimeError, match="CUDA"):
        vehicle.make_params(PRM3D, Config())


def test_wrappers_raise_off_cpu():
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel or raises (here: the meta device)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="device"):
        beam_kernel.beam_scan_batch(
            torch.empty(2, device=meta), torch.empty(2, 3, 7, device=meta),
            torch.empty(2, 3, 6, dtype=torch.int32, device=meta),
            torch.empty(2, 3, 6, dtype=torch.int32, device=meta), 8, 1,
        )
    params = Config().phd_params(torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        fused_kernel.fused_stage(
            PRM3D, SMALL, params, torch.empty(2, 7, device=meta),
            empty_soa(32, batch=(2,), device=meta), torch.empty(12, 3, device=meta),
            torch.empty(12, dtype=torch.bool, device=meta),
        )
