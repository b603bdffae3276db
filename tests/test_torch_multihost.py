"""Multi-process start (monorfs_tpu_torch/parallel/multihost.py): two gloo
processes (tests/torch_dist_runner.py) reproduce the single-process run,
as tests/test_multihost.py holds the JAX package's two processes to its
one: the Linear2D fixture in float64 (checksums rtol 1e-12 between the
processes, 1e-9 against the single process) and the PRM3D bench shapes in
float32 (P=200, K=128; finite checksums agreeing between the processes and
with the single process to rtol 1e-5). Without a GPU, initialize raises
unless the caller asks for the CPU."""

import numpy as np
import pytest
import torch

from monorfs_tpu_torch.parallel import multihost

from test_torch_parallel import linear2d_case, prm3d_case, single_card
import torch_dist_runner
from torch_dist_runner import run_ranks

one_thread = pytest.fixture(autouse=True, scope="module")(torch_dist_runner.one_thread)


def _checksums(pose, logweight, logw):
    live = logw > -1e29
    return np.asarray([pose.sum(dtype=np.float64), logweight.sum(dtype=np.float64),
                       np.exp(np.where(live, logw, 0.0), dtype=np.float64)[live].sum()])


def _two_processes(tmp_path, spec, arrays):
    outs = run_ranks(tmp_path, spec, arrays, 2)
    sums = [_checksums(o["pose"][-1], o["logweight"][-1], o["maps_logw"]) for o in outs]
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-12)
    want, final = single_card(spec, arrays)
    return sums[0], _checksums(want["pose"][-1], want["logweight"][-1], final.maps.logw.numpy())


def test_two_process_run_matches_single_process(tmp_path):
    _, _, spec, arrays = linear2d_case()
    got, want = _two_processes(tmp_path, spec, arrays)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_two_process_prm3d_bench_shapes(tmp_path):
    spec, arrays = prm3d_case()
    got, want = _two_processes(tmp_path, spec, arrays)
    assert np.isfinite(got).all()
    # 200 particles with quaternion w ~= 1 each: pose_sum is O(200)
    assert 50.0 < got[0] < 1000.0 and got[2] > 0.5, got
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_initialize_needs_a_gpu_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: initialize would start NCCL")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("tcp://localhost:1", 2, 1, backend="gloo")
