"""The smoother tests of tests/test_torch_loopy.py on an 8-node PRM3D
problem (quaternion tangents, 6 x 6 Hessians, FitToMeasurement through the
camera model): every function in float64 to 1e-8, and the default run's
path -- sequential refit, trajectory objective, final map with history --
in float32 to the tolerances stated there."""

import pytest

from test_torch_loopy import (  # noqa: F401  (collected here with this module's `case`)
    check_final_map,
    check_objective,
    loopy_close,
    test_final_map_history,
    test_forward_backward_sweeps,
    test_loopy_state_conversion,
    test_map_sweep_and_fit_map_message,
    test_relinearize_gauge_refuse,
    test_reversed_refit,
    test_sequential_refit,
    test_trajectory_objective,
)
from torch_parity import LoopyCase

from monorfs_tpu_torch.slam import loopy


@pytest.fixture(scope="module")
def case():
    return LoopyCase("PRM3D", 8, "float64")


@pytest.fixture(scope="module")
def case32():
    return LoopyCase("PRM3D", 8, "float32")


def test_default_path_float32(case32):
    """What `-a loopy` runs by default (one sweep): the refit, the objective
    of the initial and the refitted state, the final map over the latter."""
    traj = loopy.make_sequential_refit(case32.tm, case32.tcfg)(*case32.targs)
    loopy_close(traj, case32.jtraj, "float32")
    check_objective(case32, case32.jnav.state)
    check_objective(case32, case32.jstate)
    check_final_map(case32, case32.jstate)
