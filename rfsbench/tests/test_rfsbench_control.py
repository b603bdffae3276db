"""The control comes out as not correct: the reference itself in the port's
place, computed in bfloat16, at the sampled frames of a tiny cell."""

import pytest

from rfsbench import check, harness, readings

from . import small


@pytest.mark.parametrize("name", ["chap3-p800", "chap3-p2000"])
def test_the_control_is_not_correct(name):
    b, c, config, traffic = small.cell(name)
    out = readings.seed_readings(name, 2**31 + 5, ["bf16"], small.cpu(), cell=(b, c, config, traffic))
    limits = traffic["limits"]
    assert all(out["port"][k] <= limits[k]["limit"] for k in limits), out["port"]
    assert any(out["bf16"][k] > limits[k]["limit"] for k in limits), out["bf16"]
    assert check.BRANCH > limits["weight"]["limit"]
    assert harness.seq_seed(2**31 + 5, 0) != harness.seq_seed(2**31 + 5, 1)
