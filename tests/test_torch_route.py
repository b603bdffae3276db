"""phd.route, the one place that chooses a step's stage functions: each row
of its table a case (the correct stage, the mixture likelihoods, the
association options and the beam for a model, dtype and `kernels`), and the
one message with which kernels=True refuses float64 or a model without a
kernel instantiation; the models' kernel parameters, the 8 floats each
kernel launch passes by value (csrc/model_policy.cuh's ModelParams)."""

import pytest
import torch

from monorfs_tpu_torch.models import get as get_model
from monorfs_tpu_torch.slam import assoc_kernel, beam_kernel, fused_kernel, mixture_kernel, phd

F32, F64 = torch.float32, torch.float64
WANT = {  # (correct, mixture, assoc, beam, packed)
    "kernels": (fused_kernel.fused_stage, mixture_kernel.mixture_rest, assoc_kernel.assoc_options,
                beam_kernel.beam_scan_batch, True),
    "depth": (phd.xla_stage, mixture_kernel.mixture_rest, assoc_kernel.assoc_options_plain,
              beam_kernel.beam_scan_batch, False),
    "plain": (phd.xla_stage, mixture_kernel.mixture_rest_plain, assoc_kernel.assoc_options_plain,
              beam_kernel.beam_scan_plain, False),
}


@pytest.mark.parametrize("model_name,dtype,kernels,want", [
    # PRM3D / Linear2D / Linear1D, float32, None or True: the four kernels
    ("PRM3D", F32, None, "kernels"), ("Linear2D", F32, None, "kernels"), ("Linear1D", F32, None, "kernels"),
    ("PRM3D", F32, True, "kernels"), ("Linear2D", F32, True, "kernels"), ("Linear1D", F32, True, "kernels"),
    # the depth-occlusion model, float32, None: the mixture and beam kernels only
    ("Kinect", F32, None, "depth"),
    # float64, None: the XLA-semantics stage and the plain versions
    ("PRM3D", F64, None, "plain"), ("Linear2D", F64, None, "plain"), ("Linear1D", F64, None, "plain"),
    ("Kinect", F64, None, "plain"),
    # False: the same for any model and dtype
    ("PRM3D", F32, False, "plain"), ("Linear2D", F32, False, "plain"), ("Linear1D", F32, False, "plain"),
    ("Kinect", F32, False, "plain"), ("PRM3D", F64, False, "plain"), ("Kinect", F64, False, "plain"),
    # True with the depth model or float64: one message
    ("Kinect", F32, True, "raises"), ("PRM3D", F64, True, "raises"), ("Linear1D", F64, True, "raises"),
    ("Kinect", F64, True, "raises")])
def test_route(model_name, dtype, kernels, want):
    model = get_model(model_name)
    if want == "raises":
        with pytest.raises(ValueError, match=f"the kernels are float32 only and take the models with a kernel "
                                             f"instantiation, not the depth-occlusion model: this step has "
                                             f"{dtype} and the {model_name} model"):
            phd.route(model, dtype, kernels)
        return
    got = phd.route(model, dtype, kernels)
    assert all(a is b for a, b in zip(got, WANT[want])), (got, want)
    assert got.packed is WANT[want][-1]


@pytest.mark.parametrize("model_name,want", [
    ("PRM3D", (575.8156, 575.8156 * 575.8156, -320.0, 320.0, -240.0, 240.0, 0.1, 2.0)),
    ("Linear2D", (2.0,) + (0.0,) * 7), ("Linear1D", (2.0,) + (0.0,) * 7), ("Kinect", None)])
def test_kernel_params(model_name, want):
    """Each family's 8 floats in the order its instantiation reads them (the
    camera: focal, its square, film left / right / top / bottom, the range;
    a linear model: its range); the depth-occlusion model has none, which
    is what keeps the fused and association kernels off it."""
    model = get_model(model_name)
    if want is None:
        assert model.kernel_params is None
        return
    got = model.kernel_params(model.params)
    assert got == want and all(type(v) is float for v in got)
