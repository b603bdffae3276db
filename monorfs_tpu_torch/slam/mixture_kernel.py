"""The weight stage's two mixture likelihoods for all particles (kernel:
csrc/mixture_ll.cu). It replaces no Pallas kernel: in the JAX package the
stage is XLA (monorfs_tpu/slam/phd.py's weight inputs).

mixture_rest launches the CUDA kernel for CUDA tensors and runs
mixture_rest_plain, the same function in plain PyTorch, for CPU tensors.
They differ only in the order of the sums: over a row's components, over
the MAP rows and over a map's weights (csrc/mixture_ll.cu's note)."""

import ctypes
import functools

import torch

from .. import _build
from ..gm import mixture
from ..gm.mixture import SGM

# log(1e-300): the reference's float64 density floor, pinned in log space so
# float32 runs keep the float64 semantics (phd.py:52-56 of the JAX package).
LOG_EVAL_FLOOR = -690.77552789821368

# csrc/mixture_ll.cu's constants of the shared-memory layout
_THREADS = 256
_WARPS = _THREADS // 32
_TILE_MAX = 2048
_FIELDS = 11


def mixture_rest_plain(predicted: SGM, corrected: SGM, jmeans, jvalid):
    """rest [P] = (LL(predicted) - N(predicted)) - (LL(corrected) -
    N(corrected)): LL the log-likelihood of the MAP means jmeans (3-list of
    [P, E]) over the rows jvalid [P, E] holds, each floored at
    LOG_EVAL_FLOOR, N the expected size (the sum of the live weights)."""

    def mixture_loglike(gm):
        lv = torch.clamp(mixture.log_evaluate_many_soa(gm, jmeans), min=LOG_EVAL_FLOOR)
        return torch.sum(torch.where(jvalid, lv, torch.zeros_like(lv)), dim=-1)

    return (mixture_loglike(predicted) - mixture.expected_size(predicted)) - (
        mixture_loglike(corrected) - mixture.expected_size(corrected)
    )


def tile_size(k_max):
    """Components one tile of the kernel holds (the Python copy of
    tile_size): round_up(K, 32) of the larger map, between 256 and 2048."""
    return max(min((max(k_max, 1) + 31) // 32 * 32, _TILE_MAX), _THREADS)


def layout_bytes(k_max, e):
    """Shared memory one block asks for (the Python copy of
    mixture_ll_smem_bytes): the tile's 11 fields, a (max, sum) per MAP row,
    the warps' sums and counts. The kernel takes any K (a map past one tile
    is walked in tiles) and E while this fits a block (E up to ~47,000)."""
    return 4 * (_FIELDS * tile_size(k_max) + 2 * e + 2 * _WARPS) + 4 * _WARPS


@functools.cache
def smem_bytes(k_max, e):
    """mixture_ll_smem_bytes of the built library (on the card)."""
    fn = _build.function("mixture_ll_smem_bytes", [ctypes.c_int] * 2, ctypes.c_size_t)
    return fn(k_max, e)


@functools.cache
def _launcher():
    return _build.function(
        "mixture_ll_launch",
        [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 2,
    )


def pick(dtype, kernels=None):
    """The mixture likelihoods of a step of this dtype, as beam_kernel.pick
    chooses: kernels=None takes the kernel's wrapper for float32 and the
    plain version otherwise, False the plain version, True the wrapper (a
    dtype other than float32 raises)."""
    if kernels and dtype != torch.float32:
        raise ValueError(f"the mixture likelihood kernel is float32 only, not {dtype}")
    return mixture_rest if (dtype == torch.float32 if kernels is None else kernels) else mixture_rest_plain


def mixture_rest(predicted: SGM, corrected: SGM, jmeans, jvalid):
    """mixture_rest_plain for CPU tensors; for CUDA tensors one launch of
    the kernel, raising on what it does not take. predicted leaves [P, KP],
    corrected [P, KC], float32 and contiguous; jmeans 3 float32 [P, E]
    sharing one stride (views of one [P, E, 3] tensor too); jvalid bool
    [P, E]."""
    dev = jvalid.device
    if dev.type == "cpu":
        return mixture_rest_plain(predicted, corrected, jmeans, jvalid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, e = jvalid.shape
    kp, kc = predicted.capacity, corrected.capacity
    for name, leaves, k in (("predicted", predicted, kp), ("corrected", corrected, kc)):
        for field, leaf in zip(SGM._fields, leaves):
            if leaf.device != dev or leaf.dtype != torch.float32 or leaf.shape != (p, k):
                raise ValueError(f"{name}.{field}: expected float32 {(p, k)} on {dev}, got "
                                 f"{leaf.dtype} {tuple(leaf.shape)} on {leaf.device}")
            if not leaf.is_contiguous():
                raise ValueError(f"{name}.{field} must be contiguous")
    strides = jmeans[0].stride()
    for i, x in enumerate(jmeans):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (p, e) or x.stride() != strides:
            raise ValueError(f"jmeans[{i}]: expected float32 {(p, e)} on {dev} with strides {strides}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device} with strides {x.stride()}")
    if jvalid.dtype != torch.bool or not jvalid.is_contiguous():
        raise ValueError(f"jvalid must be a contiguous bool tensor, got {jvalid.dtype}")
    if layout_bytes(max(kp, kc), e) > _build.SMEM_LIMIT:
        raise ValueError(f"the mixture likelihood kernel takes no E={e} beside K={max(kp, kc)}")
    rest = torch.empty((p,), dtype=torch.float32, device=dev)
    pred_ptrs = (ctypes.c_void_p * 10)(*[leaf.data_ptr() for leaf in predicted])
    cor_ptrs = (ctypes.c_void_p * 10)(*[leaf.data_ptr() for leaf in corrected])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            pred_ptrs, cor_ptrs, p, kp, kc, *[x.data_ptr() for x in jmeans], jvalid.data_ptr(),
            e, strides[0], strides[1], rest.data_ptr(), stream,
        )
    _build.check(err, "mixture_ll_launch")
    mixture_rest.launches += 1
    return rest


mixture_rest.launches = 0
