"""Batched association beam scan: the Hopper counterpart of
monorfs_tpu/slam/beam_pallas.py::beam_scan_batch (kernel: csrc/beam_scan.cu).

beam_scan_batch launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version (association.beam_scan, the same function with the same
semantics) for CPU tensors. The two are bit-identical."""

import ctypes
import functools

import torch

from .. import _build
from .association import beam_scan as beam_scan_plain


@functools.cache
def _launcher():
    return _build.function(
        "beam_scan_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


# csrc/beam_scan.cu's constants of the shape decision
_SMEM_MAX = _build.SMEM_LIMIT
_WARP_PARTICLES = 4
_NWMAX = 4
_BLOCK_THREADS = 256
_WIDE_THREADS = 1024
_MAX_CANDIDATES = 65535
_RADIX = 256


def _warp_words(m, c):
    return m * (c + 1) + 2 * m * c + 2


def block_k(nc):
    """Candidates a thread of the block design owns at nc = B(C+1) (the
    Python copy of block_k): the fewest of 2..32 that fit 256 threads, else
    the fewest of 16..64 that fit 1024, up to 65,535; 0 past that."""
    ks = [(k, _BLOCK_THREADS) for k in (2, 4, 8, 16, 32)]
    ks += [(k, _WIDE_THREADS) for k in (16, 32, 64)] if nc <= _MAX_CANDIDATES else []
    return next((k for k, threads in ks if -(-nc // k) <= threads), 0)


def layout_bytes(m, c, beam_width, n_words):
    """The Python copy of beam_scan_smem_bytes (use_warp, block_k,
    block_layout's total, SMEM_MAX): shared memory one block asks for at
    this shape, 0 when no design of the kernel takes it."""
    ww = 4 * _warp_words(m, c)
    if beam_width <= 32 and c + 1 <= 8 and n_words <= _NWMAX and ww <= _SMEM_MAX:
        return ww * min(_SMEM_MAX // ww, _WARP_PARTICLES)
    if block_k(beam_width * (c + 1)) == 0:
        return 0
    words = 2 * (beam_width + 1) + m * (c + 1) + 2 * m * c + 2 * beam_width + 2 * beam_width * n_words
    words = (words + 3) & ~3  # the histogram, 16-byte aligned
    words += _RADIX + 32 + 4
    return 4 * words if 4 * words <= _SMEM_MAX else 0


def takes(m, c, beam_width, n_words):
    """Whether the kernel takes this shape (beam_scan_smem_bytes non-zero)."""
    return layout_bytes(m, c, beam_width, n_words) > 0


@functools.cache
def smem_bytes(m, c, beam_width, n_words):
    """Shared memory one block of the kernel asks for at this shape; 0 when
    no design of the kernel takes it."""
    fn = _build.function("beam_scan_smem_bytes", [ctypes.c_int] * 4, ctypes.c_size_t)
    return fn(m, c, beam_width, n_words)


def beam_scan_batch(base, opt_delta, word_k, bit_k, beam_width, n_words):
    """base [P] f32, opt_delta [P, M, C+1] f32, word_k / bit_k [P, M, C]
    int32 -> final beam scores [P, B] f32 (NEG = empty slot)."""
    if opt_delta.device.type == "cpu":
        return beam_scan_plain(base, opt_delta, word_k, bit_k, beam_width, n_words)
    p, m, c1 = opt_delta.shape
    c = c1 - 1
    if opt_delta.device.type != "cuda":
        raise ValueError(f"unsupported device {opt_delta.device}")
    for name, t, dt, shape in (
        ("base", base, torch.float32, (p,)),
        ("opt_delta", opt_delta, torch.float32, (p, m, c1)),
        ("word_k", word_k, torch.int32, (p, m, c)),
        ("bit_k", bit_k, torch.int32, (p, m, c)),
    ):
        if t.device != opt_delta.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dt} {shape} on {opt_delta.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if beam_width < 1 or n_words < 1:
        raise ValueError("beam_width and n_words must be positive")
    if not 0 < smem_bytes(m, c, beam_width, n_words) <= _build.SMEM_LIMIT:
        raise ValueError(f"the beam kernel takes no B={beam_width} C={c} M={m} n_words={n_words}")
    out = torch.empty((p, beam_width), dtype=torch.float32, device=opt_delta.device)
    with torch.cuda.device(opt_delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            base.data_ptr(), opt_delta.data_ptr(), word_k.data_ptr(),
            bit_k.data_ptr(), out.data_ptr(), p, m, c, beam_width, n_words, stream,
        )
    _build.check(err, "beam_scan_launch")
    beam_scan_batch.launches += 1
    return out


beam_scan_batch.launches = 0
