"""PyTorch/CUDA port of monorfs_tpu: RB-PHD SLAM on an NVIDIA Hopper GPU.

The package mirrors the JAX package's layout (geometry/, gm/, models/, sim/,
slam/, bench_core.py) and imports nothing from it. Plain tensor code is
PyTorch; the two Pallas TPU kernels of the PHD step are hand-written CUDA
kernels for sm_90a (csrc/), built at first use by _build.py.

Entry points take an explicit `device` that defaults to "cuda" and raise when
no GPU is present; tests pass device="cpu", where every kernel wrapper runs
its plain PyTorch version.
"""

import torch

# fp32 everywhere: one-hot gathers, moment pools and gating thresholds lose
# decisions at TF32's ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """torch.device for an entry point; a CUDA device with no GPU raises
    instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
