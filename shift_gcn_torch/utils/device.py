"""Device selection for the port's entry points, and the fp32 math
setting of its models."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device; raises if it is CUDA and no GPU is present.

    Entry points default to ``"cuda"`` and never fall back to the CPU:
    a caller who wants the CPU (the plain PyTorch path) passes
    ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return device


def pin_fp32_math() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions.

    cuDNN convolutions default to TF32, which keeps ~3 decimal digits and
    would break the fp32 parity of the models' convs with the reference;
    matmuls and einsums are pinned to full fp32 for the same reason.  Every
    model calls this when it is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
