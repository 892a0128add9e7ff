"""Device selection for the port's entry points."""

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
