"""Fused spatial Shift-GCN transform: kernel wrapper.

``fused_shift_gcn(x, gate, w, bias)`` computes, for x (R, V, C),

    out = shift_out((shift_in(x) * gate) @ w + bias)        -> (R, V, D)

On a CPU tensor it runs the plain version
(``ops.spatial_shift.shift_gcn_transform``); on a CUDA tensor it launches
the hand-written kernel (``csrc/shift_gcn.cu``) or raises.  Math is fp32;
the output follows x.dtype (fp32 or bf16).
"""

from __future__ import annotations

import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.ops.spatial_shift import shift_gcn_transform


def fused_shift_gcn(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D)."""
    if x.device.type == "cpu":
        return shift_gcn_transform(x, gate, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_shift_gcn: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_shift_gcn: unsupported dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_shift_gcn: x must be a contiguous (R, V, C) "
                         "tensor")
    r, v, c = x.shape
    d = w.shape[-1]
    for name, t, shape in (("gate", gate, (v, c)), ("w", w, (c, d)),
                           ("bias", bias, (d,))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"fused_shift_gcn: {name} must be a contiguous "
                             f"fp32 {shape} tensor on {x.device}")
    if v > 160:
        raise ValueError(f"fused_shift_gcn: V={v} exceeds the kernel's "
                         "160-row frame tile")
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("fused_shift_gcn: tensor too large for 32-bit "
                         "indexing")
    out = torch.empty((r, v, d), dtype=x.dtype, device=x.device)
    status = kernels.library("shift_gcn").shift_gcn_forward(
        x.data_ptr(), gate.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), r, v, c, d, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(status, "shift_gcn")
    kernels.LAUNCHES["shift_gcn"] += 1
    return out
