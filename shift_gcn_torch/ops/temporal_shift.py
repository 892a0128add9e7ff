"""Learnable fractional temporal shift, forward only (eval path).

Per channel c, with temporal stride s and y = ypos[c] (+0.5 when s != 1,
the reference Shift module's rule):

    out[n, t, v, c] = (1 - f) * x[n, t*s + lo, v, c] + f * x[n, t*s + lo + 1, v, c]

with lo = floor(y), f = y - lo, and reads outside [0, T) taken as zero.
T_out = T // s.  Layout is channels-last (N, T, V, C).

The joint-axis position ``xpos`` is treated as exactly zero: its init is
U(-1e-8, 1e-8), the reference's constraint backward zeroes its gradient
and weight decay only shrinks it, so its bilinear contribution stays below
fp32 rounding for the life of any run.

The reference package sums taps only inside the static radius
[-max_shift, max_shift + 1], while the kernel here reads the two frames
directly at any offset.  ``assert_in_range`` keeps every loaded ``ypos``
inside that radius, so the two agree by construction.

``temporal_shift`` is the entry point: on a CPU tensor it runs the plain
version ``temporal_shift_reference``; on a CUDA tensor it launches the
hand-written kernel (``csrc/temporal_shift.cu``) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from shift_gcn_torch import kernels

DEFAULT_MAX_SHIFT = 8


def temporal_shift_reference(x: torch.Tensor, ypos: torch.Tensor,
                             stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 math, output in x.dtype."""
    n, t_in, v, c = x.shape
    t_out = t_in // stride
    y = ypos.float().to(x.device)
    y = y if stride == 1 else y + 0.5
    lo_f = torch.floor(y)
    frac = y - lo_f
    lo = lo_f.to(torch.int64)
    t = torch.arange(t_out, device=x.device)[:, None] * stride + lo  # (T', C)

    def frames(idx: torch.Tensor) -> torch.Tensor:
        valid = (idx >= 0) & (idx < t_in)
        gather = idx.clamp(0, t_in - 1)[None, :, None, :].expand(
            n, t_out, v, c)
        vals = torch.gather(x, 1, gather).float()
        return vals * valid[None, :, None, :]

    out = (1.0 - frac) * frames(t) + frac * frames(t + 1)
    return out.to(x.dtype)


def temporal_shift(x: torch.Tensor, ypos: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """(N, T, V, C) -> (N, T // stride, V, C); see the module docstring."""
    if x.device.type == "cpu":
        return temporal_shift_reference(x, ypos, stride)
    if x.device.type != "cuda":
        raise ValueError(f"temporal_shift: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"temporal_shift: unsupported dtype {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("temporal_shift: x must be a contiguous (N, T, V, C) "
                         "tensor")
    n, t_in, v, c = x.shape
    if (ypos.shape != (c,) or ypos.dtype != torch.float32
            or ypos.device != x.device or not ypos.is_contiguous()):
        raise ValueError("temporal_shift: ypos must be a contiguous fp32 "
                         f"({c},) tensor on {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError("temporal_shift: tensor too large for 32-bit "
                         "indexing")
    t_out = t_in // stride
    out = torch.empty((n, t_out, v, c), dtype=x.dtype, device=x.device)
    status = kernels.library("temporal_shift").temporal_shift_forward(
        x.data_ptr(), ypos.data_ptr(), out.data_ptr(), n, t_in, t_out, v, c,
        stride, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(status, "temporal_shift")
    kernels.LAUNCHES["temporal_shift"] += 1
    return out


def assert_in_range(ypos, name: str = "ypos",
                    max_shift: int = DEFAULT_MAX_SHIFT) -> None:
    """Raise if a shift position reaches max_shift - 0.5 in magnitude."""
    arr = ypos.detach().cpu().numpy() if torch.is_tensor(ypos) else ypos
    m = float(np.max(np.abs(np.asarray(arr)))) if np.size(arr) else 0.0
    if m >= max_shift - 0.5:
        raise ValueError(
            f"{name} magnitude {m:.2f} reaches the tap radius "
            f"max_shift={max_shift} of the reference lowering; "
            "raise max_shift in the model config")
