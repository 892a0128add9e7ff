"""Convolutions in channels-last layout with torch-shaped weights.

Weights keep the torch state_dict shapes — conv weight (C_out, C_in, kT,
kV), bias (C_out,) — so reference checkpoints load as they are.  Both ops
return the input's activation dtype and add the bias after the product,
as the reference package does.  ``pointwise_conv`` takes the model's
``compute_dtype``, the type its matmul inputs are rounded to;
``temporal_conv`` has none, as the reference's ignores it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def pointwise_conv(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """1x1 conv as a matmul. x: (..., C_in); weight: (C_out, C_in, 1, 1)
    or (C_out, C_in).  Returns (..., C_out) in x.dtype.

    With ``compute_dtype`` both inputs are rounded to it and multiplied
    with fp32 accumulation, the result cast to x.dtype (the reference's
    ``preferred_element_type=float32``): the products of bf16 values are
    exact in fp32, so the rounded inputs go through an fp32 matmul."""
    w = weight.reshape(weight.shape[0], weight.shape[1])
    if compute_dtype is not None:
        out = torch.matmul(x.to(compute_dtype).float(),
                           w.t().to(compute_dtype).float()).to(x.dtype)
    else:
        out = torch.matmul(x, w.t().to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def temporal_conv(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  stride: int = 1) -> torch.Tensor:
    """k x 1 temporal conv with padding (k-1)//2 and temporal stride.

    Matches the reference residual ``tcn`` (model/shift_gcn.py:31-45):
    Conv2d(kernel=(k,1), padding=((k-1)//2, 0), stride=(s,1)).
    x: (N, T, V, C_in); weight: (C_out, C_in, k, 1) -> (N, T_out, V, C_out).
    """
    k = weight.shape[2]
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                   stride=(stride, 1), padding=((k - 1) // 2, 0))
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


class Conv(nn.Module):
    """Conv weight and bias under the torch Conv2d names."""

    def __init__(self, cin: int, cout: int, k: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
