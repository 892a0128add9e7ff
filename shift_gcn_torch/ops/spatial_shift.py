"""Spatial channel shift for Shift-GCN, in plain PyTorch.

The reference shifts the flattened (V*C) axis with precomputed
``index_select`` indices (reference: model/shift_gcn.py:108-118), which
reduces to a per-channel circular roll along the joint axis:

    shift_in :  out[v, c] = x[(v + c) mod V, c]
    shift_out:  out[v, c] = x[(v - c) mod V, c]

``shift_gcn_transform`` chains shift_in, the gate, the pointwise matmul
with bias and shift_out.  It is the plain version of the fused kernel in
``ops/shift_gcn_kernel.py`` and keeps that kernel's numerics: fp32 math
after the load, one rounding to x.dtype at the end.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def shift_indices(num_nodes: int, channels: int, direction: int) -> np.ndarray:
    """(V, C) int64 index matrix: out[v, c] = x[idx[v, c], c].

    direction=+1 reproduces the reference ``shift_in`` rule, -1
    ``shift_out``.
    """
    v = np.arange(num_nodes)[:, None]
    c = np.arange(channels)[None, :]
    return (v + direction * c) % num_nodes


def flat_shift_index(num_nodes: int, channels: int,
                     direction: int) -> np.ndarray:
    """The reference's flat (V*C) ``index_select`` buffer
    (model/shift_gcn.py:108-118): out[i*C + j] = x[idx[i*C + j]], int64."""
    i = np.arange(num_nodes)[:, None]
    j = np.arange(channels)[None, :]
    idx = (i * channels + j + direction * j * channels) % (
        channels * num_nodes)
    return idx.reshape(-1).astype(np.int64)


def spatial_shift(x: torch.Tensor, direction: int) -> torch.Tensor:
    """Per-channel circular roll along the joint axis of (..., V, C)."""
    v, c = x.shape[-2], x.shape[-1]
    idx = torch.from_numpy(shift_indices(v, c, direction)).to(x.device)
    return torch.gather(x, -2, idx.expand(x.shape))


def shift_gcn_transform(x: torch.Tensor, gate: torch.Tensor,
                        weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """shift_out((shift_in(x) * gate) @ weight + bias).

    x: (..., V, C); gate: (V, C) (tanh(Feature_Mask) + 1); weight: (C, D);
    bias: (D,).  Returns (..., V, D) in x.dtype.
    """
    h = spatial_shift(x.float(), +1) * gate.float()
    z = torch.matmul(h, weight.float()) + bias.float()
    return spatial_shift(z, -1).to(x.dtype)
