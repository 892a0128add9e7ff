"""Spatial channel shift for Shift-GCN, in plain PyTorch.

The reference shifts the flattened (V*C) axis with precomputed
``index_select`` indices (reference: model/shift_gcn.py:108-118), which
reduces to a per-channel circular roll along the joint axis:

    shift_in :  out[v, c] = x[(v + c) mod V, c]
    shift_out:  out[v, c] = x[(v - c) mod V, c]

``shift_gcn_transform`` chains shift_in, the gate, the pointwise matmul
with bias and shift_out.  It is the plain version of the fused kernel K4
in ``ops/shift_gcn_kernel.py``; ``shift_gcn_dx_reference`` and
``shift_gcn_wgrad_reference`` are the plain versions of its backward
kernels K5 and K6.  All keep the kernels' numerics: fp32 math after the
load, one rounding to the output dtype at the end (K6's outputs are
fp32).

Under tensor parallelism a rank holds output channels [d0, d0 + D) of
the layer (``parallel/tensor.py``): its weight and bias are that column
slice, and every shear on the output-channel axis rolls channel j by
the global d0 + j.  The three take ``d0`` (0: the whole layer); their
results are then the matching columns of the whole layer's output and
dW / dbias, and this slice's parts of dx and dgate, which sum over the
slices to the whole layer's.
"""

from __future__ import annotations

import functools
import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def shift_indices(num_nodes: int, channels: int, direction: int,
                  offset: int = 0) -> np.ndarray:
    """(V, C) int64 index matrix: out[v, c] = x[idx[v, c], c].

    direction=+1 reproduces the reference ``shift_in`` rule, -1
    ``shift_out``; channel c rolls as channel ``offset`` + c of a wider
    layer.
    """
    v = np.arange(num_nodes)[:, None]
    c = np.arange(offset, offset + channels)[None, :]
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


def spatial_shift(x: torch.Tensor, direction: int,
                  offset: int = 0) -> torch.Tensor:
    """Per-channel circular roll along the joint axis of (..., V, C),
    channel c rolled as channel ``offset`` + c."""
    v, c = x.shape[-2], x.shape[-1]
    idx = torch.from_numpy(shift_indices(v, c, direction, offset)).to(
        x.device)
    return torch.gather(x, -2, idx.expand(x.shape))


def shift_gcn_transform(x: torch.Tensor, gate: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        d0: int = 0) -> torch.Tensor:
    """shift_out((shift_in(x) * gate) @ weight + bias).

    x: (..., V, C); gate: (V, C) (tanh(Feature_Mask) + 1); weight: (C, D),
    output channels [d0, d0 + D) of the layer; bias: (D,).  Returns
    (..., V, D) in x.dtype.
    """
    h = spatial_shift(x.float(), +1) * gate.float()
    z = torch.matmul(h, weight.float()) + bias.float()
    return spatial_shift(z, -1, d0).to(x.dtype)


def shift_gcn_dx_reference(g: torch.Tensor, gate: torch.Tensor,
                           weight: torch.Tensor,
                           d0: int = 0) -> torch.Tensor:
    """Input gradient of ``shift_gcn_transform`` (K5's plain version):
    shift_out((shift_in(g) @ weight.T) * gate).

    g: (..., V, D) cotangent of output channels [d0, d0 + D); gate:
    (V, C); weight: (C, D).  Returns (..., V, C) in g.dtype.
    """
    dh = torch.matmul(spatial_shift(g.float(), +1, d0), weight.float().t())
    return spatial_shift(dh * gate.float(), -1).to(g.dtype)


def shear_in_reference(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """shift_in(x) in fp32, channels from ``offset``.  x: (..., V, C)."""
    return spatial_shift(x.float(), +1, offset)


def shift_gcn_wgrad_reference(x: torch.Tensor, g: torch.Tensor,
                              gate: torch.Tensor, weight: torch.Tensor,
                              d0: int = 0):
    """Weight gradients of ``shift_gcn_transform`` (K6's plain version).

    x: (R, V, C) forward input; g: (R, V, D) cotangent of output channels
    [d0, d0 + D); gate: (V, C); weight: (C, D).  With the per-joint
    product over R

        M[u] = shift_in(x)[:, u, :]^T @ shift_in(g)[:, u, :]    (V, C, D)

    returns (dgate (V, C), dw (C, D), dbias (D,)), all fp32:
    dgate = sum_d M * weight, dw = sum_u gate * M, dbias = sum of g over
    (R, V) (the shear permutes within a frame).
    """
    sx, gz = shear_in_reference(x), shear_in_reference(g, d0)
    m = torch.matmul(sx.permute(1, 2, 0), gz.permute(1, 0, 2))
    dgate = (m * weight.float()[None]).sum(-1)
    dw = (m * gate.float()[:, :, None]).sum(0)
    return dgate, dw, gz.sum((0, 1))
