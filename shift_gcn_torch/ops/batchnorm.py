"""Batch normalization: eval mode from running statistics, train mode
from batch statistics.

The model uses three BN layouts, all nn.BatchNorm defaults (eps=1e-5);
in every one the features are the trailing axes of a channels-last tensor:

- ``data_bn``: M*V*C features of (N, T, M*V*C) (reference:
  model/shift_gcn.py:176, 196-198),
- Shift_gcn ``bn``: V*C_out features, laid out as the trailing (V, C) of
  (N, T, V, C) (reference: model/shift_gcn.py:99, 137),
- Shift_tcn / residual / down BN: C features of (N, T, V, C).

Numerics follow the reference package.  Eval: fp32 activations are
normalized as ``(x - mean) * rsqrt(var + eps) * w + b``; low-precision
activations use per-feature coefficients ``x * a + b`` with a and b
derived in fp32 and cast to the activation dtype (its eval default).
Train (``batch_norm_train``): batch mean and biased variance in fp32 as
E[x^2] - E[x]^2 over every axis but the features, the same fp32
normalize whatever the activation dtype (its training default), output
in x.dtype; running statistics move with momentum 0.1 toward the batch
mean and the unbiased variance, and ``num_batches_tracked`` counts the
batch (PyTorch's BatchNorm semantics).  Gradients come from autograd
through these stock ops, as the reference package takes them from
autodiff.
"""

from __future__ import annotations

import torch
from torch import nn


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               feature_dims: int = 1, eps: float = 1e-5) -> torch.Tensor:
    """Normalize x whose trailing ``feature_dims`` axes are the features;
    the flat (num_features,) statistics are reshaped to them."""
    shape = x.shape[x.dim() - feature_dims:]
    inv = torch.rsqrt(running_var + eps)
    if x.dtype != torch.float32:
        a = inv * weight
        b = bias - running_mean * a
        return x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
    return ((x - running_mean.reshape(shape)) * inv.reshape(shape)
            * weight.reshape(shape) + bias.reshape(shape))


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, *,
                     feature_dims: int = 1, momentum: float = 0.1,
                     eps: float = 1e-5) -> torch.Tensor:
    """Normalize x by its batch statistics over every axis but the
    trailing ``feature_dims``, and update the running statistics in
    place."""
    dims = tuple(range(x.dim() - feature_dims))
    shape = x.shape[x.dim() - feature_dims:]
    x32 = x.float()
    mean = x32.mean(dims)
    var = (x32 * x32).mean(dims) - mean * mean  # biased
    n = x.numel() // mean.numel()
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        running_mean.copy_((1 - momentum) * running_mean
                           + momentum * mean.reshape(-1))
        running_var.copy_((1 - momentum) * running_var
                          + momentum * unbiased.reshape(-1))
        num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + eps)
    out = ((x32 - mean) * inv * weight.reshape(shape)
           + bias.reshape(shape))
    return out.to(x.dtype)


class BatchNorm(nn.Module):
    """Holds BN parameters and running statistics under the torch
    BatchNorm names; its forward normalizes by batch statistics in
    training mode and by the running statistics otherwise."""

    def __init__(self, num_features: int, feature_dims: int = 1):
        super().__init__()
        self.feature_dims = feature_dims
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.num_batches_tracked,
                feature_dims=self.feature_dims)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, feature_dims=self.feature_dims)
