"""Batch normalization: eval mode from running statistics, train mode
from batch statistics.

The model uses three BN layouts, all nn.BatchNorm defaults (eps=1e-5);
in every one the features are the trailing axes of a channels-last tensor:

- ``data_bn``: M*V*C features of (N, T, M*V*C) (reference:
  model/shift_gcn.py:176, 196-198),
- Shift_gcn ``bn``: V*C_out features, laid out as the trailing (V, C) of
  (N, T, V, C) (reference: model/shift_gcn.py:99, 137),
- Shift_tcn / residual / down BN: C features of (N, T, V, C).

Numerics follow the reference package.  The normalize pass is
``(x32 - mean) * rsqrt(var + eps) * w + b`` in fp32, output in x.dtype;
with ``lp`` set and low-precision activations it is instead ``x * a + b``
in the activation dtype, with per-feature coefficients a and b derived
in fp32 and cast to it.  ``lp`` follows the model's lowering
(``ops/lowering.py``): ``bn_lp`` in training (default off), ``bn_lp_eval``
in eval (default on), which ``BatchNorm`` holds as ``lp_train`` and
``lp_eval``.  Eval normalizes by the running statistics.  Train
(``batch_norm_train``): batch mean and biased variance in fp32 as
E[x^2] - E[x]^2 over every axis but the features; running statistics
move with momentum 0.1 toward the batch mean and the unbiased variance,
and ``num_batches_tracked`` counts the batch (PyTorch's BatchNorm
semantics).  Gradients come from autograd through these stock ops, as
the reference package takes them from autodiff.

Sync BN: with a process ``group`` (``BatchNorm.group``, set by
``parallel.seqpar.attach``) the train-mode E[x] and E[x^2] are averaged
over the group's ranks, whose shards are of equal size, before the
variance is taken, the count for the unbiased running variance is
multiplied by the group size, and the backward averages the statistics'
cotangents over the group (``parallel.comm.all_reduce_mean``): the
reference's ``_batch_stats`` with ``pmean`` over ``axis_name``.

Recomputation (``ModelConfig.remat``): inside ``frozen_statistics`` a
train-mode BN normalizes by its batch statistics as before (their
all-reduce included) and updates no running statistic, so a block run
again in the backward leaves the first pass's state, as the reference
package's per-block checkpoint returns it.  The flag is per thread: it
is set by the recomputation's own context, on the thread that
recomputes.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from shift_gcn_torch.parallel import comm

_local = threading.local()


@contextlib.contextmanager
def frozen_statistics():
    """Train-mode BN inside updates no running statistic."""
    saved = getattr(_local, "frozen", False)
    _local.frozen = True
    try:
        yield
    finally:
        _local.frozen = saved


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of the statistics and the full-precision normalize: fp32,
    or fp64 for fp64 activations (a float64 reference run)."""
    return torch.promote_types(dtype, torch.float32)


def _normalize(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, shape, lp: bool,
               x_wide=None) -> torch.Tensor:
    """The normalize pass with fp32 statistics of the feature ``shape``
    (or broadcastable to it): in the statistics' type (``x_wide``, x in
    it, where the caller has it), or ``x * a + b`` in x.dtype when ``lp``
    and x is not fp32."""
    if lp and x.dtype != torch.float32:
        a = inv * weight.reshape(shape)
        b = bias.reshape(shape) - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)
    if x_wide is None:
        x_wide = x.to(stat_dtype(x.dtype))
    return ((x_wide - mean) * inv * weight.reshape(shape)
            + bias.reshape(shape)).to(x.dtype)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               feature_dims: int = 1, eps: float = 1e-5,
               lp: bool = True) -> torch.Tensor:
    """Normalize x whose trailing ``feature_dims`` axes are the features
    by the running statistics; the flat (num_features,) statistics are
    reshaped to them."""
    shape = x.shape[x.dim() - feature_dims:]
    inv = torch.rsqrt(running_var + eps).reshape(shape)
    return _normalize(x, running_mean.reshape(shape), inv, weight, bias,
                      shape, lp)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, *,
                     feature_dims: int = 1, momentum: float = 0.1,
                     eps: float = 1e-5, lp: bool = False,
                     group=None, update: bool = True) -> torch.Tensor:
    """Normalize x by its batch statistics over every axis but the
    trailing ``feature_dims`` (and over the ranks of ``group``), and
    update the running statistics in place unless ``update`` is off."""
    dims = tuple(range(x.dim() - feature_dims))
    shape = x.shape[x.dim() - feature_dims:]
    x32 = x.to(stat_dtype(x.dtype))
    # E[x] and E[x^2] in one tensor, reduced over the group in one call;
    # the same graph with and without a group, so a group of one rank
    # gives the same bits
    stats = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
    n = x.numel() // stats[0].numel()
    if group is not None:
        stats = comm.all_reduce_mean(stats, group)
        n *= torch.distributed.get_world_size(group)
    mean, mean_sq = stats.unbind(0)
    var = mean_sq - mean * mean  # biased
    if update:
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean.reshape(-1))
            running_var.copy_((1 - momentum) * running_var
                              + momentum * unbiased.reshape(-1))
            num_batches_tracked.add_(1)
    return _normalize(x, mean, torch.rsqrt(var + eps), weight, bias, shape,
                      lp, x32)


class BatchNorm(nn.Module):
    """Holds BN parameters and running statistics under the torch
    BatchNorm names; its forward normalizes by batch statistics in
    training mode and by the running statistics otherwise.  ``lp_train``
    and ``lp_eval`` choose the low-precision normalize pass in each mode
    (the lowering's ``bn_lp`` and ``bn_lp_eval``; a model sets them)."""

    def __init__(self, num_features: int, feature_dims: int = 1):
        super().__init__()
        self.feature_dims = feature_dims
        self.lp_train = False
        self.lp_eval = True
        self.group = None  # sync BN's process group (parallel/seqpar.py)
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
                feature_dims=self.feature_dims, lp=self.lp_train,
                group=self.group,
                update=not getattr(_local, "frozen", False))
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, feature_dims=self.feature_dims,
                          lp=self.lp_eval)
