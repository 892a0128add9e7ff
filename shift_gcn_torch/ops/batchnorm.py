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
semantics).

Train mode is one autograd Function, ``BatchNormTrainFunction``.  It
saves x in its own dtype and the per-feature mean and inv = rsqrt(var +
eps), and its backward is the analytic one, with xhat = (x - mean) * inv
recomputed from them:

    db = sum dy,   dw = sum dy * xhat,
    dx = (w * inv) * ((dy - db / n) - xhat * dw / n).

Its two raw launchers, ``batch_norm_train_forward`` and
``batch_norm_train_backward``, run their plain PyTorch versions
(``batch_norm_train_forward_reference``, the stock ops above, and
``batch_norm_train_backward_reference``, the formula written out) on a
CPU tensor, and the hand-written kernels of ``csrc/batchnorm.cu`` on a
CUDA tensor (fp32, bf16 or fp16 activations), or raise: a statistics
pass, a finish and a normalize pass forward, a sums pass and a dx pass
backward, each launch counted once in ``kernels.LAUNCHES``.  x is taken
as a row-major (R, F) array of its F trailing features, so a CUDA input
is made contiguous first (``data_bn``'s, a transposed view, is copied).

Sync BN: with a process ``group`` (``BatchNorm.group``, set by
``parallel.seqpar.attach``) the train-mode E[x] and E[x^2] are averaged
over the group's ranks, whose shards are of equal size, before the
variance is taken, and the count for the unbiased running variance is
multiplied by the group size: the reference's ``_batch_stats`` with
``pmean`` over ``axis_name``.  The backward averages db / n and dw / n
over the group before the dx pass (``parallel.comm.all_reduce_mean``),
which is the adjoint the averaged statistics give, while dw and db stay
each rank's own sums.

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
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from shift_gcn_torch import kernels
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


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' oracles on the card)
# ---------------------------------------------------------------------------


def batch_norm_train_forward_reference(
        x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
        running_mean: torch.Tensor, running_var: torch.Tensor,
        num_batches_tracked: torch.Tensor, *, feature_dims: int = 1,
        momentum: float = 0.1, eps: float = 1e-5, lp: bool = False,
        group=None, update: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in stock ops: (y in x.dtype, mean_inv (2, F) in the
    statistics' type, rows mean and rsqrt(var + eps)); the running
    statistics updated in place unless ``update`` is off."""
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
    inv = torch.rsqrt(var + eps)
    if update:
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean.reshape(-1))
            running_var.copy_((1 - momentum) * running_var
                               + momentum * unbiased.reshape(-1))
            num_batches_tracked.add_(1)
    y = _normalize(x, mean, inv, weight, bias, shape, lp, x32)
    return y, torch.stack([mean.reshape(-1), inv.reshape(-1)])


def batch_norm_train_backward_reference(
        x: torch.Tensor, dy: torch.Tensor, mean_inv: torch.Tensor,
        weight: torch.Tensor, *, feature_dims: int = 1, group=None,
        want_dx: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The analytic backward in stock ops, in the statistics' type:
    (dx in x.dtype or None without ``want_dx``, dw, db in weight.dtype)."""
    dims = tuple(range(x.dim() - feature_dims))
    shape = x.shape[x.dim() - feature_dims:]
    mean, inv = (t.reshape(shape) for t in mean_inv.unbind(0))
    xhat = (x.to(mean_inv.dtype) - mean) * inv
    g = dy.to(mean_inv.dtype)
    db = g.sum(dims)
    dw = (g * xhat).sum(dims)
    dx = None
    if want_dx:
        means = torch.stack([db, dw]) / (x.numel() // db.numel())
        if group is not None:
            means = comm.all_reduce_mean(means, group)
        g_mean, gx_mean = means.unbind(0)
        dx = ((weight.reshape(shape) * inv)
              * (g - g_mean - xhat * gx_mean)).to(x.dtype)
    return dx, dw.reshape(-1).to(weight.dtype), db.reshape(-1).to(
        weight.dtype)


# ---------------------------------------------------------------------------
# Raw launchers: plain version on a CPU tensor, kernels on a CUDA tensor
# ---------------------------------------------------------------------------

# csrc/batchnorm.cu: a pass's block (kThreads), the most feature lanes of
# one (kMaxLanes), and the grid's target size: about 8 blocks an SM of an
# H100's 132, fixed here so that the chunks, and so the order of the
# sums, depend on the shapes alone
PASS_THREADS = 256
MAX_LANES = 32
TARGET_BLOCKS = 1024
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class LaunchPlan(NamedTuple):
    """A pass's grid over (R, F): runs of ``vec`` features, ``lanes``
    runs a block across ``tiles`` tiles, ``chunks`` row chunks of
    ``chunk_rows`` rows (the last may be shorter)."""
    vec: int
    lanes: int
    tiles: int
    chunks: int
    chunk_rows: int


def launch_plan(r: int, f: int, itemsize: int, aligned: bool) -> LaunchPlan:
    """The plan of the kernels' passes over (r, f): 16-byte runs where F
    is a multiple of them and the tensors are 16-byte aligned, else one
    element; lanes the power of two that covers F's runs (at most 32);
    about TARGET_BLOCKS blocks, each chunk at least a row per row lane."""
    per_vector = 16 // itemsize
    vec = per_vector if aligned and f % per_vector == 0 else 1
    runs = f // vec
    lanes = 1
    while lanes < min(runs, MAX_LANES):
        lanes *= 2
    tiles = -(-runs // lanes)
    rlanes = PASS_THREADS // lanes
    chunks = max(1, min(-(-TARGET_BLOCKS // tiles), -(-r // rlanes)))
    chunk_rows = -(-r // chunks)
    return LaunchPlan(vec, lanes, tiles, -(-r // chunk_rows), chunk_rows)


def _rows(x: torch.Tensor, feature_dims: int) -> Tuple[int, int]:
    """(R, F): the product of the leading axes and of the feature axes."""
    f = 1
    for size in x.shape[x.dim() - feature_dims:]:
        f *= size
    return x.numel() // max(f, 1), f


def _check_cuda(name: str, x: torch.Tensor, f: int, *params) -> None:
    """x: a contiguous CUDA activation of a supported dtype and at least
    one row; each of ``params`` a contiguous fp32 (F,) tensor on its
    device (or None)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous tensor")
    if x.numel() // f >= 2 ** 31 or f >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for 32-bit rows")
    for t in params:
        if t is not None and (t.shape != (f,) or t.dtype != torch.float32
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: weight, bias and running statistics "
                             f"must be contiguous fp32 ({f},) tensors on "
                             f"{x.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def batch_norm_train_forward(
        x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
        running_mean: torch.Tensor, running_var: torch.Tensor,
        num_batches_tracked: torch.Tensor, *, feature_dims: int = 1,
        momentum: float = 0.1, eps: float = 1e-5, lp: bool = False,
        group=None, update: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BN forward: (y, mean_inv (2, F): mean and inv); the
    running statistics updated in place unless ``update`` is off."""
    name = "batch_norm_train"
    kernels.refuse_grad(name, x, weight, bias)
    if x.device.type == "cpu":
        return batch_norm_train_forward_reference(
            x, weight, bias, running_mean, running_var, num_batches_tracked,
            feature_dims=feature_dims, momentum=momentum, eps=eps, lp=lp,
            group=group, update=update)
    r, f = _rows(x, feature_dims)
    _check_cuda(name, x, f, weight, bias, running_mean, running_var)
    if (num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.device != x.device):
        raise ValueError(f"{name}: num_batches_tracked must be an int64 "
                         f"tensor on {x.device}")
    y = torch.empty_like(x)
    plan = launch_plan(r, f, x.element_size(), _aligned(x, y))
    partial = torch.empty(plan.chunks * 2 * f, dtype=torch.float32,
                          device=x.device)
    mean_inv = torch.empty((2, f), dtype=torch.float32, device=x.device)
    n = r * (1 if group is None
             else torch.distributed.get_world_size(group))
    finish = (eps, 1 - momentum, momentum, n / max(n - 1, 1), int(update))
    state = (running_mean.data_ptr(), running_var.data_ptr(),
             num_batches_tracked.data_ptr())
    stats = None if group is None else torch.empty_like(mean_inv)
    status = kernels.launch(
        "batchnorm", "batch_norm_train_stats", x, x.data_ptr(),
        partial.data_ptr(), _ptr(stats),
        mean_inv.data_ptr() if group is None else None, *state, r, f, *plan,
        *finish, DTYPE_CODES[x.dtype])
    kernels.check(status, name)
    if group is not None:
        stats = comm.all_reduce_mean(stats, group)
        status = kernels.launch(
            "batchnorm", "batch_norm_train_finish", x, stats.data_ptr(),
            mean_inv.data_ptr(), *state, f, *finish)
        kernels.check(status, name)
    status = kernels.launch(
        "batchnorm", "batch_norm_train_normalize", x, x.data_ptr(),
        mean_inv.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        y.data_ptr(), r, f, *plan, int(lp and x.dtype != torch.float32),
        DTYPE_CODES[x.dtype])
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return y, mean_inv


def batch_norm_train_backward(
        x: torch.Tensor, dy: torch.Tensor, mean_inv: torch.Tensor,
        weight: torch.Tensor, *, feature_dims: int = 1, group=None,
        want_dx: bool = True
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Train-mode BN backward from the forward's x and mean_inv and the
    cotangent dy: (dx or None without ``want_dx``, dw, db)."""
    name = "batch_norm_train_backward"
    kernels.refuse_grad(name, x, dy, weight)
    if x.device.type == "cpu":
        return batch_norm_train_backward_reference(
            x, dy, mean_inv, weight, feature_dims=feature_dims, group=group,
            want_dx=want_dx)
    dy = dy.contiguous()
    r, f = _rows(x, feature_dims)
    _check_cuda(name, x, f, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy must be a {x.dtype} {tuple(x.shape)} "
                         f"tensor on {x.device}")
    if (mean_inv.shape != (2, f) or mean_inv.dtype != torch.float32
            or not mean_inv.is_contiguous()):
        raise ValueError(f"{name}: mean_inv must be a contiguous fp32 "
                         f"(2, {f}) tensor")
    dx = torch.empty_like(x) if want_dx else None
    plan = launch_plan(r, f, x.element_size(),
                       _aligned(x, dy, *([dx] if want_dx else [])))
    partial = torch.empty(plan.chunks * 2 * f, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(f, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    means = torch.empty((2, f), dtype=torch.float32, device=x.device)
    code = DTYPE_CODES[x.dtype]
    status = kernels.launch(
        "batchnorm", "batch_norm_train_grad_sums", x, x.data_ptr(),
        dy.data_ptr(), mean_inv.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), db.data_ptr(), means.data_ptr(), r, f, *plan, code)
    kernels.check(status, name)
    if want_dx:
        if group is not None:
            means = comm.all_reduce_mean(means, group)
        status = kernels.launch(
            "batchnorm", "batch_norm_train_grad_input", x, x.data_ptr(),
            dy.data_ptr(), mean_inv.data_ptr(), weight.data_ptr(),
            means.data_ptr(), dx.data_ptr(), r, f, *plan, code)
        kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return dx, dw, db


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class BatchNormTrainFunction(torch.autograd.Function):
    """Train-mode BN: forward ``batch_norm_train_forward``, backward
    ``batch_norm_train_backward`` (dx only where x needs it).  ``state``
    is the (running_mean, running_var, num_batches_tracked) it updates in
    place, outside autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, state, feature_dims, momentum, eps,
                lp, group, update):
        if x.is_cuda:
            x = x.contiguous()
        y, mean_inv = batch_norm_train_forward(
            x, weight, bias, *state, feature_dims=feature_dims,
            momentum=momentum, eps=eps, lp=lp, group=group, update=update)
        ctx.save_for_backward(x, mean_inv, weight)
        ctx.feature_dims = feature_dims
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean_inv, weight = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx, dw, db = batch_norm_train_backward(
            x, dy, mean_inv, weight, feature_dims=ctx.feature_dims,
            group=ctx.group, want_dx=want_x)
        return (dx, dw if want_w else None, db if want_b else None,
                None, None, None, None, None, None, None)


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
    return BatchNormTrainFunction.apply(
        x, weight, bias, (running_mean, running_var, num_batches_tracked),
        feature_dims, momentum, eps, lp, group, update)


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
