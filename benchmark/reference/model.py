"""What every family's plain reference shares, in float32 on a dict of
named weights: the rounding of a control run, BN, TF32 off, and the
forward of the configuration's family (``families/<family>.py``).

BN in training normalizes by the batch statistics (mean, then the
biased variance about it); in eval by the running statistics.
``precision`` rounds as a control run computes: ``tf32`` rounds both
operands of every matmul and conv to TF32 (fp32 accumulation), ``fp8``
rounds every activation to e4m3 and every activation gradient to e5m2,
each by its own amax scale.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import families

Weights = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# rounding of a control run
# ---------------------------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().max().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.name == "fp8" else x

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name != "tf32":
            return x
        # rounded in the forward; the gradient passes through as it is
        return x + (round_tf32(x) - x).detach()

    def matmul(self, a, b):
        return self.act(torch.matmul(self.operand(a), self.operand(b)))

    def conv1x1(self, x, weight, bias, stride: int = 1):
        out = F.conv2d(self.operand(x), self.operand(weight), None,
                       stride=(stride, 1))
        return self.act(out + bias[None, :, None, None])


FP32 = Precision("fp32")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def batch_norm(x: torch.Tensor, w: Weights, prefix: str,
               training) -> torch.Tensor:
    """BN over dim 1 of x (eps 1e-5): by the batch's mean and biased
    variance (two passes) in training, by the running statistics in
    eval; with ``training`` "calibrate", by the batch's, which also
    become the running ones (unbiased variance)."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if training:
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        if training == "calibrate":
            n = x.numel() // x.shape[1]
            w[prefix + ".running_mean"].copy_(mean.reshape(-1))
            w[prefix + ".running_var"].copy_(var.reshape(-1) * n / (n - 1))
    else:
        mean = w[prefix + ".running_mean"].reshape(shape)
        var = w[prefix + ".running_var"].reshape(shape)
    return ((x - mean) * torch.rsqrt(var + 1e-5)
            * w[prefix + ".weight"].reshape(shape)
            + w[prefix + ".bias"].reshape(shape))


def forward(w: Weights, x: torch.Tensor, config: dict, training,
            prec: Precision = FP32) -> torch.Tensor:
    """x (N, C, T, V, M) fp32 -> logits (N, classes) fp32: the reference
    of the configuration's family."""
    return families.of(config).forward(w, x, config, training, prec)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for CUDA matmuls and cuDNN convs, as a float32 reference
    needs on this card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def run_eval(w: Weights, x: np.ndarray, config: dict, device,
             prec: Precision = FP32, block: int = 64) -> np.ndarray:
    """Eval-mode logits of (N, C, T, V, M) clips, in blocks of rows."""
    out = []
    with torch.no_grad(), no_tf32():
        for i in range(0, len(x), block):
            out.append(forward(w, to_tensor(x[i:i + block], device), config,
                               False, prec).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)

