"""Shift-GCN in plain PyTorch, float32, on a dict of named weights.

Written from the layer equations of Shift-GCN (Cheng et al., CVPR 2020)
and the source repository's ``model/shift_gcn.py``, in its layout
(N*M, C, T, V):

- data BN over M*V*C features of (N, M*V*C, T);
- spatial block: shift_in of the flat (V*C) axis by the source's index
  tables, times the gate tanh(Feature_Mask) + 1, a (C, D) product plus
  bias, shift_out, BN over V*D features; plus the down branch (1x1 conv
  and BN) where C != D; ReLU;
- temporal block: BN, the learned fractional shift (stride 1), 1x1 conv,
  ReLU, the shift at the unit's stride, BN;
- unit: ReLU(temporal(spatial(x)) + residual), the residual none, the
  input, or a strided 1x1 conv and BN;
- mean over (T', V) and persons, then the classifier.

The temporal shift reads, per channel with y = ypos (+0.5 at stride 2),
lo = floor(y), f = y - lo: out[t] = (1 - f) x[t*s + lo] + f x[t*s + lo
+ 1], zero outside the clip.  Its backward is the source's: the exact
transpose for x and, for ypos, the fixed step 0.01 * sign of the
position gradient (1e-4 where it is exactly zero); xpos gets zero.

BN in training normalizes by the batch statistics (mean, then the
biased variance about it); in eval by the running statistics.  ``precision`` rounds as a control
run computes: ``tf32`` rounds both operands of every matmul and conv to
TF32 (fp32 accumulation), ``fp8`` rounds every activation to e4m3 and
every activation gradient to e5m2, each by its own amax scale.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

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


class TemporalShift(torch.autograd.Function):
    """x (B, C, T, V), ypos (C,) -> (B, C, T // stride, V)."""

    @staticmethod
    def _shift(x, ypos, stride):
        b, c, t, v = x.shape
        y = ypos.detach().float() + (0.5 if stride != 1 else 0.0)
        lo = torch.floor(y)
        f = (y - lo)[None, :, None, None]
        lo = lo.long()
        pad = int(lo.abs().max().item()) + 2
        xp = F.pad(x, (0, 0, pad, pad))
        t_out = t // stride
        idx = (torch.arange(t_out, device=x.device)[None, :] * stride
               + lo[:, None] + pad)                          # (C, T_out)
        idx = idx[None, :, :, None].expand(b, c, t_out, v)
        x0 = torch.gather(xp, 2, idx)
        x1 = torch.gather(xp, 2, idx + 1)
        return x0, x1, f

    @staticmethod
    def forward(ctx, x, ypos, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, ypos)
        x0, x1, f = TemporalShift._shift(x, ypos, stride)
        return (1.0 - f) * x0 + f * x1

    @staticmethod
    def backward(ctx, g):
        x, ypos = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            x0, x1, f = TemporalShift._shift(xg, ypos, ctx.stride)
            out = (1.0 - f) * x0 + f * x1
            (gx,) = torch.autograd.grad(out, xg, g)
        gy = ((x1 - x0).detach() * g).sum((0, 2, 3))
        step = torch.where(gy != 0, torch.sign(gy) * 0.01,
                           torch.full_like(gy, 1e-4))
        return gx, step, None


def _shift_index(v: int, c: int, direction: int, device) -> torch.Tensor:
    """The source's flat (V*C) shift index: out[i*C + j] = x[idx]."""
    i = torch.arange(v, device=device)[:, None]
    j = torch.arange(c, device=device)[None, :]
    return ((i * c + j + direction * j * c) % (c * v)).reshape(-1)


def spatial(x, w, p, training, prec):
    b, cin, t, v = x.shape
    weight = w[p + ".Linear_weight"]
    cout = weight.shape[1]
    h = x.permute(0, 2, 3, 1).reshape(b * t, v * cin)
    h = h[:, _shift_index(v, cin, 1, x.device)].reshape(b * t, v, cin)
    h = h * (torch.tanh(w[p + ".Feature_Mask"]) + 1.0)
    h = prec.matmul(h, weight) + w[p + ".Linear_bias"].reshape(cout)
    h = h.reshape(b * t, v * cout)[:, _shift_index(v, cout, -1, x.device)]
    h = prec.act(batch_norm(h, w, p + ".bn", training))
    h = h.reshape(b, t, v, cout).permute(0, 3, 1, 2)
    if cin != cout:
        res = prec.conv1x1(x, w[p + ".down.0.weight"], w[p + ".down.0.bias"])
        res = prec.act(batch_norm(res, w, p + ".down.1", training))
    else:
        res = x
    return prec.act(torch.relu(h + res))


def temporal(x, w, p, stride, training, prec):
    h = prec.act(batch_norm(x, w, p + ".bn", training))
    h = prec.act(TemporalShift.apply(h, w[p + ".shift_in.ypos"], 1))
    h = prec.conv1x1(h, w[p + ".temporal_linear.weight"],
                     w[p + ".temporal_linear.bias"])
    h = torch.relu(h)
    h = prec.act(TemporalShift.apply(h, w[p + ".shift_out.ypos"], stride))
    return prec.act(batch_norm(h, w, p + ".bn2", training))


def forward(w: Weights, x: torch.Tensor, config: dict, training: bool,
            prec: Precision = FP32) -> torch.Tensor:
    """x (N, C, T, V, M) fp32 -> logits (N, classes) fp32."""
    n, c, t, v, m = x.shape
    h = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t)
    h = batch_norm(h, w, "data_bn", training)
    h = h.reshape(n, m, v, c, t).permute(0, 1, 3, 4, 2).reshape(
        n * m, c, t, v)
    h = prec.act(h)
    for i, (cin, cout, stride, residual) in enumerate(config["backbone"]):
        p = f"l{i + 1}"
        out = temporal(spatial(h, w, p + ".gcn1", training, prec), w,
                       p + ".tcn1", int(stride), training, prec)
        if not residual:
            res = None
        elif cin == cout and stride == 1:
            res = h
        else:
            res = prec.conv1x1(h, w[p + ".residual.conv.weight"],
                               w[p + ".residual.conv.bias"], int(stride))
            res = prec.act(batch_norm(res, w, p + ".residual.bn", training))
        h = prec.act(torch.relu(out if res is None else out + res))
    feat = h.shape[1]
    pooled = h.reshape(n, m, feat, -1).mean(3).mean(1)
    return (prec.matmul(pooled, w["fc.weight"].t()) + w["fc.bias"]).float()


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

