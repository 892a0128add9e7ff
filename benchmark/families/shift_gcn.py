"""Shift-GCN (Cheng et al., CVPR 2020): its weights, work counts and
plain reference.

Weights.  The names and shapes are those of the source repository's
``state_dict`` (Shift-GCN's ``Model``), which the port loads as they are
and the reference reads.  Scaled to the source's initialization: 1x1
convs kaiming-normal over fan-out, the spatial weight N(0, 1/D), the
classifier N(0, 2/classes), shift positions U(-1, 1), conv biases
U(+-1/sqrt(fan_in)).  The feature masks are drawn N(0, 0.5) rather than
left at zero, so that the gate does work; biases that feed a BN start at
zero and BN is the identity.  The shift indices are the source's tables.

Work.  MFU counts multiply-adds (2 FLOPs each) of the 1x1 convolutions
(the temporal block's linear), the spatial block's feature product, the
down and residual 1x1 convolutions, and the classifier.  The roofline's
ops are the work of a step, whatever kernels do it: K1 (temporal shift
forward), K23 (its backward: input gradient and position gradient), K4
(spatial forward), K5 (its input gradient), K6 (its weight gradients).

Reference.  Written from the paper's layer equations and the source
repository's ``model/shift_gcn.py``, in its layout (N*M, C, T, V):

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
position gradient (1e-4 where it is exactly zero); xpos gets zero, so
weight decay alone moves it.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import FP32, Precision, Weights, batch_norm
from benchmark.weights import Leaf, bn_leaves

MODEL = "shift_gcn_torch.models.shift_gcn"


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def units(config: dict):
    """(index, cin, cout, stride, residual kind) of each unit."""
    for i, (cin, cout, stride, residual) in enumerate(config["backbone"]):
        kind = ("none" if not residual else
                "conv" if (cin != cout or stride != 1) else "identity")
        yield i + 1, int(cin), int(cout), int(stride), kind


def leaves(config: dict) -> List[Leaf]:
    args = config["model_args"]
    v, m = args["num_point"], args["num_person"]
    c_in, ncls = config["in_channels"], args["num_class"]
    out: List[Leaf] = bn_leaves("data_bn", m * v * c_in)
    feat = c_in
    for i, cin, cout, stride, kind in units(config):
        p = f"l{i}"
        out += [(f"{p}.gcn1.Linear_weight", (cin, cout), "normal",
                 math.sqrt(1.0 / cout)),
                (f"{p}.gcn1.Linear_bias", (1, 1, cout), "zeros", 0.0),
                (f"{p}.gcn1.Feature_Mask", (1, v, cin), "normal", 0.5),
                (f"{p}.gcn1.shift_in", (v * cin,), "shift_in", 0.0),
                (f"{p}.gcn1.shift_out", (v * cout,), "shift_out", 0.0)]
        out += bn_leaves(f"{p}.gcn1.bn", v * cout)
        if cin != cout:
            out += [(f"{p}.gcn1.down.0.weight", (cout, cin, 1, 1), "normal",
                     math.sqrt(2.0 / cout)),
                    (f"{p}.gcn1.down.0.bias", (cout,), "zeros", 0.0)]
            out += bn_leaves(f"{p}.gcn1.down.1", cout)
        out += bn_leaves(f"{p}.tcn1.bn", cout) + bn_leaves(f"{p}.tcn1.bn2",
                                                           cout)
        for s in ("shift_in", "shift_out"):
            out += [(f"{p}.tcn1.{s}.xpos", (cout,), "uniform", 1e-8),
                    (f"{p}.tcn1.{s}.ypos", (cout,), "uniform", 1.0)]
        out += [(f"{p}.tcn1.temporal_linear.weight", (cout, cout, 1, 1),
                 "normal", math.sqrt(2.0 / cout)),
                (f"{p}.tcn1.temporal_linear.bias", (cout,), "uniform",
                 1.0 / math.sqrt(cout))]
        if kind == "conv":
            out += [(f"{p}.residual.conv.weight", (cout, cin, 1, 1),
                     "normal", math.sqrt(2.0 / cout)),
                    (f"{p}.residual.conv.bias", (cout,), "zeros", 0.0)]
            out += bn_leaves(f"{p}.residual.bn", cout)
        feat = cout
    out += [("fc.weight", (ncls, feat), "normal", math.sqrt(2.0 / ncls)),
            ("fc.bias", (ncls,), "uniform", 1.0 / math.sqrt(feat))]
    return out


def flat_shift_index(v: int, c: int, direction: int) -> np.ndarray:
    """The source's flat (V*C) index of the spatial shift:
    out[i*C + j] = x[(i*C + j + direction*j*C) mod V*C]."""
    i = np.arange(v)[:, None]
    j = np.arange(c)[None, :]
    return ((i * c + j + direction * j * c) % (c * v)).reshape(-1)


def fill(kind: str, shape: tuple, config: dict) -> np.ndarray:
    """The spatial shift's index tables (kinds ``shift_in`` and
    ``shift_out``)."""
    v = config["model_args"]["num_point"]
    return flat_shift_index(v, shape[0] // v,
                            1 if kind == "shift_in" else -1)


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------


def unit_shapes(config: dict):
    """Per unit: (t_in, t_out, cin, cout, stride, residual kind)."""
    t = config["frames"]
    for _, cin, cout, stride, kind in units(config):
        yield t, t // stride, cin, cout, stride, kind
        t //= stride


def forward_macs(config: dict) -> float:
    """Multiply-adds of one clip's forward pass."""
    args = config["model_args"]
    rows = args["num_point"] * args["num_person"]
    macs = 0.0
    for t_in, t_out, cin, cout, _, kind in unit_shapes(config):
        macs += rows * t_in * cin * cout            # spatial product
        if cin != cout:
            macs += rows * t_in * cin * cout        # down conv
        macs += rows * t_in * cout * cout           # temporal 1x1
        if kind == "conv":
            macs += rows * t_out * cin * cout       # residual conv
    feat = config["backbone"][-1][1]
    return macs + feat * args["num_class"]


def ops(config: dict, clips: int, itemsize: int, training: bool) -> list:
    """(op, bytes, flops) of every Shift-GCN kernel op of one forward
    (``training`` False) or one training step of ``clips`` clips."""
    args = config["model_args"]
    v = args["num_point"]
    n = clips * args["num_person"]
    out = []
    for t_in, t_out, cin, cout, stride, _ in unit_shapes(config):
        r = n * t_in
        for c, s in ((cout, 1), (cout, stride)):
            x = n * t_in * v * c
            y = n * (t_in // s) * v * c
            out.append(("K1", (x + y) * itemsize + c * 4, 3.0 * y))
            if training:
                out.append(("K23", (2 * x + y) * itemsize + 2 * c * 4,
                            6.0 * x))
        params = (v * cin + cin * cout + cout) * 4
        act = (r * v * cin + r * v * cout) * itemsize
        mm = 2.0 * r * v * cin * cout
        out.append(("K4", act + params, mm))
        if training:
            out.append(("K5", act + params, mm))
            out.append(("K6", act + (2 * (v * cin + cin * cout) + cout) * 4,
                        mm))
    return out


# ---------------------------------------------------------------------------
# reference
# ---------------------------------------------------------------------------


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
