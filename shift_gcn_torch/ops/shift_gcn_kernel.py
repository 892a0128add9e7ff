"""Fused spatial Shift-GCN transform with its backward.

``fused_shift_gcn(x, gate, w, bias)`` computes, for x (R, V, C),

    out = shift_out((shift_in(x) * gate) @ w + bias)        -> (R, V, D)

When autograd records it (grad mode on and an input requires grad) it
runs ``FusedShiftGCNFunction``, whose backward gives, for the cotangent
g (R, V, D), with sx = shift_in(x) and gz = shift_in(g):

    dx    = shift_out((gz @ w.T) * gate)                       K5
    M[u]  = sum_r sx[r, u, :]^T gz[r, u, :]     (V, C, D)      K6 x2 + bmm
    dw    = sum_u gate[u, :, None] * M[u]
    dgate = sum_d M[:, :, d] * w[:, d]
    dbias = sum_{r,u} gz[r, u, :]

dgate is taken from the ungated shear sx, never as h / gate.  Both dw
and dgate come from the one per-joint product M: the gate multiply that
the reference's shear-gate kernel applies per element is folded into the
(V, C, D) reduction for dw, so K6 is the bare shear and only one matmul
over R runs.
dx is skipped when x needs no gradient.  (In the model every unit's x
needs one: the first unit's input is the output of the trainable
``data_bn``.)

The three raw launchers (``shift_gcn_forward`` K4, ``shift_gcn_dx`` K5,
``shear_in`` K6) run their plain PyTorch versions
(``ops.spatial_shift``) on a CPU tensor and the hand-written kernels
(``csrc/shift_gcn.cu``) on a CUDA tensor, or raise; called in grad mode
on an input that requires grad, each raises.  Math is fp32; activations
follow x.dtype (fp32 or bf16).
"""

from __future__ import annotations

import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.ops.spatial_shift import (
    shear_in_reference, shift_gcn_dx_reference, shift_gcn_transform)


def _check_cuda(name: str, x: torch.Tensor, **params) -> None:
    """x: a contiguous (R, V, C) activation on CUDA; each of ``params`` a
    contiguous fp32 tensor of the given (name: (tensor, shape))."""
    kernels.check_activation(name, x, "(R, V, C)")
    for pname, (t, shape) in params.items():
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {pname} must be a contiguous fp32 "
                             f"{shape} tensor on {x.device}")
    if x.shape[1] > 144:
        raise ValueError(f"{name}: V={x.shape[1]} exceeds the kernel's "
                         "144-row frame tile")


def shift_gcn_forward(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """K4: x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D)."""
    kernels.refuse_grad("shift_gcn", x, gate, w, bias)
    if x.device.type == "cpu":
        return shift_gcn_transform(x, gate, w, bias)
    r, v, c = x.shape
    d = w.shape[-1]
    _check_cuda("shift_gcn", x, gate=(gate, (v, c)), w=(w, (c, d)),
                bias=(bias, (d,)))
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("shift_gcn: tensor too large for 32-bit indexing")
    out = torch.empty((r, v, d), dtype=x.dtype, device=x.device)
    status = kernels.library("shift_gcn").shift_gcn_forward(
        x.data_ptr(), gate.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), r, v, c, d, int(x.dtype == torch.bfloat16),
        kernels.stream(x))
    kernels.check(status, "shift_gcn")
    kernels.LAUNCHES["shift_gcn"] += 1
    return out


def shift_gcn_dx(g: torch.Tensor, gate: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """K5: cotangent g (R, V, D), gate (V, C), w (C, D) -> dx (R, V, C)."""
    kernels.refuse_grad("shift_gcn_dx", g, gate, w)
    if g.device.type == "cpu":
        return shift_gcn_dx_reference(g, gate, w)
    r, v, d = g.shape
    c = w.shape[0]
    _check_cuda("shift_gcn_dx", g, gate=(gate, (v, c)), w=(w, (c, d)))
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("shift_gcn_dx: tensor too large for 32-bit "
                         "indexing")
    dx = torch.empty((r, v, c), dtype=g.dtype, device=g.device)
    status = kernels.library("shift_gcn").shift_gcn_dx(
        g.data_ptr(), gate.data_ptr(), w.data_ptr(), dx.data_ptr(), r, v, c,
        d, int(g.dtype == torch.bfloat16), kernels.stream(g))
    kernels.check(status, "shift_gcn_dx")
    kernels.LAUNCHES["shift_gcn_dx"] += 1
    return dx


def shear_in(x: torch.Tensor) -> torch.Tensor:
    """K6: shift_in(x) in fp32 for x (R, V, C)."""
    kernels.refuse_grad("shear_in", x)
    if x.device.type == "cpu":
        return shear_in_reference(x)
    r, v, c = x.shape
    _check_cuda("shear_in", x)
    out = torch.empty((r, v, c), dtype=torch.float32, device=x.device)
    status = kernels.library("shift_gcn").shear_in(
        x.data_ptr(), out.data_ptr(), r, v, c,
        int(x.dtype == torch.bfloat16), kernels.stream(x))
    kernels.check(status, "shear_in")
    kernels.LAUNCHES["shear_in"] += 1
    return out


class FusedShiftGCNFunction(torch.autograd.Function):
    """Forward K4; backward K5 (dx) and K6 on x and g feeding one
    per-joint fp32 ``bmm`` for dw and dgate."""

    @staticmethod
    def forward(ctx, x, gate, w, bias):
        ctx.save_for_backward(x, gate, w)
        return shift_gcn_forward(x, gate, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, gate, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dgate = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = shift_gcn_dx(g, gate, w)
        if any(ctx.needs_input_grad[1:]):
            gz = shear_in(g)
            sx = shear_in(x)
            # M[u] = sx[:, u, :]^T @ gz[:, u, :], one product per joint
            m = torch.bmm(sx.permute(1, 2, 0), gz.permute(1, 0, 2))
            dw = (m * gate[:, :, None]).sum(0)
            dgate = (m * w[None]).sum(-1)
            dbias = gz.sum((0, 1))
        return dx, dgate, dw, dbias


def fused_shift_gcn(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D) in
    x.dtype; see the module docstring."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gate, w, bias)):
        return FusedShiftGCNFunction.apply(x, gate, w, bias)
    return shift_gcn_forward(x, gate, w, bias)
