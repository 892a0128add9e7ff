"""Learnable fractional temporal shift with its constraint backward.

Per channel c, with temporal stride s and y = ypos[c] (+0.5 when s != 1,
the reference Shift module's rule):

    out[n, t, v, c] = (1 - f) * x[n, t*s + lo, v, c] + f * x[n, t*s + lo + 1, v, c]

with lo = floor(y), f = y - lo, and reads outside [0, T) taken as zero.
T_out = T // s.  Layout is channels-last (N, T, V, C).

The backward is the reference's constraint backward, not the derivative:

- grad_input is the exact transpose of the forward (K2): input frame k
  gathers (1 - f) * a + f * b with a = g[(k - lo) / s] and
  b = g[(k - lo - 1) / s], each only where the offset is a non-negative
  multiple of s below T_out * s (the stride-2 evenness rule);
- the position gradient is a fixed step: with
  gy_raw[c] = sum_{t,v} mean_n (x[t*s + lo + 1] - x[t*s + lo]) * g[t]
  (K3, fp32), ypos moves by 0.01 * sign(gy_raw), or 1e-4 where gy_raw is
  exactly 0 (``constraint_step``);
- xpos gets a zero gradient.

Under data parallelism (``mesh``, ``parallel/mesh.py``) gy_raw is first
averaged over the data ranks (``Mesh.reduce_position_grad``), so the
constraint steps on the sign of the global batch's gradient, the same
step on every rank; ``parallel/halo.py`` runs the shift on T shards.

On the card K1 is one tiled pass that stages the input frames a tile
reads in shared memory and writes each output once, in the same fp32
rounding steps as its plain version (``temporal_shift_reference``), so
the two are bit-equal; K2 and K3 are one kernel: re-indexed over input
frames, gy_raw[c] = (1/N) sum_{n,k,v} x[k] * (b - a), so one pass over x
and g gives both (``temporal_shift_backward``).  The kernels take stride
1 or 2.

The joint-axis position ``xpos`` is treated as exactly zero in the
forward by default: its init is U(-1e-8, 1e-8), its gradient is zero and
weight decay only shrinks it, so its bilinear contribution stays below
fp32 rounding for the life of any run.  With ``exact_xpos`` (the
lowering knob) the forward first runs ``joint_pass``, the reference's
3-tap hat interpolation along the joint axis at x + xpos (zero outside
[0, V)), in plain PyTorch, then the kernels on its output.  The hat
interpolation is separable in (t, v), so K1 on the joint-passed input is
the reference's 2-D tap conv, and K3's gy_raw on it is the reference's
position gradient of the 2-D taps; autograd carries grad_input back
through the joint pass.  The pass reads xpos detached, so xpos keeps its
zero gradient.  (The reference's Pallas path refuses ``exact_xpos`` and
falls back to its conv lowering; the port keeps its kernels.)

The reference package sums taps only inside the static radius
[-max_shift, max_shift + 1], while the kernels here read the two frames
directly at any offset.  ``assert_in_range`` keeps every ``ypos`` inside
the model's radius (its lowering's ``max_shift``), so the two agree by
construction.

``temporal_shift`` is the entry point.  When autograd records it (grad
mode on and an input requires grad) it runs ``TemporalShiftFunction``;
otherwise the forward alone, as the registered operator
``shift_gcn_torch::temporal_shift`` (``ops/library.py``), which the
Function's forward calls too, so a tracer records K1 as one node either
way.  The raw launchers are
``temporal_shift_forward`` (K1), ``temporal_shift_backward`` (K2 and K3
fused: dx and gy_raw) and its one-output forms
``temporal_shift_grad_input`` and ``temporal_shift_position_grad``, which
launch the same kernel with the other output switched off.  Each runs its
plain PyTorch version on a CPU tensor and its hand-written kernel
(``csrc/temporal_shift.cu``) on a CUDA tensor, or raises; called in grad
mode on an input that requires grad, each raises (``kernels.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from shift_gcn_torch import kernels

DEFAULT_MAX_SHIFT = 8


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' oracles on the card)
# ---------------------------------------------------------------------------


def _lo_frac(ypos: torch.Tensor, stride: int, device):
    y = ypos.float().to(device)
    y = y if stride == 1 else y + 0.5
    lo_f = torch.floor(y)
    return lo_f.to(torch.int64), y - lo_f


def _gather_frames(src: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """src (N, T_src, V, C), idx/valid (T, C) -> fp32 (N, T, V, C) with
    src[n, idx[t, c], v, c] where valid, else 0."""
    n, t_src, v, c = src.shape
    gather = idx.clamp(0, t_src - 1)[None, :, None, :].expand(
        n, idx.shape[0], v, c)
    return torch.gather(src, 1, gather).float() * valid[None, :, None, :]


def _source_frames(x: torch.Tensor, ypos: torch.Tensor, stride: int):
    """(frac, x[t*s + lo], x[t*s + lo + 1]) in fp32, zero outside [0, T)."""
    t_in = x.shape[1]
    lo, frac = _lo_frac(ypos, stride, x.device)
    t = torch.arange(t_in // stride, device=x.device)[:, None] * stride + lo

    def frames(idx):
        return _gather_frames(x, idx, (idx >= 0) & (idx < t_in))

    return frac, frames(t), frames(t + 1)


def temporal_shift_reference(x: torch.Tensor, ypos: torch.Tensor,
                             stride: int = 1) -> torch.Tensor:
    """K1's plain version and its oracle on the card: fp32 math, the two
    products and their sum each rounded once, output in x.dtype (bf16 is
    one rounding of the fp32 result)."""
    frac, x0, x1 = _source_frames(x, ypos, stride)
    return ((1.0 - frac) * x0 + frac * x1).to(x.dtype)


def temporal_shift_grad_input_reference(g: torch.Tensor, ypos: torch.Tensor,
                                        stride: int,
                                        t_in: int) -> torch.Tensor:
    """K2's plain version: the transposed shift of the cotangent
    g (N, T_out, V, C) back to (N, t_in, V, C); fp32 math, output in
    g.dtype."""
    t_out = g.shape[1]
    lo, frac = _lo_frac(ypos, stride, g.device)
    t = torch.arange(t_in, device=g.device)[:, None]

    def taps(k):
        valid = (k >= 0) & (k % stride == 0) & (k < t_out * stride)
        return _gather_frames(g, torch.div(k, stride, rounding_mode="floor"),
                              valid)

    return ((1.0 - frac) * taps(t - lo) + frac * taps(t - lo - 1)).to(
        g.dtype)


def temporal_shift_position_grad_reference(x: torch.Tensor, g: torch.Tensor,
                                           ypos: torch.Tensor,
                                           stride: int) -> torch.Tensor:
    """K3's plain version: gy_raw (C,) fp32, the mean over N and sum over
    (T, V) of (x[t*s + lo + 1] - x[t*s + lo]) * g[t], all in fp32."""
    _, x0, x1 = _source_frames(x, ypos, stride)
    return ((x1 - x0) * g.float()).mean(0).sum((0, 1))


def temporal_shift_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                      ypos: torch.Tensor, stride: int):
    """The fused backward's plain version: (grad_input in x.dtype, gy_raw
    (C,) fp32) as K2's and K3's plain versions give them."""
    return (temporal_shift_grad_input_reference(g, ypos, stride, x.shape[1]),
            temporal_shift_position_grad_reference(x, g, ypos, stride))


def constraint_step(gy_raw: torch.Tensor) -> torch.Tensor:
    """The reference constraint kernel's position update: 0.01 in the
    direction of gy_raw's sign, or 1e-4 where gy_raw is exactly 0.
    Written in the reference package's order so the steps are
    bit-equal."""
    mag = gy_raw.abs()
    nonzero = mag != 0
    return torch.where(
        nonzero, gy_raw / torch.where(nonzero, mag, torch.ones_like(mag))
        * 0.01, torch.full_like(gy_raw, 1e-4))


# ---------------------------------------------------------------------------
# Raw launchers: plain version on a CPU tensor, kernel on a CUDA tensor
# ---------------------------------------------------------------------------


# The kernels stage at least a zero frame, V rows of a slab of 128 bytes
# (32 fp32 or 64 bf16 channels) and a 32-byte pad, beside 1 KiB of static
# shared memory, in one block's 227 KiB (an H100's opt-in limit): V up to
# (232448 - 1024 - 32) // 128.  Below it they stage as many frames as fit
# and read the other taps from device memory.
MAX_JOINTS = (232448 - 1024 - 32) // 128


def _check_cuda(name: str, x: torch.Tensor, ypos: torch.Tensor) -> None:
    kernels.check_activation(name, x, "(N, T, V, C)")
    if x.shape[2] > MAX_JOINTS:
        raise ValueError(f"{name}: V={x.shape[2]} > {MAX_JOINTS}: a zero "
                         "frame of V 128-byte rows does not fit in a "
                         "block's shared memory")
    c = x.shape[-1]
    if (ypos.shape != (c,) or ypos.dtype != torch.float32
            or ypos.device != x.device or not ypos.is_contiguous()):
        raise ValueError(f"{name}: ypos must be a contiguous fp32 ({c},) "
                         f"tensor on {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for 32-bit indexing")


def temporal_shift_forward(x: torch.Tensor, ypos: torch.Tensor,
                           stride: int = 1) -> torch.Tensor:
    """K1: (N, T, V, C) -> (N, T // stride, V, C)."""
    kernels.refuse_grad("temporal_shift", x, ypos)
    if x.device.type == "cpu":
        return temporal_shift_reference(x, ypos, stride)
    _check_cuda("temporal_shift", x, ypos)
    n, t_in, v, c = x.shape
    t_out = t_in // stride
    out = torch.empty((n, t_out, v, c), dtype=x.dtype, device=x.device)
    status = kernels.launch(
        "temporal_shift", "temporal_shift_forward", x, x.data_ptr(),
        ypos.data_ptr(), out.data_ptr(), n, t_in, t_out, v, c, stride,
        int(x.dtype == torch.bfloat16))
    kernels.check(status, "temporal_shift")
    kernels.LAUNCHES["temporal_shift"] += 1
    return out


def _launch_backward(x: Optional[torch.Tensor], g: torch.Tensor,
                     ypos: torch.Tensor, stride: int, t_in: int,
                     want_dx: bool, want_gy: bool):
    """The fused backward kernel on CUDA tensors: (dx or None, gy_raw or
    None).  x is read only for gy_raw."""
    name = "temporal_shift_backward"
    _check_cuda(name, g, ypos)
    n, t_out, v, c = g.shape
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride {stride} is not 1 or 2")
    if t_out != t_in // stride:
        raise ValueError(f"{name}: T_out={t_out} is not t_in // stride = "
                         f"{t_in // stride}")
    if n * t_in * v * c >= 2 ** 31:
        raise ValueError(f"{name}: tensor too large for 32-bit indexing")
    if want_gy and (x.shape != (n, t_in, v, c) or x.dtype != g.dtype
                    or x.device != g.device or not x.is_contiguous()):
        raise ValueError(f"{name}: x must be a contiguous {g.dtype} "
                         f"{(n, t_in, v, c)} tensor")
    lib = kernels.library("temporal_shift")
    dx = (torch.empty((n, t_in, v, c), dtype=g.dtype, device=g.device)
          if want_dx else None)
    partial = gy = None
    if want_gy:
        rows = max(1, lib.temporal_shift_backward_rows(n, t_in))
        partial = torch.empty((rows, c), dtype=torch.float32,
                              device=g.device)
        gy = torch.empty((c,), dtype=torch.float32, device=g.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = kernels.launch(
        "temporal_shift", "temporal_shift_backward", g,
        ptr(x) if want_gy else None, g.data_ptr(), ypos.data_ptr(), ptr(dx),
        ptr(partial), ptr(gy), n, t_in, t_out, v, c, stride,
        int(g.dtype == torch.bfloat16))
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return dx, gy


def temporal_shift_backward(x: torch.Tensor, g: torch.Tensor,
                            ypos: torch.Tensor, stride: int):
    """K2 and K3 fused: from the forward input x (N, T, V, C) and the
    cotangent g (N, T // stride, V, C), (grad_input (N, T, V, C) in
    x.dtype, gy_raw (C,) fp32) in one pass over x and g."""
    kernels.refuse_grad("temporal_shift_backward", x, g, ypos)
    if x.device.type == "cpu":
        return temporal_shift_backward_reference(x, g, ypos, stride)
    return _launch_backward(x, g, ypos, stride, x.shape[1], True, True)


def temporal_shift_grad_input(g: torch.Tensor, ypos: torch.Tensor,
                              stride: int, t_in: int) -> torch.Tensor:
    """K2 alone: cotangent (N, T_out, V, C) -> grad_input (N, t_in, V, C);
    the fused kernel with gy_raw switched off."""
    kernels.refuse_grad("temporal_shift_grad_input", g, ypos)
    if g.device.type == "cpu":
        return temporal_shift_grad_input_reference(g, ypos, stride, t_in)
    return _launch_backward(None, g, ypos, stride, t_in, True, False)[0]


def temporal_shift_position_grad(x: torch.Tensor, g: torch.Tensor,
                                 ypos: torch.Tensor,
                                 stride: int) -> torch.Tensor:
    """K3 alone: gy_raw (C,) fp32 from the forward input x (N, T, V, C)
    and the cotangent g (N, T // stride, V, C); the fused kernel with dx
    switched off."""
    kernels.refuse_grad("temporal_shift_position_grad", x, g, ypos)
    if x.device.type == "cpu":
        return temporal_shift_position_grad_reference(x, g, ypos, stride)
    return _launch_backward(x, g, ypos, stride, x.shape[1], False, True)[1]


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class TemporalShiftFunction(torch.autograd.Function):
    """Forward K1; backward K2 (grad_input) and K3 + ``constraint_step``
    (ypos, on gy_raw reduced over ``mesh``'s ranks when one is given),
    in one fused launch when both are needed, and a zero xpos
    gradient."""

    @staticmethod
    def forward(ctx, x, xpos, ypos, stride, mesh=None):
        ctx.stride = stride
        ctx.mesh = mesh
        ctx.save_for_backward(x, ypos)
        ctx.xpos_meta = (None if xpos is None
                         else (xpos.shape, xpos.dtype, xpos.device))
        return torch.ops.shift_gcn_torch.temporal_shift(x, ypos, stride)

    @staticmethod
    def backward(ctx, g):
        x, ypos = ctx.saved_tensors
        g = g.contiguous()
        want_x, want_xpos, want_ypos = ctx.needs_input_grad[:3]
        grad_x = grad_xpos = grad_ypos = gy_raw = None
        if want_x and want_ypos:
            grad_x, gy_raw = temporal_shift_backward(x, g, ypos, ctx.stride)
        elif want_x:
            grad_x = temporal_shift_grad_input(g, ypos, ctx.stride,
                                               x.shape[1])
        elif want_ypos:
            gy_raw = temporal_shift_position_grad(x, g, ypos, ctx.stride)
        if gy_raw is not None:
            if ctx.mesh is not None:
                gy_raw = ctx.mesh.reduce_position_grad(gy_raw)
            grad_ypos = constraint_step(gy_raw)
        if want_xpos:
            shape, dtype, device = ctx.xpos_meta
            grad_xpos = torch.zeros(shape, dtype=dtype, device=device)
        return grad_x, grad_xpos, grad_ypos, None, None


def joint_pass(x: torch.Tensor, xpos: torch.Tensor) -> torch.Tensor:
    """The 3-tap joint-axis interpolation of (N, T, V, C) x at v + xpos[c]
    (reference ``_joint_pass`` with ``_hat_taps(xpos, -1, 1)``): taps
    max(0, 1 - |xpos - d|) at offsets d = -1, 0, 1, zero outside [0, V);
    fp32 math, output in x.dtype."""
    offsets = torch.arange(-1, 2, dtype=torch.float32, device=x.device)
    taps = torch.clamp(
        1.0 - (xpos.float().to(x.device)[None, :] - offsets[:, None]).abs(),
        min=0.0)
    v = x.shape[2]
    padded = torch.nn.functional.pad(x.float(), (0, 0, 1, 1))
    out = (padded[:, :, 0:v] * taps[0] + padded[:, :, 1:v + 1] * taps[1]
           + padded[:, :, 2:v + 2] * taps[2])
    return out.to(x.dtype)


def temporal_shift(x: torch.Tensor, ypos: torch.Tensor, stride: int = 1,
                   xpos: Optional[torch.Tensor] = None,
                   exact_xpos: bool = False, mesh=None) -> torch.Tensor:
    """(N, T, V, C) -> (N, T // stride, V, C); see the module docstring.
    Without ``exact_xpos``, ``xpos`` is read by no arithmetic; with it,
    ``joint_pass`` reads it detached.  Passed, it receives the zero
    gradient.  ``mesh``: the data-parallel ranks whose gy_raw the
    constraint reduces."""
    if exact_xpos:
        if xpos is None:
            raise ValueError("exact_xpos needs xpos")
        x = joint_pass(x, xpos.detach())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, xpos, ypos)):
        return TemporalShiftFunction.apply(x, xpos, ypos, stride, mesh)
    return torch.ops.shift_gcn_torch.temporal_shift(x, ypos, stride)


def assert_in_range(ypos, name: str = "ypos",
                    max_shift: int = DEFAULT_MAX_SHIFT) -> None:
    """Raise if a shift position reaches max_shift - 0.5 in magnitude."""
    arr = ypos.detach().cpu().numpy() if torch.is_tensor(ypos) else ypos
    m = float(np.max(np.abs(np.asarray(arr)))) if np.size(arr) else 0.0
    if m >= max_shift - 0.5:
        raise ValueError(
            f"{name} magnitude {m:.2f} reaches the tap radius "
            f"max_shift={max_shift} of the reference lowering; "
            "raise max_shift in the model config")
