"""2s-AGCN's 9-tap temporal convolution as one op.

A unit's TCN (Shi et al., CVPR 2019, ``model/agcn.py`` ``unit_tcn``) is
a (9 x 1) convolution at temporal stride s, zero-padded by 4 frames.  On
the model's channels-last activations, R = N'V rows of T frames of C_in
channels, with W (C_out, C_in, 9, 1) and b (C_out,):

    y[r, t, co] = b[co] + sum_{k<9} sum_ci x[r, s*t + k - 4, ci] W[co, ci, k]

for t < T_out = ceil(T / s).

``temporal_conv9`` is the autograd entry point
(``TemporalConv9Function``).  Its raw launchers, ``tconv_forward``,
``tconv_input_grad`` and ``tconv_weight_grad``, run the plain PyTorch
versions (``*_reference``) on a CPU tensor and the hand-written kernels
of ``csrc/agcn_tconv.cu`` on a CUDA tensor, each counting one launch in
``kernels.LAUNCHES`` (``agcn_tconv``, ``agcn_tconv_input_grad``,
``agcn_tconv_weight_grad``); a CUDA tensor the kernels do not take is
refused (``tconv_plan``), never handed to another library.  The kernels
take fp32, C_in and C_out multiples of 4, and stride 1, or 2 with T
even.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from shift_gcn_torch import kernels

TAPS = 9
PAD = (TAPS - 1) // 2
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)
# csrc/agcn_tconv.cu: 8 warps of 64 positions x 64 channels
WARPS = 8
CHUNK = 16           # source channels a chunk
# weight gradient: groups of 8 rows, co x ci tiles of 64 x 32, and about
# two waves of two blocks an SM of an H100's 132, fixed here so that the
# splits, and so the order of the sums, depend on the shapes alone
WG_ROWS, WG_CO, WG_CI = 8, 64, 32
WG_TARGET_BLOCKS = 528


def out_frames(t: int, stride: int) -> int:
    return -(-t // stride)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' oracles on the card)
# ---------------------------------------------------------------------------


def _windows(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(R, T_out, C_in, 9): x zero-padded by 4 frames, the nine frames of
    each output frame's taps."""
    return F.pad(x, (0, 0, PAD, PAD)).unfold(1, TAPS, stride)


def tconv_forward_reference(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, stride: int) -> torch.Tensor:
    """y (R, T_out, C_out) from x (R, T, C_in), W (C_out, C_in, 9, 1) and
    b (C_out,)."""
    y = torch.einsum("rtck,ock->rto", _windows(x, stride), w[..., 0])
    return y + b


def tconv_input_grad_reference(dy: torch.Tensor, w: torch.Tensor,
                               t: int, stride: int) -> torch.Tensor:
    """dx (R, T, C_in): each tap's product dy W_k added back at the frames
    it read."""
    r, t_out, _ = dy.shape
    taps = torch.einsum("rto,ock->rtck", dy, w[..., 0])
    dx = dy.new_zeros(r, t + 2 * PAD, w.shape[1])
    for k in range(TAPS):
        dx[:, k:k + stride * (t_out - 1) + 1:stride] += taps[..., k]
    return dx[:, PAD:PAD + t]


def tconv_weight_grad_reference(x: torch.Tensor, dy: torch.Tensor,
                                stride: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW (C_out, C_in, 9, 1), db (C_out,)) from x and dy."""
    dw = torch.einsum("rto,rtck->ock", dy, _windows(x, stride))
    return dw.unsqueeze(-1), dy.sum((0, 1))


# ---------------------------------------------------------------------------
# Plans and raw launchers: plain version on a CPU tensor, kernels on CUDA
# ---------------------------------------------------------------------------


class TconvPlan(NamedTuple):
    """A forward or input-gradient launch: the source's q-space layout
    (``period`` frames a row, ``pad`` zeros before its first, ``sstride``
    frames a position), ``tu`` positions a row, ``taps`` tap steps and
    ``npar`` output parities a chunk of ``chunks``, ``bn`` output
    channels and ``bu`` positions a block, the window's ``slab_rows``
    and row stride ``ld`` (pairs), the packed weights' ``nt8`` n8 tiles,
    and the block's shared memory in bytes."""
    period: int
    pad: int
    sstride: int
    tu: int
    taps: int
    npar: int
    chunks: int
    bn: int
    bu: int
    slab_rows: int
    ld: int
    nt8: int
    smem: int


def _slab_rows(bu: int, tu: int, sstride: int, gap: int, reach: int) -> int:
    """The most q rows a block of ``bu`` consecutive positions reads: its
    positions' span, the taps' reach, and ``gap`` padding rows at each
    row boundary it crosses."""
    return sstride * (bu - 1) + reach + 1 + gap * ((tu + bu - 2) // tu)


def tconv_plan(rows: int, t: int, cin: int, cout: int, stride: int,
               backward: bool) -> TconvPlan:
    """The plan of the forward (``backward`` False) or input-gradient
    kernel at these shapes; raises ValueError for shapes they do not
    take."""
    name = "agcn_tconv"
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride {stride}; the kernels take 1 or 2")
    if stride == 2 and t % 2:
        raise ValueError(f"{name}: T={t} frames at stride 2; the kernels "
                         "take an even T")
    if cin % 4 or cout % 4:
        raise ValueError(f"{name}: {cin} -> {cout} channels; the kernels "
                         "take multiples of 4")
    if not (rows >= 1 and t >= 1 and cin >= 4 and cout >= 4):
        raise ValueError(f"{name}: no grid for R={rows}, T={t}")
    t_out = out_frames(t, stride)
    kdim, ndim = (cout, cin) if backward else (cin, cout)
    if not backward:
        period, pad, sstride, tu, taps, npar = t + 2 * PAD, PAD, stride, \
            t_out, TAPS, 1
    elif stride == 1:
        period, pad, sstride, tu, taps, npar = t + 2 * PAD, PAD, 1, t, \
            TAPS, 1
    else:
        period, pad, sstride, tu, taps, npar = t_out + 4, 2, 1, t_out, 5, 2
    reach = 4 if npar == 2 else TAPS - 1
    gap = period - sstride * tu
    bn = 64 if ndim <= 64 else 128
    ld = CHUNK + (2 if sstride == 2 else 4)
    # the most positions a block whose window fits in shared memory (64
    # fit at any T: the window is then at most 639 rows)
    bu = 64 * (WARPS // (bn // 64)) // npar
    while True:
        slab = _slab_rows(bu, tu, sstride, gap, reach)
        smem = slab * ld * 8 + slab * CHUNK * 4 + 3 * npar * bn * 8 * 16
        if smem <= SMEM_LIMIT:
            break
        bu //= 2
    return TconvPlan(period, pad, sstride, tu, taps, npar,
                     -(-kdim // CHUNK), bn, bu, slab, ld,
                     -(-ndim // bn) * bn // 8, smem)


def weight_grad_splits(rows: int, cin: int, cout: int) -> Tuple[int, int]:
    """(splits, row groups a split) of the weight-gradient kernel."""
    groups = -(-rows // WG_ROWS)
    tiles = -(-cout // WG_CO) * -(-cin // WG_CI)
    per = -(-groups // max(1, WG_TARGET_BLOCKS // tiles))
    return -(-groups // per), per


def _check_cuda(name: str, x: torch.Tensor, shape, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous "
                         f"{tuple(shape)} tensor")


def _check_weight(name: str, w: torch.Tensor) -> Tuple[int, int]:
    if w.dim() != 4 or tuple(w.shape[2:]) != (TAPS, 1):
        raise ValueError(f"{name}: weight {tuple(w.shape)}; the kernels "
                         f"take (C_out, C_in, {TAPS}, 1)")
    return w.shape[0], w.shape[1]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh copy where it does not start on 16 bytes: the
    kernels move four floats a load."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(name: str, plan: TconvPlan, src: torch.Tensor,
            w: torch.Tensor, bias, out: torch.Tensor) -> None:
    """Pack W and run the forward (bias given) or input-gradient kernel
    of ``plan``: src (R, T_src, kdim) -> out (R, T_out, ndim)."""
    rows, ts, kdim = src.shape
    cout, cin = w.shape[:2]
    pack = torch.empty(plan.taps * plan.npar * plan.chunks * plan.nt8 * 64
                       * 4, dtype=torch.int32, device=src.device)
    status = kernels.launch(
        "agcn_tconv", "agcn_tconv_run", src, int(bias is None),
        src.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        pack.data_ptr(), out.data_ptr(), rows, ts, plan.tu, out.shape[1],
        kdim, out.shape[2], cin, cout, plan.period, plan.pad, plan.sstride,
        plan.taps, plan.npar, plan.chunks, plan.nt8, plan.bu,
        plan.slab_rows, plan.ld, plan.bn)
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1


def tconv_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """y (R, T_out, C_out) of x (R, T, C_in)."""
    name = "agcn_tconv"
    kernels.refuse_grad(name, x, w, b)
    if x.device.type == "cpu":
        return tconv_forward_reference(x, w, b, stride)
    cout, cin = _check_weight(name, w)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be a contiguous (R, T, C_in) "
                         "tensor")
    rows, t, _ = x.shape
    plan = tconv_plan(rows, t, cin, cout, stride, False)
    _check_cuda(name, x, (rows, t, cin), "x")
    _check_cuda(name, w, (cout, cin, TAPS, 1), "W")
    _check_cuda(name, b, (cout,), "b")
    y = torch.empty(rows, out_frames(t, stride), cout, dtype=torch.float32,
                    device=x.device)
    _launch(name, plan, _aligned(x), w, b, y)
    return y


def tconv_input_grad(dy: torch.Tensor, w: torch.Tensor, t: int,
                     stride: int) -> torch.Tensor:
    """dx (R, T, C_in) from dy (R, T_out, C_out)."""
    name = "agcn_tconv_input_grad"
    kernels.refuse_grad(name, dy, w)
    if dy.device.type == "cpu":
        return tconv_input_grad_reference(dy, w, t, stride)
    cout, cin = _check_weight(name, w)
    if dy.dim() != 3:
        raise ValueError(f"{name}: dy must be a contiguous (R, T_out, "
                         "C_out) tensor")
    rows = dy.shape[0]
    plan = tconv_plan(rows, t, cin, cout, stride, True)
    _check_cuda(name, dy, (rows, out_frames(t, stride), cout), "dy")
    _check_cuda(name, w, (cout, cin, TAPS, 1), "W")
    dx = torch.empty(rows, t, cin, dtype=torch.float32, device=dy.device)
    _launch(name, plan, _aligned(dy), w, None, dx)
    return dx


def tconv_weight_grad(x: torch.Tensor, dy: torch.Tensor, stride: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW (C_out, C_in, 9, 1), db (C_out,)) from x and dy."""
    name = "agcn_tconv_weight_grad"
    kernels.refuse_grad(name, x, dy)
    if x.device.type == "cpu":
        return tconv_weight_grad_reference(x, dy, stride)
    if x.dim() != 3 or dy.dim() != 3:
        raise ValueError(f"{name}: x and dy must be contiguous (R, T, C) "
                         "tensors")
    rows, t, cin = x.shape
    cout = dy.shape[2]
    tconv_plan(rows, t, cin, cout, stride, False)
    _check_cuda(name, x, (rows, t, cin), "x")
    _check_cuda(name, dy, (rows, out_frames(t, stride), cout), "dy")
    x, dy = _aligned(x), _aligned(dy)
    splits, per = weight_grad_splits(rows, cin, cout)
    partial = torch.empty(splits * (cout * cin * TAPS + cout),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty(cout, cin, TAPS, 1, dtype=torch.float32,
                     device=x.device)
    db = torch.empty(cout, dtype=torch.float32, device=x.device)
    status = kernels.launch(
        "agcn_tconv", "agcn_tconv_weight", x, x.data_ptr(), dy.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), rows, t,
        dy.shape[1], cin, cout, stride, splits, per)
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return dw, db


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class TemporalConv9Function(torch.autograd.Function):
    """y from (x, W, b): forward ``tconv_forward``; backward
    ``tconv_input_grad`` for dx and ``tconv_weight_grad`` for dW and
    db."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        y = tconv_forward(x, w, b, stride)
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous()
        dx = (tconv_input_grad(dy, w, x.shape[1], ctx.stride)
              if want_x else None)
        dw = db = None
        if want_w or want_b:
            dw, db = tconv_weight_grad(x, dy, ctx.stride)
        return dx, dw if want_w else None, db if want_b else None, None


def temporal_conv9(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """y (R, T_out, C_out) of x (R, T, C_in), W (C_out, C_in, 9, 1) and
    b (C_out,) at temporal stride ``stride``, padding 4."""
    return TemporalConv9Function.apply(x, w, b, stride)
