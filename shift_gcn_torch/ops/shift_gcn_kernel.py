"""Fused spatial Shift-GCN transform with its backward.

``fused_shift_gcn(x, gate, w, bias)`` computes, for x (R, V, C),

    out = shift_out((shift_in(x) * gate) @ w + bias)        -> (R, V, D)

When autograd records it (grad mode on and an input requires grad) it
runs ``FusedShiftGCNFunction``, whose backward gives, for the cotangent
g (R, V, D), with sx = shift_in(x) and gz = shift_in(g):

    dx    = shift_out((gz @ w.T) * gate)                       K5
    M[u]  = sum_r sx[r, u, :]^T gz[r, u, :]     (V, C, D)      K6
    dw    = sum_u gate[u, :, None] * M[u]                      K6
    dgate = sum_d M[:, :, d] * w[:, d]                         K6
    dbias = sum_{r,v} g[r, v, :]                               K6

dgate is taken from the ungated shear sx, never as h / gate.  K6 is one
kernel launch (``shift_gcn_wgrad``): it reads x and g once, applies the
shears as it loads, and never writes M out; the gate multiply that the
reference's shear-gate kernel applies per element is folded into the sum
over joints for dw.
dx is skipped when x needs no gradient.  (In the model every unit's x
needs one: the first unit's input is the output of the trainable
``data_bn``.)

Without autograd, and in the Function's forward, K4 runs as the
registered operator ``shift_gcn_torch::shift_gcn`` (``ops/library.py``),
so a tracer records it as one node.  The three raw launchers
(``shift_gcn_forward`` K4, ``shift_gcn_dx`` K5, ``shift_gcn_wgrad`` K6)
run their plain PyTorch versions
(``ops.spatial_shift``) on a CPU tensor and the hand-written kernels
(``csrc/shift_gcn.cu``) on a CUDA tensor, or raise; called in grad mode
on an input that requires grad, each raises.  Math is fp32; activations
follow x.dtype (fp32 or bf16); K6's outputs are fp32.  Any joint count
V: K4 and K5 tile whole frames up to V = 144 and 144 joints of a frame
past it, K6 groups the joints; none needs more shared memory as V grows.
The one limit is 32-bit indexing, R * V * max(C, D) < 2**31.

Every entry point takes ``d0``, the global index of the first output
channel, default 0: under tensor parallelism (``parallel/tensor.py``) w
and bias are a rank's column slice of a wider layer, the output shears
index the global channel, and dx and dgate are that slice's parts,
which the ranks' backward passes add up (``ops.spatial_shift``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.ops.spatial_shift import (
    shift_gcn_dx_reference, shift_gcn_transform, shift_gcn_wgrad_reference)

# K6 splits the sum over R into chunks, one block each per tile, so that
# its blocks fill waves of this many: the H100's SM count (one K6 block an
# SM), fixed here so that the split, and so the order of the sums, depends
# on the shapes alone.
WGRAD_BLOCKS = 132
WGRAD_GROUP = 33   # joints a block of K6 at most (csrc: kWgGroup)
WGRAD_TILE = 32    # channels of a c or d tile of K6 (csrc: kWgTile)
# Past one joint group: the least share of the last wave's SMs a split
# keeps busy, and a block's fixed cost (ring fill, epilogue) in frames
WGRAD_WAVE_FILL = 0.9
WGRAD_BLOCK_FRAMES = 32
WGRAD_SMEM_MAX = 232448   # dynamic shared memory a block (csrc: kSmemMax)


def _check_cuda(name: str, x: torch.Tensor, **params) -> None:
    """x: a contiguous (R, V, C) activation on CUDA; each of ``params`` a
    contiguous fp32 tensor of the given (name: (tensor, shape))."""
    kernels.check_activation(name, x, "(R, V, C)")
    for pname, (t, shape) in params.items():
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {pname} must be a contiguous fp32 "
                             f"{shape} tensor on {x.device}")


def _check_offset(name: str, d0: int) -> None:
    if d0 < 0:
        raise ValueError(f"{name}: output-channel offset d0={d0} < 0")


def shift_gcn_forward(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor, d0: int = 0) -> torch.Tensor:
    """K4: x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D);
    output channels [d0, d0 + D) of the layer."""
    kernels.refuse_grad("shift_gcn", x, gate, w, bias)
    _check_offset("shift_gcn", d0)
    if x.device.type == "cpu":
        return shift_gcn_transform(x, gate, w, bias, d0)
    r, v, c = x.shape
    d = w.shape[-1]
    _check_cuda("shift_gcn", x, gate=(gate, (v, c)), w=(w, (c, d)),
                bias=(bias, (d,)))
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("shift_gcn: tensor too large for 32-bit indexing")
    out = torch.empty((r, v, d), dtype=x.dtype, device=x.device)
    status = kernels.launch(
        "shift_gcn", "shift_gcn_forward", x, x.data_ptr(), gate.data_ptr(),
        w.data_ptr(), bias.data_ptr(), out.data_ptr(), r, v, c, d, d0,
        int(x.dtype == torch.bfloat16))
    kernels.check(status, "shift_gcn")
    kernels.LAUNCHES["shift_gcn"] += 1
    return out


def shift_gcn_dx(g: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                 d0: int = 0) -> torch.Tensor:
    """K5: cotangent g (R, V, D) of output channels [d0, d0 + D), gate
    (V, C), w (C, D) -> dx (R, V, C)."""
    kernels.refuse_grad("shift_gcn_dx", g, gate, w)
    _check_offset("shift_gcn_dx", d0)
    if g.device.type == "cpu":
        return shift_gcn_dx_reference(g, gate, w, d0)
    r, v, d = g.shape
    c = w.shape[0]
    _check_cuda("shift_gcn_dx", g, gate=(gate, (v, c)), w=(w, (c, d)))
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("shift_gcn_dx: tensor too large for 32-bit "
                         "indexing")
    dx = torch.empty((r, v, c), dtype=g.dtype, device=g.device)
    status = kernels.launch(
        "shift_gcn", "shift_gcn_dx", g, g.data_ptr(), gate.data_ptr(),
        w.data_ptr(), dx.data_ptr(), r, v, c, d, d0,
        int(g.dtype == torch.bfloat16))
    kernels.check(status, "shift_gcn_dx")
    kernels.LAUNCHES["shift_gcn_dx"] += 1
    return dx


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _wgrad_tiles(v: int, c: int, d: int) -> int:
    return (_ceil_div(v, WGRAD_GROUP) * _ceil_div(c, WGRAD_TILE)
            * _ceil_div(d, WGRAD_TILE))


def wgrad_wave_split(r: int, v: int, c: int, d: int) -> Tuple[int, int]:
    """(parts, chunk) of about one wave of blocks, or one chunk where the
    tiles alone fill more: K6's split at one joint group, and at every V
    before the joint groups had a split of their own."""
    r = max(r, 1)
    parts = max(1, WGRAD_BLOCKS // _wgrad_tiles(v, c, d))
    chunk = _ceil_div(_ceil_div(r, parts), 16) * 16
    return _ceil_div(r, chunk), chunk


@functools.lru_cache(maxsize=None)
def wgrad_split(r: int, v: int, c: int, d: int) -> Tuple[int, int]:
    """(parts, chunk): K6 sums frames [p * chunk, (p + 1) * chunk) in
    partial p, one stage (8 fp32 or 16 bf16 frames) at a time from the
    chunk's start, then the partials in order.  ``chunk`` is a multiple
    of 16 frames.

    One joint group (V <= 33): ``wgrad_wave_split``.  Past it, the chunk
    whose waves take the least time, waves x (chunk +
    WGRAD_BLOCK_FRAMES), among those whose last wave fills at least
    WGRAD_WAVE_FILL of the SMs (fewer parts on a tie)."""
    if v <= WGRAD_GROUP:
        return wgrad_wave_split(r, v, c, d)
    r = max(r, 1)
    tiles = _wgrad_tiles(v, c, d)
    best = None
    for split in range(1, _ceil_div(r, 16) + 1):
        chunk = _ceil_div(_ceil_div(r, split), 16) * 16
        parts = _ceil_div(r, chunk)
        blocks = parts * tiles
        waves = _ceil_div(blocks, WGRAD_BLOCKS)
        key = (blocks < WGRAD_WAVE_FILL * waves * WGRAD_BLOCKS,
               waves * (chunk + WGRAD_BLOCK_FRAMES), parts)
        if best is None or key < best[0]:
            best = (key, parts, chunk)
    return best[1], best[2]


def wgrad_layout(v: int, itemsize: int) -> dict:
    """K6's block at v joints for activations of ``itemsize`` bytes
    (csrc/shift_gcn.cu: wg_geom, wg_layout): ``groups`` of ``joints``
    joints; ``rows`` rows of ``width`` channels a staged frame, frames
    ``fs`` elements apart; ``frames`` a stage; ``smem`` bytes of dynamic
    shared memory (two stages of an x and a g slab, or the epilogue's
    reduction, then the stages' mbarriers).  One group: the window, V
    rows of 32 channels.  Joint groups: 32 // width strips, each ``ss``
    elements (128-byte aligned) of ``frames`` frames of an odd number
    >= joints + width - 1 of rows, a row one 32-byte sector."""
    groups = _ceil_div(v, WGRAD_GROUP)
    joints = _ceil_div(v, groups)
    frames = 8 if itemsize == 4 else 16
    if groups == 1:
        rows, width = v, WGRAD_TILE
        fs, ss = rows * WGRAD_TILE + 8, 0
        slab = frames * fs
    else:
        width = 32 // itemsize
        rows = (joints + width - 1) | 1
        fs = rows * width
        line = 128 // itemsize
        ss = _ceil_div(frames * fs, line) * line
        slab = WGRAD_TILE // width * ss
    warps = _ceil_div(joints, 3)
    # and, past one group, the two stages' mbarriers
    smem = max(2 * 2 * slab * itemsize, warps * 32 * 34 * 4) + (
        16 if groups > 1 else 0)
    return {"groups": groups, "joints": joints, "rows": rows,
            "width": width, "fs": fs, "ss": ss, "frames": frames,
            "smem": smem}


def wgrad_staged_bytes(r: int, v: int, c: int, d: int, itemsize: int,
                       strips: Optional[bool] = None) -> int:
    """Bytes K6's blocks copy into shared memory (from L2) for one launch
    on (R, V, C) and (R, V, D) inputs of ``itemsize`` bytes: every block
    stages its frames of the x c tile once per d tile and of the g d tile
    once per c tile.  ``strips`` False reckons the window of joints + 31
    rows that K6 staged past one joint group before the strips;
    the default is the layout the kernel uses."""
    lay = wgrad_layout(v, itemsize)
    groups, joints = lay["groups"], lay["joints"]
    if strips is None:
        strips = groups > 1
    width = 32 // itemsize if strips else WGRAD_TILE
    rows = ((joints + width - 1) | 1 if strips
            else min(v, joints + WGRAD_TILE - 1))

    def per_frame(n: int) -> int:  # a block's rows x channels, all tiles
        return rows * sum(min(width, n - k0) for k0 in range(0, n, width))

    return r * groups * itemsize * (_ceil_div(d, WGRAD_TILE) * per_frame(c)
                                    + _ceil_div(c, WGRAD_TILE) * per_frame(d))


def shift_gcn_wgrad(x: torch.Tensor, g: torch.Tensor, gate: torch.Tensor,
                    w: torch.Tensor, d0: int = 0):
    """K6: from the forward's input x (R, V, C), the cotangent g (R, V, D)
    of output channels [d0, d0 + D), gate (V, C) and w (C, D), (dgate
    (V, C), dw (C, D), dbias (D,)), fp32, in one launch."""
    kernels.refuse_grad("shift_gcn_wgrad", x, g, gate, w)
    _check_offset("shift_gcn_wgrad", d0)
    if x.device.type == "cpu":
        return shift_gcn_wgrad_reference(x, g, gate, w, d0)
    r, v, c = x.shape
    d = w.shape[-1]
    _check_cuda("shift_gcn_wgrad", x, gate=(gate, (v, c)), w=(w, (c, d)))
    if (g.shape != (r, v, d) or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"shift_gcn_wgrad: g must be a contiguous "
                         f"{x.dtype} {(r, v, d)} tensor")
    if r * v * max(c, d) >= 2 ** 31:
        raise ValueError("shift_gcn_wgrad: tensor too large for 32-bit "
                         "indexing")
    parts, chunk = wgrad_split(r, v, c, d)
    lib = kernels.library("shift_gcn")
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, d0, parts, chunk)
    if scratch < 0:
        raise ValueError(f"shift_gcn_wgrad: unsupported shape {(r, v, c, d)}")
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    dgate = torch.empty((v, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, d), dtype=torch.float32, device=x.device)
    dbias = torch.empty((d,), dtype=torch.float32, device=x.device)
    status = kernels.launch(
        "shift_gcn", "shift_gcn_wgrad", x, x.data_ptr(), g.data_ptr(),
        gate.data_ptr(), w.data_ptr(), partial.data_ptr(), scratch,
        dgate.data_ptr(), dw.data_ptr(), dbias.data_ptr(), r, v, c, d, d0,
        parts, chunk, int(x.dtype == torch.bfloat16))
    kernels.check(status, "shift_gcn_wgrad")
    kernels.LAUNCHES["shift_gcn_wgrad"] += 1
    return dgate, dw, dbias


class FusedShiftGCNFunction(torch.autograd.Function):
    """Forward K4; backward K5 (dx) and K6 (dgate, dw, dbias)."""

    @staticmethod
    def forward(ctx, x, gate, w, bias, d0=0):
        ctx.save_for_backward(x, gate, w)
        ctx.d0 = d0
        return torch.ops.shift_gcn_torch.shift_gcn(x, gate, w, bias, d0)

    @staticmethod
    def backward(ctx, g):
        x, gate, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dgate = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = shift_gcn_dx(g, gate, w, ctx.d0)
        if any(ctx.needs_input_grad[1:4]):
            dgate, dw, dbias = shift_gcn_wgrad(x, g, gate, w, ctx.d0)
        return dx, dgate, dw, dbias, None


def fused_shift_gcn(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor, d0: int = 0) -> torch.Tensor:
    """x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D) in
    x.dtype, output channels [d0, d0 + D) of the layer; see the module
    docstring."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gate, w, bias)):
        return FusedShiftGCNFunction.apply(x, gate, w, bias, d0)
    return torch.ops.shift_gcn_torch.shift_gcn(x, gate, w, bias, d0)
