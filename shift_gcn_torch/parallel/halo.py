"""The temporal shift over a T-sharded activation: halo exchange, K1 and
the fused K2+K3 on the extended block, the reverse exchange, and the
global constraint.

The counterpart of the reference package's ``parallel/halo.py``
(``halo_exchange``, ``sharded_temporal_shift_train``).  Rank m of a time
group holds frames [m T_l, (m + 1) T_l) of every clip.  An output row of
the shift reads the two frames at t s + lo and t s + lo + 1, with
|ypos| < max_shift - 0.5 (the range check), so a local output row
reaches at most ``max_shift`` frames below its block and ``max_shift``
above.  The forward:

1. ``halo_exchange`` extends the local block with the last ``lo`` frames
   of rank m - 1 and the first ``hi`` frames of rank m + 1 (zeros at the
   chain ends, which are the unsharded shift's zero padding), with
   ``lo`` = max_shift rounded up to a multiple of the stride, so the
   first local frame stays on the stride's grid, and ``hi`` =
   max_shift + 1;
2. K1 (the port's kernel, or its plain version on the CPU) shifts the
   extended block;
3. the local output rows [lo / s, lo / s + T_l / s) are kept: they are
   the unsharded shift's rows, bit for bit.

The backward runs the fused K2+K3 on the extended block, with the
cotangent zero outside the local rows: grad_input's halo rows belong to
the neighbours' frames and travel back to them (``halo_return``, the
reverse exchange), where they are added.  gy_raw is the local part of
the global sum; ``Mesh.reduce_position_grad`` sums it over the time
ranks and averages it over the data ranks before ``constraint_step``,
so every rank takes the same step, the unsharded one.  The block must
hold at least ``max_shift + 1`` frames (``seqpar.validate_time_sharding``).
"""

from __future__ import annotations

from typing import Optional

import torch

from shift_gcn_torch.ops import temporal_shift as ts
from shift_gcn_torch.parallel import comm


def halo_sizes(max_shift: int, stride: int):
    """(frames below, frames above) the local block."""
    return -(-max_shift // stride) * stride, max_shift + 1


def halo_exchange(x: torch.Tensor, lo: int, hi: int, mesh) -> torch.Tensor:
    """(N, T_l, V, C) -> (N, lo + T_l + hi, V, C): the previous rank's
    last ``lo`` frames, the block, the next rank's first ``hi`` frames;
    zeros past the chain ends."""
    t_l = x.shape[1]
    if t_l < max(lo, hi):
        raise ValueError(f"T_local={t_l} is below the halo ({lo}, {hi}): "
                         "use fewer time shards or a lower max_shift")
    parts = comm.all_gather(torch.cat([x[:, t_l - lo:], x[:, :hi]], 1),
                            mesh.time_group)
    m = mesh.coords[1]
    below = (parts[m - 1][:, :lo] if m > 0
             else x.new_zeros((x.shape[0], lo) + x.shape[2:]))
    above = (parts[m + 1][:, lo:] if m + 1 < mesh.model
             else x.new_zeros((x.shape[0], hi) + x.shape[2:]))
    return torch.cat([below, x, above], 1)


def halo_return(dx_ext: torch.Tensor, lo: int, hi: int,
                mesh) -> torch.Tensor:
    """The reverse exchange: grad_input of the extended block -> the
    local block's, with the neighbours' halo rows added where their
    frames came from."""
    t_l = dx_ext.shape[1] - lo - hi
    parts = comm.all_gather(
        torch.cat([dx_ext[:, :lo], dx_ext[:, lo + t_l:]], 1),
        mesh.time_group)
    m = mesh.coords[1]
    dx = dx_ext[:, lo:lo + t_l].clone()
    if m + 1 < mesh.model:  # rank m + 1's low halo is our tail
        dx[:, t_l - lo:] += parts[m + 1][:, :lo]
    if m > 0:               # rank m - 1's high halo is our head
        dx[:, :hi] += parts[m - 1][:, lo:]
    return dx


class ShardedTemporalShiftFunction(torch.autograd.Function):
    """Forward: halo exchange, K1, the local rows.  Backward: the fused
    K2+K3 on the extended block, the reverse exchange, the global
    constraint step, and a zero xpos gradient."""

    @staticmethod
    def forward(ctx, x, xpos, ypos, stride, mesh, max_shift):
        lo, hi = halo_sizes(max_shift, stride)
        ext = halo_exchange(x, lo, hi, mesh)
        out = torch.ops.shift_gcn_torch.temporal_shift(ext, ypos, stride)
        ctx.save_for_backward(ext, ypos)
        ctx.meta = (stride, mesh, lo, hi, x.shape[1] // stride,
                    None if xpos is None
                    else (xpos.shape, xpos.dtype, xpos.device))
        return out[:, lo // stride:lo // stride + x.shape[1] // stride
                   ].contiguous()

    @staticmethod
    def backward(ctx, g):
        ext, ypos = ctx.saved_tensors
        stride, mesh, lo, hi, t_out, xpos_meta = ctx.meta
        g_ext = g.new_zeros((g.shape[0], ext.shape[1] // stride)
                            + g.shape[2:])
        g_ext[:, lo // stride:lo // stride + t_out] = g
        want_x, want_xpos, want_ypos = ctx.needs_input_grad[:3]
        dx_ext = gy_raw = grad_x = grad_xpos = grad_ypos = None
        if want_x and want_ypos:
            dx_ext, gy_raw = ts.temporal_shift_backward(ext, g_ext, ypos,
                                                        stride)
        elif want_x:
            dx_ext = ts.temporal_shift_grad_input(g_ext, ypos, stride,
                                                  ext.shape[1])
        elif want_ypos:
            gy_raw = ts.temporal_shift_position_grad(ext, g_ext, ypos,
                                                     stride)
        if dx_ext is not None:
            grad_x = halo_return(dx_ext, lo, hi, mesh)
        if gy_raw is not None:
            grad_ypos = ts.constraint_step(mesh.reduce_position_grad(gy_raw))
        if want_xpos:
            shape, dtype, device = xpos_meta
            grad_xpos = torch.zeros(shape, dtype=dtype, device=device)
        return grad_x, grad_xpos, grad_ypos, None, None, None


def sharded_temporal_shift(x: torch.Tensor, ypos: torch.Tensor,
                           stride: int, mesh, max_shift: int,
                           xpos: Optional[torch.Tensor] = None,
                           exact_xpos: bool = False) -> torch.Tensor:
    """``temporal_shift`` over the T shards of ``mesh``'s time group:
    (N, T_l, V, C) -> (N, T_l // stride, V, C).  The joint pass of
    ``exact_xpos`` is per frame, so it runs on the local block first."""
    if exact_xpos:
        if xpos is None:
            raise ValueError("exact_xpos needs xpos")
        x = ts.joint_pass(x, xpos.detach())
    if x.shape[1] % stride:
        raise ValueError(f"T_local={x.shape[1]} is not divisible by the "
                         f"stride {stride}")
    return ShardedTemporalShiftFunction.apply(x.contiguous(), xpos, ypos,
                                              stride, mesh, max_shift)
