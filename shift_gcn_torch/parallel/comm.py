"""Collectives for the parallel modes, and their autograd rules.

Every collective here runs on any backend: NCCL with CUDA tensors, gloo
with CPU tensors, and gloo with CUDA tensors (several ranks sharing one
card), which goes through host memory because gloo does not move CUDA
tensors in every collective.  bf16 tensors are gathered as bytes (a
gather copies, so any type of the same width carries them).

``all_reduce_mean`` is differentiable: the forward averages over the
group, and the backward averages the ranks' cotangents too, the adjoint
of a mean of per-rank inputs when every rank back-propagates its own
part of one objective shared by all ranks (``seqpar.py`` says which).
Sync BN's statistics and, under sequence parallelism, the final
temporal pooling take it.

``gather_channels`` is differentiable too: the forward concatenates the
group's channel slices along the last axis (tensor parallelism, each
model rank computing its slice of a layer's output channels), and the
backward sums the ranks' cotangents of the whole and keeps this rank's
slice.  Every rank's cotangent of a gathered tensor is its own part of
the shared objective's, so that sum is the whole objective's cotangent
of the slice, the exact adjoint of a gather; a backward that kept the
own slice of the own cotangent alone would drop the other ranks'
parts.  The partial input gradients the slice's op then passes down
(K5's dx, the 1x1's) need no reduction: they stay each rank's part,
and the parameter gradients computed from them are summed over the
ranks with the rest (``Mesh.reduce_gradients``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns ``t``."""
    if _through_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and type on all), in group rank
    order, on ``t``'s device."""
    t = t.contiguous()
    src = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
    if _through_host(t, group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    if t.dtype == torch.bfloat16:
        out = [o.view(torch.bfloat16) for o in out]
    return [o.to(t.device) for o in out]


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        return all_reduce_sum_(g.contiguous().clone(), ctx.group) / size, None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The group mean of ``x``; its backward averages the cotangents."""
    return _AllReduceMean.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        return torch.cat(all_gather(x, group), -1)

    @staticmethod
    def backward(ctx, g):
        # the sum in fp32 (gloo sums no bf16 on every build), then one
        # rounding to the cotangent's type
        total = all_reduce_sum_(g.float().contiguous(), ctx.group)
        start = dist.get_rank(ctx.group) * ctx.width
        return total[..., start:start + ctx.width].to(g.dtype), None


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """(..., C / M) slices of the group's M ranks -> (..., C), in group
    rank order; its backward is the adjoint (see the module docstring)."""
    return _GatherChannels.apply(x.contiguous(), group)
