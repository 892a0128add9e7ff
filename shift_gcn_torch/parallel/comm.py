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

``all_reduce_sum`` is differentiable as well: the forward sums the
ranks' partial sums (edge partition, each model rank aggregating its
slice of the edges; the ring-GNN's pooled node sum over its node
shards), and the backward sums the ranks' cotangents, its adjoint: every
rank's output is the whole sum, so each partial's cotangent is the sum
of the ranks' parts of the shared objective's.  An identity backward
would hand each partial 1/M of it.

``rotate`` starts one step of a ring: this rank sends a tensor to the
group rank ``shift`` places on and receives the tensor of the rank
``shift`` places back, with ``dist.batch_isend_irecv``, so that the
caller computes while the exchange runs and waits on the returned
handle (``parallel/edge_partition.ring_aggregate`` holds its adjoint).
"""

from __future__ import annotations

from typing import List, NamedTuple

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


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group sum of ``x``; its backward sums the cotangents."""
    return _AllReduceSum.apply(x.contiguous(), group)


class Rotation(NamedTuple):
    works: list
    sent: torch.Tensor  # held until the send completes
    received: torch.Tensor
    device: torch.device

    def wait(self) -> torch.Tensor:
        """The tensor received, on the sent tensor's device."""
        for work in self.works:
            work.wait()
        return self.received.to(self.device)


def rotate(t: torch.Tensor, group, shift: int) -> Rotation:
    """Start sending ``t`` to group rank (r + shift) mod P and receiving
    from (r - shift) mod P, P the group's size and r this rank's; every
    rank of the group calls it with the same ``shift``."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    src = t.contiguous()
    if _through_host(t, group):
        src = src.cpu()
    received = torch.empty_like(src)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, dist.get_global_rank(
            group, (rank + shift) % size), group),
        dist.P2POp(dist.irecv, received, dist.get_global_rank(
            group, (rank - shift) % size), group)])
    return Rotation(works, src, received, t.device)
