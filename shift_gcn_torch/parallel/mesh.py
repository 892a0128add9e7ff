"""The ('data', 'model') mesh over the ranks of the default process
group.

The counterpart of the reference package's ``parallel/mesh.py``
(``make_mesh``: ``np.reshape(devices, (data, model))``): rank r sits at
(d, m) = divmod(r, M).  Every rank creates one process group per data
coordinate (its M model ranks, ``model_group``) and one per model
coordinate (its D data ranks, ``data_group``), in the same order, as
``new_group`` requires.  ``mesh_shape: null`` puts every rank on
'data'; D * M must equal the world size.  Data rank d holds batch rows
[d B / D, (d + 1) B / D).  The model ranks hold, under sequence
parallelism, frames [m T / M, (m + 1) T / M) (``time_group`` names
their group then), under tensor parallelism (``tensor_parallel``:
M > 1 without ``shard_time`` or an edge partition) output channels
[m C / M, (m + 1) C / M) of the sharded parameters
(``parallel/tensor.py``), and under the edge partition
(``parallel/edge_partition.py``) slices of the edge list, with, under
its ``ring`` strategy, joints [m V / M, (m + 1) V / M) (the reference's
``P(batch, None, None, edge, None)``).

Batches: a node's feeder gives the node's batch (``hosts`` > 1, each
node a shard of the epoch, as a host of the reference package), or
every rank's feeder gives the whole batch (``hosts`` == 1, one node, or
D == 1); a rank keeps its rows of what its feeder gave.

The reductions a train step needs live here too: ``reduce_gradients``
sums every gradient but the shift positions' over the world and divides
by D, except a tensor-parallel rank's slices, which it sums over the
data ranks alone (the model ranks hold different slices); and
``reduce_position_grad`` sums the raw position gradient over the world
and divides by D (a sum over the model ranks' parts and a mean over the
data ranks), before the constraint step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from shift_gcn_torch.parallel import comm, tensor

# parameters whose step the constraint sets identically on every rank:
# summed over the world they would be scaled, and averaged, rounded
POSITION_SUFFIXES = (".xpos", ".ypos")


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int = 0
    hosts: int = 1
    world_group: Any = None
    data_group: Any = None
    model_group: Any = None
    # M > 1 without shard_time: the model ranks hold slices of the
    # sharded parameters (parallel/tensor.py)
    tensor_parallel: bool = False

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def time_group(self):
        """The model ranks' group, which holds the T shards under
        sequence parallelism."""
        return self.model_group

    @property
    def host(self) -> int:
        """This rank's node among the ``hosts`` whose feeders differ
        (ranks are numbered node by node)."""
        return self.rank * self.hosts // self.world

    @property
    def coords(self):
        """(d, m) of this rank."""
        return divmod(self.rank, self.model)

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` its feeder gave."""
        per_host = self.data // self.hosts
        if n % per_host:
            raise ValueError(f"batch of {n} does not split over "
                             f"{per_host} data ranks")
        d = self.coords[0] % per_host
        size = n // per_host
        return slice(d * size, (d + 1) * size)

    def time_frames(self, t: int) -> slice:
        if t % self.model:
            raise ValueError(f"T={t} does not split over {self.model} "
                             "time ranks")
        m, size = self.coords[1], t // self.model
        return slice(m * size, (m + 1) * size)

    def nodes(self, v: int) -> slice:
        """This rank's joints of ``v`` under the ring edge partition."""
        if v % self.model:
            raise ValueError(f"V={v} does not split over {self.model} "
                             "node ranks")
        m, size = self.coords[1], v // self.model
        return slice(m * size, (m + 1) * size)

    def local(self, data, shard_time: bool, shard_nodes: bool = False):
        """This rank's rows (and, with ``shard_time``, frames; with
        ``shard_nodes``, joints) of an (N, C, T, V, M) batch, numpy or
        torch."""
        out = data[self.batch_rows(data.shape[0])]
        if shard_time:
            out = out[:, :, self.time_frames(data.shape[2])]
        if shard_nodes:
            out = out[:, :, :, self.nodes(data.shape[3])]
        return out

    def reduce_gradients(self, named_parameters) -> None:
        """Sum the gradients of (name, parameter) pairs over the world
        (a tensor-parallel rank's slices over the data ranks) in one flat
        buffer a group and divide by D; shift positions keep their
        (identical) constraint steps."""
        replicated, sharded = [], []
        for name, p in named_parameters:
            if p.grad is None or name.endswith(POSITION_SUFFIXES):
                continue
            (sharded if self.tensor_parallel
             and tensor.sharded_axis(name) is not None
             else replicated).append(p.grad)
        for group, grads in ((self.world_group, replicated),
                             (self.data_group, sharded)):
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            comm.all_reduce_sum_(flat, group)
            flat /= self.data
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def reduce_position_grad(self, gy_raw: torch.Tensor) -> torch.Tensor:
        """gy_raw summed over the model ranks (their frames, or their
        parts of the cotangent under tensor parallelism) and averaged over
        the data ranks: the global batch mean of the global (T, V) sum."""
        return comm.all_reduce_sum_(gy_raw.clone(),
                                    self.world_group) / self.data

    def mean_over_world(self, values: torch.Tensor) -> torch.Tensor:
        """Metrics equal on every rank: the world mean."""
        return comm.all_reduce_sum_(values.clone(),
                                    self.world_group) / self.world

    def gather_rows(self, arrays: List[Any]) -> List[Any]:
        """Every data rank's ``arrays`` (a list of numpy arrays with
        batch rows first), concatenated in data-rank order."""
        got: List[Any] = [None] * self.data
        dist.all_gather_object(got, arrays, group=self.data_group)
        return [np.concatenate(parts) for parts in zip(*got)]

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (the same on all)."""
        got: List[Any] = [None] * self.world
        dist.all_gather_object(got, bool(flag), group=self.world_group)
        return any(got)

    def barrier(self) -> None:
        if self.world_group is not None:
            dist.barrier(group=self.world_group)


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              nodes: int = 1, tensor_parallel: bool = False) -> Mesh:
    """The mesh of the default process group (a one-rank mesh without
    one) over ``nodes`` nodes: when several nodes feed D > 1 data ranks,
    each node's feeder gives its shard of the epoch (``hosts`` = nodes);
    otherwise every feeder gives the whole batch (``hosts`` = 1).
    ``tensor_parallel``: the model ranks, if M > 1, shard parameters
    (the caller's choice: without it they shard T or nothing)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    data, model = (world, 1) if not mesh_shape else (
        int(mesh_shape[0]), int(mesh_shape[1]))
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(
            f"mesh_shape {list(mesh_shape or [])} needs {data * model} "
            f"processes, one per GPU, and this run has {world}: launch "
            f"with torchrun --nproc-per-node {data * model}")
    hosts = nodes if nodes > 1 and data > 1 else 1
    if data % hosts:
        raise ValueError(f"the data axis ({data}) must split over the "
                         f"{hosts} nodes that feed it")
    tensor_parallel = bool(tensor_parallel) and model > 1
    if not initialized:
        return Mesh(data, model, tensor_parallel=tensor_parallel)
    rank = dist.get_rank()
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    d, m = divmod(rank, model)
    return Mesh(data, model, rank, hosts, dist.group.WORLD, data_groups[m],
                model_groups[d], tensor_parallel)
