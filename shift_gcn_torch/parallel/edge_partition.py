"""Edge-partitioned graph aggregation over the model ranks.

The counterpart of the reference package's ``parallel/edge_partition.py``
(its north-star mode): the fixed-topology aggregation's COO edge list
split over the mesh's 'model' ranks, the batch over its 'data' ranks.
Two exchange strategies, as there:

- ``gather`` (ST-GCN): node features replicated over the model ranks;
  each aggregates its contiguous slice of the edge list
  (``partition_edges``) into partial destination sums, and one sum
  all-reduce over the model group completes them
  (``edge_partitioned_aggregate``).
- ``ring`` (ring-GNN): node features sharded over the model ranks, rank
  m holding nodes [m V / P, (m + 1) V / P); each owns the edges whose
  destination is its own, bucketed by the source's shard
  (``partition_edges_ring``).  In P steps the node blocks travel around
  the ring, each rank forwarding its buffer to the rank on its left
  while it aggregates the bucket whose sources the buffer holds
  (``ring_aggregate``); no final sum.

The bookkeeping (``partition_edges``, ``partition_edges_ring``,
``subset_coo_from_adjacency``) is numpy and gives the reference's arrays
bit for bit.  ``attach`` wires a model to a mesh in place of the
reference's ``shard_map``'d applies: this rank's edge slice (or ring
buckets) and the model group on the model, every BN averaged over the
data ranks alone (the model ranks hold the same rows).  ``train_step``
and ``eval_step`` take the global batch, as the reference's
``make_edge_sharded_train_step`` / ``make_edge_sharded_eval_step`` do;
``make_sharded_aggregator`` is the standalone op.

Gradients follow the port's one objective (``seqpar.py``): each model
rank back-propagates 1/M of its data shard's loss and the ranks'
gradients are summed over the world and divided by D.  The all-reduce
of the partial sums therefore sums the cotangents in its backward
(``comm.all_reduce_sum``), and the ring's backward sends each cotangent
block the other way around the ring, to the right: the adjoints of the
forward's exchanges.  The parameters stay replicated: a checkpoint is
rank 0's state in the reference layout, and loads in one process.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from shift_gcn_torch.ops.aggregate import edge_aggregate
from shift_gcn_torch.parallel import comm
from shift_gcn_torch.utils.device import resolve_device

STRATEGIES = ("gather", "ring")


def partition_edges(edges: Dict[str, np.ndarray],
                    num_partitions: int) -> Dict[str, np.ndarray]:
    """Pad the COO edge list to a multiple of num_partitions and reshape to
    (P, E_local) arrays. Padded edges carry weight 0 and point at node 0."""
    e = len(edges["src"])
    e_pad = -(-e // num_partitions) * num_partitions
    out = {}
    for key in ("src", "dst"):
        arr = np.zeros(e_pad, dtype=np.int32)
        arr[:e] = edges[key]
        out[key] = arr.reshape(num_partitions, -1)
    w = np.zeros(e_pad, dtype=np.float32)
    w[:e] = edges["weight"]
    out["weight"] = w.reshape(num_partitions, -1)
    return out


def partition_edges_ring(
    edges: Dict[str, np.ndarray],
    num_partitions: int,
    num_nodes: int,
) -> Tuple[List[Dict[str, np.ndarray]], int, int]:
    """Bucket a COO edge list for the ring strategy.

    Nodes are padded to V_pad = ceil(V / P) * P and split into P
    contiguous shards of V_loc = V_pad / P.  Partition p owns every edge
    whose dst falls in its shard; its edges are bucketed by the source's
    shard, bucket r holding the edges whose sources live on shard
    (p + r) mod P: the block that arrives on ring step r.

    Buckets are padded per arrival step: returns a length-P list of
    {src_local, dst_local, weight} arrays of shape (P, E_max_r), plus
    (v_pad, v_loc).  Padded slots carry weight 0 and index 0.
    """
    p = num_partitions
    v_loc = -(-num_nodes // p)
    v_pad = v_loc * p
    src = np.asarray(edges["src"], np.int64)
    dst = np.asarray(edges["dst"], np.int64)
    w = np.asarray(edges["weight"], np.float32)
    owner = dst // v_loc
    src_shard = src // v_loc
    buckets = [[[] for _ in range(p)] for _ in range(p)]
    for e in range(len(src)):
        o = int(owner[e])
        r = int((src_shard[e] - o) % p)
        buckets[o][r].append(e)
    steps = []
    for r in range(p):
        e_max = max((len(buckets[o][r]) for o in range(p)), default=1) or 1
        step = {
            "src_local": np.zeros((p, e_max), np.int32),
            "dst_local": np.zeros((p, e_max), np.int32),
            "weight": np.zeros((p, e_max), np.float32),
        }
        for o in range(p):
            idx = np.asarray(buckets[o][r], np.int64)
            n = len(idx)
            if not n:
                continue
            step["src_local"][o, :n] = src[idx] % v_loc
            step["dst_local"][o, :n] = dst[idx] % v_loc
            step["weight"][o, :n] = w[idx]
        steps.append(step)
    return steps, v_pad, v_loc


def subset_coo_from_adjacency(adjacency: np.ndarray) -> Dict[str, np.ndarray]:
    """Flatten a (K, V, V) multi-subset adjacency stack into one COO edge
    list whose sources index the (K*V,)-flattened per-subset projections:
    edge (k, v, u) becomes src = k*V + u, dst = v, weight = A[k, v, u]
    (how ST-GCN's sum_k A_k (X W_k) becomes one partitioned segment sum)."""
    k, v, _ = adjacency.shape
    ks, vs, us = np.nonzero(adjacency)
    return {
        "src": (ks * v + us).astype(np.int32),
        "dst": vs.astype(np.int32),
        "weight": adjacency[ks, vs, us].astype(np.float32),
    }


def edge_partitioned_aggregate(x: torch.Tensor, src: torch.Tensor,
                               dst: torch.Tensor, weight: torch.Tensor,
                               num_nodes: int, group) -> torch.Tensor:
    """The aggregate of this rank's edge slice (src / dst / weight
    (E_local,)) over the whole (..., V_src, C) node block ``x``, summed
    over the model ``group``: the whole (..., num_nodes, C) aggregate on
    every rank."""
    partial = edge_aggregate(x, {"src": src, "dst": dst, "weight": weight},
                             num_nodes)
    return comm.all_reduce_sum(partial, group)


def _bucket_sum(t: torch.Tensor, bucket: Dict[str, torch.Tensor],
                transpose: bool = False) -> torch.Tensor:
    """One ring bucket's aggregate into the local destinations, or with
    ``transpose`` its adjoint: the cotangent of the local destinations
    carried back to the bucket's sources."""
    src, dst = (("dst_local", "src_local") if transpose
                else ("src_local", "dst_local"))
    return edge_aggregate(t, {"src": bucket[src], "dst": bucket[dst],
                              "weight": bucket["weight"]}, t.shape[-2])


class _RingAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, steps, group):
        ctx.steps, ctx.group = steps, group
        buf, acc = x.contiguous(), None
        for r, bucket in enumerate(steps):
            # shard (i + r + 1) mod P arrives while bucket r is summed
            pending = (comm.rotate(buf, group, -1) if r + 1 < len(steps)
                       else None)
            part = _bucket_sum(buf, bucket)
            acc = part if acc is None else acc + part
            if pending is not None:
                buf = pending.wait()
        return acc

    @staticmethod
    def backward(ctx, g):
        steps, group = ctx.steps, ctx.group
        g = g.contiguous()
        # the cotangent of step r's buffer belongs r ranks to the right:
        # each block travels back the way the features came
        ct = _bucket_sum(g, steps[-1], transpose=True)
        for r in range(len(steps) - 2, -1, -1):
            pending = comm.rotate(ct, group, 1)
            local = _bucket_sum(g, steps[r], transpose=True)
            ct = pending.wait() + local
        return ct, None, None


def ring_aggregate(x_shard: torch.Tensor,
                   steps: List[Dict[str, torch.Tensor]],
                   group) -> torch.Tensor:
    """The aggregate into this rank's (B, V_loc, C) node block
    ``x_shard`` over the ring ``group``: ``steps`` are this rank's
    per-arrival-step buckets ({src_local, dst_local, weight} (E_r,),
    from ``partition_edges_ring``).  On step r the buffer holds shard
    (i + r) mod P, and is forwarded to the left neighbour while bucket r
    is summed.  Returns the complete aggregate of the local
    destinations; its backward rotates the cotangents to the right."""
    return _RingAggregate.apply(x_shard, steps, group)


def _rank_arrays(arrays: Dict[str, np.ndarray], m: int,
                 device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v[m])).to(device)
            for k, v in arrays.items()}


def ring_steps(edges: Dict[str, np.ndarray], num_nodes: int, mesh,
               device) -> List[Dict[str, torch.Tensor]]:
    """This rank's ring buckets of ``edges`` over the mesh's model ranks;
    raises unless they split ``num_nodes`` evenly (node shards of equal
    size, as the feeder's clips are cut)."""
    steps, v_pad, _ = partition_edges_ring(edges, mesh.model, num_nodes)
    if v_pad != num_nodes:
        raise ValueError(
            f"num_nodes={num_nodes} must divide evenly over the "
            f"{mesh.model}-way edge axis (next multiple: {v_pad})")
    return [_rank_arrays(step, mesh.coords[1], device) for step in steps]


def attach(model: torch.nn.Module, mesh,
           strategy: str = "gather") -> torch.nn.Module:
    """Wire ``mesh`` into ``model`` for ``strategy``: under ``gather`` an
    ST-GCN model takes this rank's slice of its subset-flattened COO
    edges (``model.edges``); under ``ring`` a ring-GNN model takes this
    rank's ring buckets of its graph (``model.ring_steps``) and its
    clips become node shards; both take the model group
    (``model.edge_group``), and every BN averages over the data ranks.
    Returns the model."""
    from shift_gcn_torch.models import ring_gnn, stgcn
    from shift_gcn_torch.ops.batchnorm import BatchNorm

    if mesh.tensor_parallel:
        raise ValueError("edge partition needs a mesh whose model ranks "
                         "hold edge shards, not a tensor-parallel one")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown edge_strategy={strategy!r} (expected "
                         "'gather' or 'ring')")
    want = stgcn.Model if strategy == "gather" else ring_gnn.Model
    if not isinstance(model, want):
        raise ValueError(f"edge_strategy={strategy!r} needs a "
                         f"{want.__module__} model, not "
                         f"{type(model).__module__}")
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.group = mesh.data_group
    if strategy == "gather":
        parts = partition_edges(subset_coo_from_adjacency(
            model.A.cpu().numpy()), mesh.model)
        model.edges = _rank_arrays(parts, mesh.coords[1], model.A.device)
    else:
        model.ring_steps = ring_steps(
            ring_gnn.synthetic_graph(model.config), model.config.num_nodes,
            mesh, model.edge_src.device)
    model.edge_group = mesh.model_group
    return model


def shards_nodes(model: torch.nn.Module) -> bool:
    """Whether ``model`` takes node shards (attached under ``ring``)."""
    return getattr(model, "ring_steps", None) is not None


def _local_batch(model, batch: Dict[str, torch.Tensor], mesh,
                 keys=("label",)) -> Dict[str, torch.Tensor]:
    rows = mesh.batch_rows(batch["data"].shape[0])
    local = {"data": mesh.local(batch["data"], False, shards_nodes(model))}
    local.update({k: batch[k][rows] for k in keys if k in batch})
    return local


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], lr: float, mesh
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of the global ``batch`` (every rank passes the whole
    batch; it takes its rows, and under ``ring`` its nodes) on an
    attached model: the contract of the reference's
    ``make_edge_sharded_train_step``.  Returns the world mean (loss,
    acc)."""
    from shift_gcn_torch.train import state as state_lib

    return state_lib.train_step(model, optimizer,
                                _local_batch(model, batch, mesh), lr,
                                mesh=mesh)


def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              mesh) -> Tuple[np.ndarray, float, float]:
    """(logits of the whole batch, masked NLL sum, mask sum) on every
    rank: the contract of ``make_edge_sharded_eval_step``.  Each data
    rank scores its rows; the logits are gathered in data-rank order."""
    from shift_gcn_torch.train import state as state_lib

    logits, loss_sum, n = state_lib.eval_step(
        model, _local_batch(model, batch, mesh, ("label", "mask")))
    logits, sums = mesh.gather_rows([
        logits.float().cpu().numpy(),
        np.asarray([[float(loss_sum), float(n)]])])
    return logits, float(sums[:, 0].sum()), float(sums[:, 1].sum())


def make_sharded_aggregator(edges: Dict[str, np.ndarray], num_nodes: int,
                            mesh, strategy: str = "gather", device="cuda"):
    """A (B, V, C) -> (B, V, C) aggregator with the edge list partitioned
    over the mesh's model ranks (every rank of the group calls it on the
    same x): ``gather`` sums the ranks' partial sums; ``ring`` pads V to
    a multiple of the ranks, aggregates this rank's node block around
    the ring and gathers the blocks (the gather is not differentiable:
    ``ring_aggregate`` is the differentiable op).  Its edge arrays live
    on ``device``: the card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    if strategy == "ring":
        steps, v_pad, v_loc = partition_edges_ring(edges, mesh.model,
                                                   num_nodes)
        local = [_rank_arrays(s, mesh.coords[1], device) for s in steps]
        start = mesh.coords[1] * v_loc

        def aggregate_ring(x: torch.Tensor) -> torch.Tensor:
            xp = torch.nn.functional.pad(x, (0, 0, 0, v_pad - x.shape[-2]))
            out = ring_aggregate(xp[:, start:start + v_loc], local,
                                 mesh.model_group)
            return torch.cat(comm.all_gather(out.detach(), mesh.model_group),
                             -2)[:, :num_nodes]

        return aggregate_ring
    if strategy != "gather":
        raise ValueError(f"unknown strategy {strategy!r}")
    part = _rank_arrays(partition_edges(edges, mesh.model), mesh.coords[1],
                        device)

    def aggregate(x: torch.Tensor) -> torch.Tensor:
        return edge_partitioned_aggregate(x, part["src"], part["dst"],
                                          part["weight"], num_nodes,
                                          mesh.model_group)

    return aggregate

