"""Node-feature GNN on a synthetic large graph (the ring-GNN family).

A port of the reference package's ``models/ring_gnn.py``: a V-node
sparse digraph made deterministically from ``graph_seed``
(``synthetic_graph``: a stride ring, v -> 9v + 5 mod V, plus
``extra_edges`` random edges with weights U(0.5, 1.5), the same numpy
draws as the reference, so the same graph bit for bit), and a stack of
aggregate -> project layers (``edge_aggregate`` over the COO edges, then
``h @ W + b``, ReLU between layers), a mean over the nodes, and a linear
classifier.  No batch statistics.

Data contract (the reference's): feeder clips (N, C, T, V, M) with
T = M = 1, each clip one (V, C) node-feature frame; ``forward`` raises on
any other T or M.

Parameter names follow the reference's tree (``l{i}.weight`` (C_in,
C_out), ``l{i}.bias``, ``fc.weight`` (num_class, H), ``fc.bias``); the
edges are buffers kept out of the state_dict.  The reference's ring
path runs when ``parallel.edge_partition.attach`` has given the model
this rank's ring buckets (``ring_steps``) and the model group
(``edge_group``): the clips are then this rank's node shard
(N, C, 1, V / P, 1), every aggregation is ``ring_aggregate`` and the
pooled mean is the node sum summed over the group over ``num_nodes``.
The family launches no kernel of the port: the segment sum is
``index_add_``, whose CUDA order is not fixed, so a card's logits agree
with the CPU's to fp32 roundoff, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shift_gcn_torch.ops.aggregate import edge_aggregate, wide
from shift_gcn_torch.parallel import comm
from shift_gcn_torch.parallel.edge_partition import ring_aggregate
from shift_gcn_torch.utils.device import pin_fp32_math, resolve_device


@dataclasses.dataclass(frozen=True)
class RingGNNConfig:
    num_class: int = 2
    num_nodes: int = 256
    in_channels: int = 8
    hidden: Tuple[int, ...] = (32, 32)
    graph_seed: int = 3
    extra_edges: int = 512


def synthetic_graph(config: RingGNNConfig) -> Dict[str, np.ndarray]:
    """Deterministic sparse digraph over num_nodes (COO, weighted)."""
    v = config.num_nodes
    rng = np.random.default_rng(config.graph_seed)
    src = np.arange(v, dtype=np.int32)
    dst = ((src * 9 + 5) % v).astype(np.int32)
    extra = rng.integers(0, v, (2, config.extra_edges)).astype(np.int32)
    n_e = v + config.extra_edges
    return {
        "src": np.concatenate([src, extra[0]]),
        "dst": np.concatenate([dst, extra[1]]),
        "weight": rng.uniform(0.5, 1.5, n_e).astype(np.float32),
    }


class Dense(nn.Module):
    """weight (C_in, C_out) and bias (C_out,): ``h @ weight + bias``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))


class Classifier(nn.Module):
    """weight (num_class, H) and bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class Model(nn.Module):
    """Ring-GNN classifier: (N, C, 1, V, 1) clips -> (N, num_class)
    logits, fp32."""

    def __init__(self, config: RingGNNConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        pin_fp32_math()
        self.config = config
        for name, array in synthetic_graph(config).items():
            self.register_buffer(f"edge_{name}", torch.from_numpy(array),
                                 persistent=False)
        dims = (config.in_channels,) + tuple(config.hidden)
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"l{i + 1}", Dense(cin, cout))
        self.fc = Classifier(dims[-1], config.num_class)
        # the ring's buckets and group (parallel/edge_partition.py)
        self.ring_steps: Optional[List[Dict[str, torch.Tensor]]] = None
        self.edge_group = None
        self.to(device)
        self.eval()

    @property
    def edges(self) -> Dict[str, torch.Tensor]:
        return {"src": self.edge_src, "dst": self.edge_dst,
                "weight": self.edge_weight}

    def init_weights(self, generator: torch.Generator) -> "Model":
        """The reference's ``init_params`` scales drawn from ``generator``
        (a CPU generator): N(0, 2 / C_in) weights, zero biases.  Matches
        the reference in distribution, not in bits."""
        with torch.no_grad():
            layers = [getattr(self, f"l{i + 1}")
                      for i in range(len(self.config.hidden))] + [self.fc]
            for layer in layers:
                fan_in = (layer.weight.shape[0] if layer is not self.fc
                          else layer.weight.shape[1])
                layer.weight.copy_(torch.randn(
                    layer.weight.shape, generator=generator)
                    * math.sqrt(2.0 / fan_in))
                layer.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        ring = self.ring_steps is not None
        nodes = self.config.num_nodes // (len(self.ring_steps) if ring
                                          else 1)
        if (t, m) != (1, 1) or v != nodes:
            raise ValueError(
                f"ring-GNN clips are (N, C, 1, {nodes}, 1)"
                + (" node shards" if ring else "")
                + f"; got {tuple(x.shape)}")
        h = wide(x).permute(0, 2, 4, 3, 1).reshape(n, v, c)
        layers = len(self.config.hidden)
        for i in range(layers):
            layer = getattr(self, f"l{i + 1}")
            agg = (ring_aggregate(h, self.ring_steps, self.edge_group)
                   if ring else edge_aggregate(h, self.edges, v))
            h = agg @ layer.weight + layer.bias
            if i + 1 < layers:
                h = torch.relu(h)
        if ring:
            pooled = (comm.all_reduce_sum(h.sum(dim=1), self.edge_group)
                      / self.config.num_nodes)
        else:
            pooled = h.mean(dim=1)
        return pooled @ self.fc.weight.t() + self.fc.bias


def config_from_args(model_args: Dict[str, Any]) -> RingGNNConfig:
    """RingGNNConfig from YAML ``model_args`` (the reference's
    ``config_from_args``)."""
    kwargs: Dict[str, Any] = {}
    if "hidden" in model_args:
        kwargs["hidden"] = tuple(int(h) for h in model_args["hidden"])
    return RingGNNConfig(
        num_class=model_args.get("num_class", 2),
        num_nodes=model_args.get("num_nodes", 256),
        in_channels=model_args.get("in_channels", 8),
        graph_seed=model_args.get("graph_seed", 3),
        extra_edges=model_args.get("extra_edges", 512),
        **kwargs,
    )
