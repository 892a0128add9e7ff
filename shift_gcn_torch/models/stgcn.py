"""Aggregation-based spatial-temporal GCN (ST-GCN / AGCN style).

A port of the reference package's ``models/stgcn.py``: the classic
multi-subset adjacency aggregation out = sum_k A_k X W_k, with an
optional learnable residual adjacency ``B`` (``adaptive``, AGCN's B) and
an optional data-dependent attention term (``adaptive_embed``, 2s-AGCN's
C: per-subset theta/phi embeddings, a dense SDDMM over the complete graph
and a row softmax).  Each block: aggregation + bias, BN, ReLU, a k x 1
temporal conv (k = ``temporal_kernel``, temporal stride), BN, and a
residual (a 1x1 down conv + BN when the width changes, ``res[:,
::stride]`` when the block is strided), then ReLU.  The classifier pools
over (T', V) then persons.

Parameter and buffer names follow the reference's parameter tree
(``l{i}.gcn_weight``, ``l{i}.gcn_bias``, ``l{i}.B``, ``l{i}.theta``,
``l{i}.phi``, ``l{i}.tcn.weight``, ``l{i}.bn1.*``, ``l{i}.bn2.*``,
``l{i}.down.*``, ``l{i}.down_bn.*``, ``data_bn.*``, ``fc.*``), so
``utils/checkpoint.state_dict_from_arrays`` carries a reference tree
across unchanged and ``train/optim.py``'s name-keyed weight-decay table
gives the reference's decays.  The adjacency ``A`` is a buffer kept out
of the state_dict, as the reference keeps it out of the tree.

The edge path of the reference's ``_block`` (its ``edges`` /
``edge_axis``) runs when ``parallel.edge_partition.attach`` has given
the model this rank's slice of the subset-flattened COO edges
(``edges``) and the model group (``edge_group``): the per-subset
projection, its (K, V) axes flattened into K*V source nodes, one
partitioned segment sum summed over the group, and the learnable B and
the attention term dense, so that the result is dense(A + B) up to
roundoff.  Without them the dense path runs, as before.  The family
has no shift and launches no kernel of the port: its products are
``torch.einsum`` (cuBLAS) and its convs cuDNN, both pinned to full fp32
(``utils/device.pin_fp32_math``).  It runs in fp32: its config has no
``activation_dtype`` or ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.ops.aggregate import dense_graph_aggregate, wide
from shift_gcn_torch.ops.batchnorm import BatchNorm
from shift_gcn_torch.ops.conv import Conv, pointwise_conv, temporal_conv
from shift_gcn_torch.parallel.edge_partition import edge_partitioned_aggregate
from shift_gcn_torch.utils.device import pin_fp32_math, resolve_device


@dataclasses.dataclass(frozen=True)
class STGCNConfig:
    num_class: int = 60
    num_point: int = 25
    num_person: int = 2
    graph: str = "ntu_rgb_d"
    in_channels: int = 3
    channels: Tuple[int, ...] = (64, 64, 64, 128, 128, 256, 256)
    strides: Tuple[int, ...] = (1, 1, 1, 2, 1, 2, 1)
    temporal_kernel: int = 9
    adaptive: bool = True    # learnable residual adjacency B
    adaptive_embed: int = 0  # width of the attention embeddings; 0 = off


def adaptive_attention(x: torch.Tensor, theta: torch.Tensor,
                       phi: torch.Tensor) -> torch.Tensor:
    """Per-sample data-dependent adjacency (2s-AGCN's C).

    x: (N, T, V, C); theta, phi: (K, C, d).  Every (t, v) node is embedded
    by both, the embeddings are contracted over (T, d) into per-sample
    (V, V) scores divided by T (the reference's temperature: 1/T only),
    and each row is softmaxed.  Returns (K, N, V, V) fp32 (fp64 for
    fp64 x)."""
    x = wide(x)
    a = torch.einsum("ntvc,kcd->knvtd", x, theta)
    b = torch.einsum("ntuc,kcd->knutd", x, phi)
    scores = torch.einsum("knvtd,knutd->knvu", a, b) / x.shape[1]
    return torch.softmax(scores, dim=-1)


class Block(nn.Module):
    """One aggregation + temporal block: (N, T, V, C_in) ->
    (N, T // stride, V, C_out)."""

    def __init__(self, cin: int, cout: int, stride: int, k_sub: int,
                 v: int, config: STGCNConfig):
        super().__init__()
        self.stride = stride
        self.gcn_weight = nn.Parameter(torch.zeros(k_sub, cin, cout))
        self.gcn_bias = nn.Parameter(torch.zeros(cout))
        self.tcn = Conv(cout, cout, config.temporal_kernel)
        if config.adaptive:
            self.B = nn.Parameter(torch.zeros(k_sub, v, v))
        if config.adaptive_embed:
            d_e = config.adaptive_embed
            self.theta = nn.Parameter(torch.zeros(k_sub, cin, d_e))
            self.phi = nn.Parameter(torch.zeros(k_sub, cin, d_e))
        self.bn1 = BatchNorm(cout)
        self.bn2 = BatchNorm(cout)
        if cin != cout:
            self.down = Conv(cin, cout)
            self.down_bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, adj_base: torch.Tensor,
                edges: Optional[Dict[str, torch.Tensor]] = None,
                edge_group=None) -> torch.Tensor:
        if edges is None:
            adj = adj_base + self.B if hasattr(self, "B") else adj_base
            h = dense_graph_aggregate(x, adj, self.gcn_weight)
        else:
            # per-subset projection, (K, V) flattened into one source axis
            # so that one partitioned segment sum covers every subset
            hk = torch.einsum("...uc,kcd->k...ud", wide(x),
                              wide(self.gcn_weight)).movedim(0, -3)
            hk = hk.reshape(hk.shape[:-3] + (-1, hk.shape[-1]))
            h = edge_partitioned_aggregate(
                hk, edges["src"], edges["dst"], edges["weight"],
                x.shape[-2], edge_group)
            if hasattr(self, "B"):
                h = h + dense_graph_aggregate(x, self.B, self.gcn_weight)
        if hasattr(self, "theta"):
            attn = adaptive_attention(x, self.theta, self.phi)
            hk = torch.einsum("...uc,kcd->k...ud", wide(x), self.gcn_weight)
            h = h + torch.einsum("knvu,kntud->ntvd", attn, hk)
        h = h + self.gcn_bias
        h = torch.relu(self.bn1(h))
        h = temporal_conv(h, self.tcn.weight, self.tcn.bias,
                          stride=self.stride)
        h = self.bn2(h)
        if hasattr(self, "down"):
            res = pointwise_conv(x, self.down.weight, self.down.bias)
            res = self.down_bn(res[:, ::self.stride])
        else:
            res = x[:, ::self.stride]
        return torch.relu(h + res)


class Linear(nn.Module):
    """Classifier weight (out, in) and bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class Model(nn.Module):
    """ST-GCN classifier; ``forward`` maps (N, C, T, V, M) to logits
    (N, num_class) in fp32.  A new Model holds zeros until a state_dict is
    loaded or ``init_weights`` draws the reference package's
    initialization."""

    def __init__(self, config: STGCNConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        pin_fp32_math()
        if len(config.channels) != len(config.strides):
            raise ValueError(f"channels {config.channels} and strides "
                             f"{config.strides} differ in length")
        self.config = config
        v = config.num_point
        adjacency = torch.from_numpy(get_graph(config.graph).A)
        if adjacency.shape[1:] != (v, v):
            raise ValueError(f"graph {config.graph!r} has "
                             f"{adjacency.shape[1]} joints, not {v}")
        self.register_buffer("A", adjacency, persistent=False)
        self.data_bn = BatchNorm(config.num_person * config.in_channels * v)
        cin = config.in_channels
        for i, (cout, stride) in enumerate(zip(config.channels,
                                               config.strides)):
            self.add_module(f"l{i + 1}", Block(cin, cout, stride,
                                               adjacency.shape[0], v, config))
            cin = cout
        self.fc = Linear(cin, config.num_class)
        # the edge partition's slice and group (parallel/edge_partition.py)
        self.edges: Optional[Dict[str, torch.Tensor]] = None
        self.edge_group = None
        self.to(device)
        self.eval()

    def blocks(self):
        return [getattr(self, f"l{i + 1}")
                for i in range(len(self.config.channels))]

    def init_weights(self, generator: torch.Generator) -> "Model":
        """The reference package's ``init_params`` scales, drawn from
        ``generator`` (a CPU generator, so a seed gives the same weights on
        any device): normal weights, zero biases and B, BN identities.
        Matches the reference in distribution, not in bits."""

        def normal(param, std):
            param.copy_(torch.randn(param.shape, generator=generator) * std)

        k_sub = self.A.shape[0]
        k_t = self.config.temporal_kernel
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
                    module.num_batches_tracked.zero_()
            for block in self.blocks():
                cin, cout = block.gcn_weight.shape[1:]
                normal(block.gcn_weight, math.sqrt(2.0 / (k_sub * cout)))
                block.gcn_bias.zero_()
                normal(block.tcn.weight, math.sqrt(2.0 / (cout * k_t)))
                block.tcn.bias.zero_()
                if hasattr(block, "B"):
                    block.B.zero_()
                if hasattr(block, "theta"):
                    normal(block.theta, math.sqrt(1.0 / cin))
                    normal(block.phi, math.sqrt(1.0 / cin))
                if hasattr(block, "down"):
                    normal(block.down.weight, math.sqrt(2.0 / cout))
                    block.down.bias.zero_()
            normal(self.fc.weight, math.sqrt(2.0 / self.config.num_class))
            self.fc.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        # data_bn over M*V*C features in (m, v, c) order, stats over (N, T)
        h = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t).transpose(1, 2)
        h = self.data_bn(wide(h))
        h = h.reshape(n, t, m, v, c).permute(0, 2, 1, 3, 4)
        h = h.reshape(n * m, t, v, c).contiguous()
        for block in self.blocks():
            h = block(h, self.A, self.edges, self.edge_group)
        feat = h.shape[-1]
        h = h.reshape(n, m, -1, feat).mean(dim=2).mean(dim=1)
        return h @ self.fc.weight.t() + self.fc.bias


def config_from_args(model_args: Dict[str, Any]) -> STGCNConfig:
    """STGCNConfig from YAML ``model_args`` (reference registry
    ``_stgcn_config``): num_class / num_point / num_person / graph /
    in_channels / channels / strides / adaptive / adaptive_embed."""
    graph = get_graph(model_args.get("graph", "ntu_rgb_d"))
    kwargs = {}
    for key in ("channels", "strides"):
        if key in model_args:
            kwargs[key] = tuple(model_args[key])
    return STGCNConfig(
        num_class=model_args.get("num_class", 60),
        num_point=model_args.get("num_point", graph.num_nodes),
        num_person=model_args.get("num_person", 2),
        graph=graph.name,
        in_channels=model_args.get("in_channels", 3),
        adaptive=model_args.get("adaptive", True),
        adaptive_embed=model_args.get("adaptive_embed", 0),
        **kwargs,
    )
