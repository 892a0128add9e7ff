"""2s-AGCN, the joint stream: the published adaptive graph convolution.

Shi, Zhang, Cheng and Lu, "Two-Stream Adaptive Graph Convolutional
Networks for Skeleton-Based Action Recognition", CVPR 2019; the source is
``github.com/lshiwjx/2s-AGCN`` ``model/agcn.py`` (``model.agcn.Model``),
which the registry resolves to this family (``agcn2s``).  With K = 3
subsets of the spatial-partition graph and d = C_out // 4 (the published
``coff_embedding=4``), a unit is

- GCN: per subset k the embeddings ``a_k = theta_k x + alpha_k`` and
  ``b_k = phi_k x + beta_k`` (1x1 convs ``conv_a``, ``conv_b``, C_in ->
  d), the attention ``C_k`` (softmax over source joints of the
  contraction of a_k and b_k over (d, T), divided by d*T), the graph
  ``G_k = A_k + PA_k + C_k`` (A fixed, PA learned), and
  ``y = sum_k W_k (x @ G_k) + sum_k bias_k`` (1x1 convs ``conv_d``);
  then ``ReLU(BN(y) + down(x))``, down a 1x1 conv and BN where the width
  changes, else x;
- TCN: ``BN(conv_{9x1, stride s}(h))``;
- ``ReLU(tcn(gcn(x)) + r(x))``, r none (unit 1), x, or a strided 1x1
  conv and BN.

The model: data BN over the M*V*C features in (m, v, c) order, the units,
the mean over (T', V) and then persons, the classifier.  It differs from
the ``stgcn`` family with ``adaptive_embed`` (the reference package's
approximation, kept for its tests) in six ways: the inner GCN residual
(unit 1's included), an embedding width of C_out / 4 per unit, the
temperature 1/(d*T), the embeddings' biases, the source-joint softmax
and the published ``x @ A``.

Layout.  A unit's activations are (N*M, V, T, C): channels last, and each
sample's joints outermost, so that ``x @ G_k`` is one batched product over
the samples of (V, V) by (V, T*C) matrices, and BN normalizes the
trailing channels.  The adjacency is one op on two hand-written kernels
(``ops/adaptive.py``, ``csrc/adaptive.cu``) that count one forward and
one backward launch per unit, and so is the 9-tap temporal conv
(``ops/agcn_tconv.py``, ``csrc/agcn_tconv.cu``: forward, input gradient
and weight gradient, one launch each per unit); the embeddings, the
aggregation, ``conv_d`` and the 1x1 convs are cuBLAS products pinned to
full fp32 (``utils/device.pin_fp32_math``), and train-mode BN is the
port's kernels.
The family runs in fp32: its config has no ``activation_dtype``.

Parameter and buffer names are the published state_dict's
(``l{i}.gcn1.conv_a.{k}.weight``, ``l{i}.gcn1.PA``, ``l{i}.gcn1.bn.*``,
``l{i}.gcn1.down.{0,1}.*``, ``l{i}.tcn1.conv.*``, ``l{i}.tcn1.bn.*``,
``l{i}.residual.conv.*``, ``l{i}.residual.bn.*``, ``data_bn.*``,
``fc.*``); the fixed adjacency ``A`` is a buffer kept out of it, as the
published model keeps it out of its parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.ops import adaptive, agcn_tconv
from shift_gcn_torch.ops.batchnorm import BatchNorm
from shift_gcn_torch.ops.conv import Conv, pointwise_conv
from shift_gcn_torch.utils.device import pin_fp32_math, resolve_device

COFF_EMBEDDING = 4   # d = C_out // 4 (the published unit_gcn default)
TEMPORAL_KERNEL = 9

# (C_in, C_out, stride, residual) of the published units l1..l10
PUBLISHED_BLOCKS = ((3, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True),
                    (64, 64, 1, True), (64, 128, 2, True),
                    (128, 128, 1, True), (128, 128, 1, True),
                    (128, 256, 2, True), (256, 256, 1, True),
                    (256, 256, 1, True))


@dataclasses.dataclass(frozen=True)
class AGCNConfig:
    num_class: int = 60
    num_point: int = 25
    num_person: int = 2
    graph: str = "ntu_rgb_d"
    in_channels: int = 3
    blocks: Tuple[Tuple[int, int, int, bool], ...] = PUBLISHED_BLOCKS


class UnitGCN(nn.Module):
    """The adaptive graph convolution: (N', V, T, C_in) -> (N', V, T,
    C_out)."""

    def __init__(self, cin: int, cout: int, adjacency: torch.Tensor):
        super().__init__()
        k, v = adjacency.shape[0], adjacency.shape[1]
        d = max(1, cout // COFF_EMBEDDING)
        self.register_buffer("A", adjacency.clone(), persistent=False)
        self.PA = nn.Parameter(torch.zeros(k, v, v))
        self.conv_a = nn.ModuleList(Conv(cin, d) for _ in range(k))
        self.conv_b = nn.ModuleList(Conv(cin, d) for _ in range(k))
        self.conv_d = nn.ModuleList(Conv(cin, cout) for _ in range(k))
        if cin != cout:
            self.down = nn.ModuleList([Conv(cin, cout), BatchNorm(cout)])
        self.bn = BatchNorm(cout)

    def inner_residual(self, x: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "down"):
            return x
        conv, bn = self.down
        return bn(pointwise_conv(x, conv.weight, conv.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, v, t, cin = x.shape
        k = self.A.shape[0]
        # the 2K embeddings in one product: per node the K a_k, the K b_k
        branches = [*self.conv_a, *self.conv_b]
        w = torch.cat([c.weight.reshape(-1, cin) for c in branches])
        b = torch.cat([c.bias for c in branches])
        e = torch.addmm(b.to(x.dtype), x.reshape(-1, cin),
                        w.t().to(x.dtype)).view(n, v, t, -1)
        g = adaptive.agcn_adjacency(e, self.A.to(x.dtype), self.PA, k)
        # y = sum_k W_k (x @ G_k) + sum_k bias_k, one product per subset
        # accumulated in place of a bias pass
        rows = x.reshape(n, v, t * cin)
        y = sum(c.bias for c in self.conv_d).to(x.dtype)
        for i, conv in enumerate(self.conv_d):
            z = torch.bmm(g[:, i].transpose(1, 2), rows)
            y = torch.addmm(y, z.view(-1, cin),
                            conv.weight.reshape(-1, cin).t().to(x.dtype))
        y = self.bn(y.view(n, v, t, -1))
        return torch.relu(y + self.inner_residual(x))


class UnitTCN(nn.Module):
    """BN(conv_{k x 1, stride s}(x)): (N', V, T, C_in) -> (N', V, T // s,
    C_out); k = 1 is the strided residual, k = 9 the unit's TCN (the
    port's kernels, ``ops/agcn_tconv.py``)."""

    def __init__(self, cin: int, cout: int, k: int = TEMPORAL_KERNEL,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = Conv(cin, cout, k)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, v, t, c = x.shape
        if self.conv.weight.shape[2] == 1:
            h = pointwise_conv(x[:, :, ::self.stride], self.conv.weight,
                               self.conv.bias)
        else:
            h = agcn_tconv.temporal_conv9(x.reshape(n * v, t, c),
                                          self.conv.weight, self.conv.bias,
                                          self.stride)
            h = h.reshape(n, v, h.shape[1], -1)
        return self.bn(h)


class Unit(nn.Module):
    """TCN_GCN_unit: ReLU(tcn(gcn(x)) + r(x))."""

    def __init__(self, cin: int, cout: int, stride: int, residual: bool,
                 adjacency: torch.Tensor):
        super().__init__()
        self.gcn1 = UnitGCN(cin, cout, adjacency)
        self.tcn1 = UnitTCN(cout, cout, stride=stride)
        self.has_residual = residual
        if residual and (cin != cout or stride != 1):
            self.residual = UnitTCN(cin, cout, k=1, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.tcn1(self.gcn1(x))
        if hasattr(self, "residual"):
            h = h + self.residual(x)
        elif self.has_residual:
            h = h + x
        return torch.relu(h)


class Model(nn.Module):
    """2s-AGCN classifier; ``forward`` maps (N, C, T, V, M) clips to logits
    (N, num_class).  A new Model holds zeros (its classifier, an
    ``nn.Linear`` as published, torch's default draw) until a state_dict
    is loaded or ``init_weights`` draws the published initialization."""

    def __init__(self, config: AGCNConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        pin_fp32_math()
        self.config = config
        v = config.num_point
        adjacency = torch.from_numpy(get_graph(config.graph).A)
        if adjacency.shape[1:] != (v, v):
            raise ValueError(f"graph {config.graph!r} has "
                             f"{adjacency.shape[1]} joints, not {v}")
        self.data_bn = BatchNorm(config.num_person * config.in_channels * v)
        cin = config.in_channels
        for i, (bcin, cout, stride, residual) in enumerate(config.blocks):
            if bcin != cin:
                raise ValueError(f"unit {i + 1} takes {bcin} channels, the "
                                 f"one before it gives {cin}")
            self.add_module(f"l{i + 1}", Unit(cin, cout, stride, residual,
                                              adjacency))
            cin = cout
        self.fc = nn.Linear(cin, config.num_class)
        self.to(device)
        self.eval()

    def units(self):
        return [getattr(self, f"l{i + 1}")
                for i in range(len(self.config.blocks))]

    def init_weights(self, generator: torch.Generator) -> "Model":
        """The published initialization, drawn from ``generator`` (a CPU
        generator, so a seed gives the same weights on any device):
        kaiming-normal over fan-out for conv_a, conv_b, down, the TCN and
        the residual, N(0, 2 / (C_out * C_in * K)) for conv_d, zero conv
        biases, BN at 1 / 0 but the GCN's BN weight at 1e-6, PA at 1e-6,
        the classifier N(0, 2 / num_class) with torch's default
        U(+-1/sqrt(in)) bias."""

        def normal(param, std):
            param.copy_(torch.randn(param.shape, generator=generator) * std)

        def fan_out(conv):
            w = conv.weight
            normal(w, math.sqrt(2.0 / (w.shape[0] * w.shape[2]
                                       * w.shape[3])))
            conv.bias.zero_()

        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
                    module.num_batches_tracked.zero_()
            for unit in self.units():
                gcn = unit.gcn1
                gcn.PA.fill_(1e-6)
                branches = len(gcn.conv_d)
                for conv in [*gcn.conv_a, *gcn.conv_b]:
                    fan_out(conv)
                for conv in gcn.conv_d:
                    cout, cin = conv.weight.shape[:2]
                    normal(conv.weight,
                           math.sqrt(2.0 / (cout * cin * branches)))
                    conv.bias.zero_()
                if hasattr(gcn, "down"):
                    fan_out(gcn.down[0])
                gcn.bn.weight.fill_(1e-6)
                fan_out(unit.tcn1.conv)
                if hasattr(unit, "residual"):
                    fan_out(unit.residual.conv)
            normal(self.fc.weight, math.sqrt(2.0 / self.config.num_class))
            bound = 1.0 / math.sqrt(self.fc.weight.shape[1])
            self.fc.bias.copy_(torch.rand(self.fc.bias.shape,
                                          generator=generator) * 2 * bound
                               - bound)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        # data_bn over M*V*C features in (m, v, c) order, stats over (N, T)
        h = self.data_bn(x.permute(0, 2, 4, 3, 1).reshape(n, t, m * v * c))
        h = h.reshape(n, t, m, v, c).permute(0, 2, 3, 1, 4)
        h = h.reshape(n * m, v, t, c)
        for unit in self.units():
            h = unit(h)
        feat = h.shape[-1]
        h = h.reshape(n, m, -1, feat).mean(dim=2).mean(dim=1)
        return self.fc(h)


def config_from_args(model_args: Dict[str, Any]) -> AGCNConfig:
    """AGCNConfig from the published ``model_args`` (num_class /
    num_point / num_person / graph / graph_args / in_channels), plus
    ``blocks``: rows [cin, cout, stride, residual] in place of the
    published ten units."""
    graph = get_graph(model_args.get("graph", "ntu_rgb_d"))
    mode = (model_args.get("graph_args") or {}).get("labeling_mode",
                                                     "spatial")
    if mode != "spatial":
        raise ValueError(f"graph labeling_mode {mode!r}: the port builds "
                         "the spatial partition alone")
    kwargs = {}
    if "blocks" in model_args:
        kwargs["blocks"] = tuple(
            (int(b[0]), int(b[1]), int(b[2]) if len(b) > 2 else 1,
             bool(b[3]) if len(b) > 3 else True)
            for b in model_args["blocks"])
    return AGCNConfig(
        num_class=model_args.get("num_class", 60),
        num_point=model_args.get("num_point", graph.num_nodes),
        num_person=model_args.get("num_person", 2),
        graph=graph.name,
        in_channels=model_args.get("in_channels", 3),
        **kwargs,
    )
