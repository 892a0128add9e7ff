"""Shift-GCN model as a torch module, for eval and training.

Parameter and buffer names match the reference torch ``state_dict``
(reference: model/shift_gcn.py:165-216), so a reference checkpoint loads
with ``load_state_dict(strict=True)``.  A new ``Model`` holds zeros (and
BN identities) until a state_dict is loaded or ``init_weights`` draws
the reference initialization from a ``torch.Generator``.  ``Model.train()``
switches every BN to batch statistics; the two kernel ops then run
through their ``torch.autograd.Function``s, whose backwards are kernels
too.

Backbone (reference: model/shift_gcn.py:178-187): 10 TCN_GCN units,
3->64 (no residual), 3x 64->64, 64->128 stride 2, 2x 128->128,
128->256 stride 2, 2x 256->256; global mean over (T', V) then persons;
linear classifier.

Layout: input (N, C, T, V, M) as the reference feeder gives it; inside,
(N*M, T, V, C) channels-last.  Each unit launches the fused spatial
kernel once and the temporal-shift kernel twice on a CUDA device in its
forward.

``ModelConfig.lowering`` (``ops/lowering.py``, resolved with the ``SGT_*``
environment overrides when the model is built) sets the shift range
check's ``max_shift``, the joint-axis pass (``exact_xpos``) and the BN
normalize precision (``bn_lp`` / ``bn_lp_eval``); its other knobs choose
among the reference's XLA formulations, which the kernels replace.
``ModelConfig.compute_dtype`` rounds the inputs of the 1x1 convs
(``temporal_linear`` and the down convs) to that type; the residual
temporal conv and the fused spatial kernel ignore it, as the reference's
conv and Pallas paths do.

Data and sequence parallelism (``parallel/seqpar.py``): ``attach`` sets
each BN's ``group`` (sync BN), each ``ShiftTCN``'s ``mesh`` (the
constraint's reduction) and ``shard_time`` (the shifts on halo-extended
T shards, ``parallel/halo.py``), and ``Model.mesh`` under
``shard_time``, whose time ranks the final pooling is averaged over.
Under tensor parallelism (``parallel/tensor.py``) it sets each
``ShiftGCN``'s and ``ShiftTCN``'s ``mesh`` to a tensor-parallel mesh:
K4 and the temporal 1x1 then run on the rank's slice of their output
channels, and the slices are gathered over the model ranks.

``ModelConfig.remat`` (the reference package's per-block checkpoint):
in a training forward with grad enabled each ``TCNGCNUnit`` runs under
non-reentrant ``torch.utils.checkpoint``, which keeps the unit's input
and drops its activations; the backward runs the unit again (its K1 and
K4 launches, and under a mesh its collectives, on every rank in the same
order), with BN's running statistics frozen (``ops/batchnorm.py``
``frozen_statistics``).  Eval, serving and export run as without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.ops import shift_gcn_kernel, temporal_shift
from shift_gcn_torch.ops.batchnorm import BatchNorm, frozen_statistics
from shift_gcn_torch.ops.conv import Conv, pointwise_conv, temporal_conv
from shift_gcn_torch.ops.lowering import Lowering
from shift_gcn_torch.ops.lowering import from_dict as lowering_from_dict
from shift_gcn_torch.ops.lowering import resolve as resolve_lowering
from shift_gcn_torch.ops.spatial_shift import flat_shift_index
from shift_gcn_torch.parallel import comm, halo, tensor
from shift_gcn_torch.utils.device import pin_fp32_math, resolve_device


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    in_channels: int
    out_channels: int
    stride: int = 1
    residual: bool = True


def default_backbone() -> Tuple[BlockSpec, ...]:
    """The 10-block Shift-GCN backbone (reference: model/shift_gcn.py:178-187)."""
    return (
        BlockSpec(3, 64, residual=False),
        BlockSpec(64, 64),
        BlockSpec(64, 64),
        BlockSpec(64, 64),
        BlockSpec(64, 128, stride=2),
        BlockSpec(128, 128),
        BlockSpec(128, 128),
        BlockSpec(128, 256, stride=2),
        BlockSpec(256, 256),
        BlockSpec(256, 256),
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (reference Model.__init__ signature,
    model/shift_gcn.py:166)."""

    num_class: int = 60
    num_point: int = 25
    num_person: int = 2
    graph: str = "ntu_rgb_d"
    in_channels: int = 3
    blocks: Tuple[BlockSpec, ...] = dataclasses.field(
        default_factory=default_backbone)
    # ypos init is U(-shift_init_scale, shift_init_scale)
    shift_init_scale: float = 1.0
    # round the 1x1 convs' matmul inputs to this dtype ("bfloat16")
    compute_dtype: Optional[str] = None
    # run the backbone in this activation dtype ("bfloat16"); parameters,
    # BN statistics, pooling and the classifier stay fp32
    activation_dtype: Optional[str] = None
    # lowering knobs (ops/lowering.py); None: the defaults, with the SGT_*
    # environment overrides applied when the model is built
    lowering: Optional[Lowering] = None
    # recompute each unit in the backward of a training step: one more
    # forward for the activation memory of one unit at a time
    remat: bool = False

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return (getattr(torch, self.compute_dtype)
                if self.compute_dtype else None)

    @property
    def act_dtype(self) -> Optional[torch.dtype]:
        return (getattr(torch, self.activation_dtype)
                if self.activation_dtype else None)


class ShiftGCN(nn.Module):
    """Spatial block (reference: model/shift_gcn.py:77-142)."""

    def __init__(self, cin: int, cout: int, v: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Linear_weight = nn.Parameter(torch.zeros(cin, cout))
        self.Linear_bias = nn.Parameter(torch.zeros(1, 1, cout))
        self.Feature_Mask = nn.Parameter(torch.zeros(1, v, cin))
        self.bn = BatchNorm(v * cout, feature_dims=2)
        self.down = (nn.Sequential(Conv(cin, cout), BatchNorm(cout))
                     if cin != cout else None)
        self.mesh = None  # a tensor-parallel mesh (seqpar.attach)
        # the reference's index buffers, kept for state_dict parity; the
        # kernel computes the same shifts from index arithmetic
        self.register_buffer(
            "shift_in", torch.from_numpy(flat_shift_index(v, cin, +1)))
        self.register_buffer(
            "shift_out", torch.from_numpy(flat_shift_index(v, cout, -1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, cin = x.shape
        gate = torch.tanh(self.Feature_Mask[0]) + 1.0
        bias = self.Linear_bias.reshape(-1)
        if self.mesh is None:
            h = shift_gcn_kernel.fused_shift_gcn(
                x.reshape(n * t, v, cin), gate, self.Linear_weight, bias)
        else:
            # this rank's output channels, then every rank's
            cols = tensor.columns(self.mesh, self.Linear_weight.shape[1])
            h = comm.gather_channels(shift_gcn_kernel.fused_shift_gcn(
                x.reshape(n * t, v, cin), gate, self.Linear_weight,
                bias[cols], cols.start), self.mesh.model_group)
        h = self.bn(h.reshape(n, t, v, -1))
        if self.down is not None:
            conv, bn = self.down
            res = bn(pointwise_conv(x, conv.weight, conv.bias,
                                    self.compute_dtype))
        else:
            res = x
        return torch.relu(h + res)


class Shift(nn.Module):
    """Shift positions (reference: shift.py:39-43).  xpos is read only by
    the ``exact_xpos`` joint pass, and gets a zero gradient (see
    ops/temporal_shift.py)."""

    def __init__(self, channels: int):
        super().__init__()
        self.xpos = nn.Parameter(torch.zeros(channels))
        self.ypos = nn.Parameter(torch.zeros(channels))


class ShiftTCN(nn.Module):
    """Temporal block (reference: model/shift_gcn.py:48-74)."""

    def __init__(self, channels: int, stride: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 exact_xpos: bool = False,
                 max_shift: int = temporal_shift.DEFAULT_MAX_SHIFT):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.exact_xpos = exact_xpos
        self.max_shift = max_shift
        self.mesh = None          # set by parallel.seqpar.attach
        self.shard_time = False
        self.bn = BatchNorm(channels)
        self.bn2 = BatchNorm(channels)
        self.shift_in = Shift(channels)
        self.shift_out = Shift(channels)
        self.temporal_linear = Conv(channels, channels)

    def _shift(self, h: torch.Tensor, shift: Shift,
               stride: int) -> torch.Tensor:
        if self.shard_time:
            return halo.sharded_temporal_shift(
                h, shift.ypos, stride, self.mesh, self.max_shift,
                xpos=shift.xpos, exact_xpos=self.exact_xpos)
        return temporal_shift.temporal_shift(
            h, shift.ypos, stride, xpos=shift.xpos,
            exact_xpos=self.exact_xpos, mesh=self.mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._shift(self.bn(x), self.shift_in, 1)
        weight, bias = self.temporal_linear.weight, self.temporal_linear.bias
        if self.mesh is not None and self.mesh.tensor_parallel:
            # this rank's output channels (weight rows), then every rank's
            cols = tensor.columns(self.mesh, weight.shape[0])
            h = comm.gather_channels(pointwise_conv(
                h, weight, bias[cols], self.compute_dtype),
                self.mesh.model_group)
        else:
            h = pointwise_conv(h, weight, bias, self.compute_dtype)
        h = torch.relu(h)
        h = self._shift(h, self.shift_out, self.stride)
        return self.bn2(h)


class ResidualTCN(nn.Module):
    """k=1 strided conv + BN residual (reference: model/shift_gcn.py:31-45)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = Conv(cin, cout)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(temporal_conv(x, self.conv.weight, self.conv.bias,
                                     stride=self.stride))


class TCNGCNUnit(nn.Module):
    """TCN_GCN_unit (reference: model/shift_gcn.py:145-162)."""

    def __init__(self, spec: BlockSpec, v: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 exact_xpos: bool = False,
                 max_shift: int = temporal_shift.DEFAULT_MAX_SHIFT):
        super().__init__()
        self.residual_kind = (
            "none" if not spec.residual
            else "conv" if (spec.in_channels != spec.out_channels
                            or spec.stride != 1)
            else "identity")
        self.gcn1 = ShiftGCN(spec.in_channels, spec.out_channels, v,
                             compute_dtype)
        self.tcn1 = ShiftTCN(spec.out_channels, spec.stride, compute_dtype,
                             exact_xpos, max_shift)
        if self.residual_kind == "conv":
            self.residual = ResidualTCN(spec.in_channels, spec.out_channels,
                                        spec.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.tcn1(self.gcn1(x))
        if self.residual_kind == "none":
            return torch.relu(h)
        res = x if self.residual_kind == "identity" else self.residual(x)
        return torch.relu(h + res.to(h.dtype))


class Linear(nn.Module):
    """Classifier weight (out, in) and bias under the torch Linear names."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class Model(nn.Module):
    """Shift-GCN classifier; ``forward`` maps (N, C, T, V, M) to logits
    (N, num_class) in fp32."""

    def __init__(self, config: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        pin_fp32_math()
        self.config = config
        self.lowering = resolve_lowering(config.lowering)
        v = config.num_point
        self.data_bn = BatchNorm(config.num_person * config.in_channels * v)
        for i, spec in enumerate(config.blocks):
            self.add_module(f"l{i + 1}", TCNGCNUnit(
                spec, v, config.dtype, self.lowering.exact_xpos,
                self.lowering.max_shift))
        self.fc = Linear(config.blocks[-1].out_channels, config.num_class)
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.lp_train = self.lowering.bn_lp
                module.lp_eval = self.lowering.bn_lp_eval
        self.mesh = None  # the time ranks under shard_time (seqpar.attach)
        self.register_load_state_dict_post_hook(_check_shift_range)
        self.to(device)
        self.eval()

    def init_weights(self, generator: torch.Generator) -> "Model":
        """Draw the reference initialization (reference package
        ``init_params``; the reference model/shift_gcn.py:26-28, 63, 92-104,
        208) from ``generator``, a CPU generator, so a seed gives the same
        weights on any device.  Matches the reference in distribution, not
        in bits."""

        def normal(param, std):
            param.copy_(torch.randn(param.shape, generator=generator) * std)

        def uniform(param, bound):
            param.copy_((torch.rand(param.shape, generator=generator) * 2
                         - 1) * bound)

        def kaiming_fan_out(conv):
            # kaiming_normal_(mode='fan_out'): std = sqrt(2 / (C_out*kh*kw))
            w = conv.weight
            normal(w, math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3])))

        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
                    module.num_batches_tracked.zero_()
            for i in range(len(self.config.blocks)):
                unit = getattr(self, f"l{i + 1}")
                gcn = unit.gcn1
                normal(gcn.Linear_weight,
                       math.sqrt(1.0 / gcn.Linear_weight.shape[1]))
                gcn.Linear_bias.zero_()
                gcn.Feature_Mask.zero_()
                if gcn.down is not None:
                    kaiming_fan_out(gcn.down[0])
                    gcn.down[0].bias.zero_()
                tcn = unit.tcn1
                for shift in (tcn.shift_in, tcn.shift_out):
                    uniform(shift.xpos, 1e-8)
                    uniform(shift.ypos, self.config.shift_init_scale)
                kaiming_fan_out(tcn.temporal_linear)
                # torch's default conv bias: U(+-1/sqrt(fan_in))
                uniform(tcn.temporal_linear.bias,
                        1.0 / math.sqrt(tcn.temporal_linear.weight.shape[1]))
                if unit.residual_kind == "conv":
                    kaiming_fan_out(unit.residual.conv)
                    unit.residual.conv.bias.zero_()
            normal(self.fc.weight, math.sqrt(2.0 / self.config.num_class))
            uniform(self.fc.bias, 1.0 / math.sqrt(self.fc.weight.shape[1]))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, t, v, m = x.shape
        # data_bn over M*V*C features in (m, v, c) order, stats over (N, T)
        h = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t).transpose(1, 2)
        h = self.data_bn(h)
        h = h.reshape(n, t, m, v, c).permute(0, 2, 1, 3, 4)
        h = h.reshape(n * m, t, v, c)
        h = h.to(self.config.act_dtype or h.dtype).contiguous()
        remat = (self.config.remat and self.training
                 and torch.is_grad_enabled())
        for i in range(len(self.config.blocks)):
            unit = getattr(self, f"l{i + 1}")
            h = (checkpoint(unit, h, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=_recompute_contexts)
                 if remat else unit(h))
        # mean over (T', V) then persons, in fp32 whatever the activations
        feat = h.shape[-1]
        h = h.float().reshape(n, m, -1, feat).mean(dim=2).mean(dim=1)
        if self.mesh is not None:
            # equal T' shards: the global mean is the mean of shard means
            h = comm.all_reduce_mean(h, self.mesh.time_group)
        return h @ self.fc.weight.t() + self.fc.bias


def _recompute_contexts():
    """(the first pass's context, the recomputation's): BN updates its
    running statistics in the first pass only."""
    return contextlib.nullcontext(), frozen_statistics()


def check_shift_range(named_tensors,
                      max_shift: int = temporal_shift.DEFAULT_MAX_SHIFT
                      ) -> None:
    """Raise if a ``*.ypos`` of (name, tensor) pairs (``named_parameters()``
    or a state_dict's items) reaches the tap radius ``max_shift`` (the
    model's lowering's); for weights that do not pass through
    ``load_state_dict``."""
    for name, param in named_tensors:
        if name.endswith(".ypos"):
            temporal_shift.assert_in_range(param, name, max_shift=max_shift)


def _check_shift_range(module: Model, incompatible) -> None:
    check_shift_range(module.named_parameters(), module.lowering.max_shift)


def config_from_reference_args(model_args: Dict[str, Any]) -> ModelConfig:
    """ModelConfig from reference-style YAML ``model_args`` (num_class /
    num_point / num_person / graph / in_channels), plus ``blocks``: rows of
    [in_channels, out_channels, stride, residual] replacing the default
    backbone, and ``lowering``, a dict of lowering knobs
    (``ops/lowering.py``)."""
    graph = get_graph(model_args.get("graph", "ntu_rgb_d"))
    kwargs: Dict[str, Any] = {}
    if "lowering" in model_args:
        kwargs["lowering"] = lowering_from_dict(model_args["lowering"])
    if "blocks" in model_args:
        kwargs["blocks"] = tuple(
            BlockSpec(int(b[0]), int(b[1]),
                      stride=int(b[2]) if len(b) > 2 else 1,
                      residual=bool(b[3]) if len(b) > 3 else True)
            for b in model_args["blocks"])
    return ModelConfig(
        num_class=model_args.get("num_class", 60),
        num_point=model_args.get("num_point", graph.num_nodes),
        num_person=model_args.get("num_person", 2),
        graph=graph.name,
        in_channels=model_args.get("in_channels", 3),
        **kwargs,
    )
