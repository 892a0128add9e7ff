"""The two forward kernels as registered torch operators.

The raw launchers hand data pointers to ``ctypes``, so no tracer can see
through them: ``torch.export`` of the model would fail on the card and,
on the CPU, record the plain versions' ``aten`` operations, which an
artifact would then run on the card in place of the kernels.  Here K1 and
K4 are ``torch.library.custom_op``s:

- ``shift_gcn_torch::temporal_shift(x, ypos, stride)``: K1,
  (N, T, V, C) -> (N, T // stride, V, C);
- ``shift_gcn_torch::shift_gcn(x, gate, w, bias, d0=0)``: K4,
  (R, V, C) -> (R, V, D), output channels [d0, d0 + D) of the layer
  (``d0`` is nonzero only on a tensor-parallel rank; a graph exported
  without it records the default).

Each runs its raw launcher (``temporal_shift.temporal_shift_forward``,
``shift_gcn_kernel.shift_gcn_forward``), the one launch site of its
kernel: the kernel on a CUDA tensor, the plain version on a CPU tensor.
Each has a fake implementation that gives a tracer the output's shape,
dtype and device, so an exported graph holds one op node per kernel
launch, and running the graph launches the kernels (and counts them in
``kernels.LAUNCHES``) on the device it holds.

The ops carry no autograd formula: called where autograd records them,
their backward raises.  Training reaches them through
``TemporalShiftFunction`` and ``FusedShiftGCNFunction``, whose forwards
call these ops (grad mode is off inside an op and inside a Function's
forward, so the launchers' ``refuse_grad`` check holds) and whose
backwards launch the backward kernels.

Importing ``shift_gcn_torch.ops`` registers both ops; loading an exported
artifact needs that import.
"""

from __future__ import annotations

import torch

from shift_gcn_torch.ops import shift_gcn_kernel, temporal_shift as tshift


@torch.library.custom_op("shift_gcn_torch::temporal_shift", mutates_args=())
def temporal_shift(x: torch.Tensor, ypos: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """K1: (N, T, V, C) -> (N, T // stride, V, C) in x.dtype."""
    return tshift.temporal_shift_forward(x, ypos, stride)


@temporal_shift.register_fake
def _temporal_shift_fake(x, ypos, stride):
    n, t, v, c = x.shape
    return x.new_empty((n, t // stride, v, c))


@torch.library.custom_op("shift_gcn_torch::shift_gcn", mutates_args=())
def shift_gcn(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, d0: int = 0) -> torch.Tensor:
    """K4: x (R, V, C), gate (V, C), w (C, D), bias (D,) -> (R, V, D) in
    x.dtype, output channels [d0, d0 + D) of the layer."""
    return shift_gcn_kernel.shift_gcn_forward(x, gate, w, bias, d0)


@shift_gcn.register_fake
def _shift_gcn_fake(x, gate, w, bias, d0=0):
    r, v, _ = x.shape
    return x.new_empty((r, v, w.shape[-1]))
