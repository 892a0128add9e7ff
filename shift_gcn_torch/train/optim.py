"""SGD with the reference's per-parameter weight-decay table and its
per-epoch learning-rate schedule.

Reference (main.py:301-322): every parameter gets SGD momentum 0.9 +
nesterov with weight decay
    1e-3  if 'Linear_weight' is in the parameter name,
    0.0   if 'Mask' is in the parameter name,
    1e-4  otherwise (biases and BN parameters included: the reference's
          bias ``decay_mult`` is a key torch SGD ignores).

``torch.optim.SGD`` is the reference optimizer itself, first step
included (the momentum buffer starts as the first update d = g + wd * p).
The schedule is step decay with optional linear warmup, per epoch
(reference: main.py:342-353).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

MOMENTUM = 0.9


def weight_decay_for_name(name: str) -> float:
    """The reference's effective weight decay for a parameter name."""
    if "Linear_weight" in name:
        return 1e-3
    if "Mask" in name:
        return 0.0
    return 1e-4


def build_param_groups(model: torch.nn.Module) -> List[Dict]:
    """One SGD parameter group per weight-decay value, in the order the
    values first appear among the model's parameters."""
    groups: Dict[float, List[torch.nn.Parameter]] = {}
    for name, param in model.named_parameters():
        groups.setdefault(weight_decay_for_name(name), []).append(param)
    return [{"params": params, "weight_decay": wd}
            for wd, params in groups.items()]


def build_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.SGD:
    return torch.optim.SGD(build_param_groups(model), lr=lr,
                           momentum=MOMENTUM, nesterov=True)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_decay_lr(epoch: int, base_lr: float, steps: Sequence[int],
                  warm_up_epoch: int = 0) -> float:
    """Per-epoch LR (reference: main.py:342-353)."""
    if epoch < warm_up_epoch:
        return base_lr * (epoch + 1) / warm_up_epoch
    passed = sum(1 for s in steps if epoch >= s)
    return base_lr * (0.1 ** passed)
