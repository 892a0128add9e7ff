"""A model's weights made from the seed, on the device, in two draws.

The names, shapes and initialization of each entry are the
configuration's family's (``families/<family>.py`` ``leaves``): those of
the source repository's ``state_dict``, which the port loads as they are
and the reference reads.  Every drawn leaf is a slice of one normal and
one uniform draw of a ``torch.Generator`` on the device, in the order of
the family's leaves, scaled as the family says; a leaf of another kind
than these and the constant ones comes from the family's ``fill``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import families

# (name, shape, kind, scale): kind 'normal' (std scale), 'uniform'
# (bound scale), 'ones', 'zeros', or 'count' (num_batches_tracked)
Leaf = Tuple[str, tuple, str, float]


def bn_leaves(prefix: str, n: int) -> List[Leaf]:
    """A BN's entries, the identity: weight 1, bias 0, running mean 0 and
    variance 1."""
    return [(f"{prefix}.weight", (n,), "ones", 0.0),
            (f"{prefix}.bias", (n,), "zeros", 0.0),
            (f"{prefix}.running_mean", (n,), "zeros", 0.0),
            (f"{prefix}.running_var", (n,), "ones", 0.0),
            (f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def leaves(config: dict) -> List[Leaf]:
    """The state-dict entries of the configuration's family's model."""
    return families.of(config).leaves(config)


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of one model from ``seed``, on ``device``."""
    specs = leaves(config)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = {kind: sum(math.prod(shape) for _, shape, k, _ in specs
                       if k == kind) for kind in ("normal", "uniform")}
    draws = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device) * 2 - 1}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind in draws:
            at = offsets[kind]
            offsets[kind] = at + n
            out[name] = (draws[kind][at:at + n] * scale).reshape(shape)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            out[name] = torch.from_numpy(families.of(config).fill(
                kind, shape, config)).to(device)
    return out


def trainable(name: str) -> bool:
    """Whether a state-dict entry is a parameter (not a BN buffer or an
    index table, such as Shift-GCN's shift indices)."""
    last = name.rsplit(".", 1)[-1]
    return last not in ("running_mean", "running_var", "num_batches_tracked",
                        "shift_in", "shift_out")


def load_into(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``model``'s parameters and buffers in place
    (the model keeps its own tensors, which optimizers hold)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"weights lack {missing[:5]}")
    with torch.no_grad():
        for name, tensor in own.items():
            tensor.copy_(state[name])
