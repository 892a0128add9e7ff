"""Shift-GCN weights made from the seed, on the device, in two draws.

The names and shapes are those of the source repository's ``state_dict``
(Shift-GCN's ``Model``), which the port loads as they are and the
reference reads.  Every leaf is a slice of one normal and one uniform
draw of a ``torch.Generator`` on the device, scaled to the source's
initialization: 1x1 convs kaiming-normal over fan-out, the spatial
weight N(0, 1/D), the classifier N(0, 2/classes), shift positions
U(-1, 1), conv biases U(+-1/sqrt(fan_in)).  The feature masks are drawn
N(0, 0.5) rather than left at zero, so that the gate does work; biases
that feed a BN start at zero and BN is the identity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, kind, scale): kind 'normal' (std scale), 'uniform'
# (bound scale), 'ones', 'zeros', or 'count' (num_batches_tracked)
Leaf = Tuple[str, tuple, str, float]


def _bn(prefix: str, n: int) -> List[Leaf]:
    return [(f"{prefix}.weight", (n,), "ones", 0.0),
            (f"{prefix}.bias", (n,), "zeros", 0.0),
            (f"{prefix}.running_mean", (n,), "zeros", 0.0),
            (f"{prefix}.running_var", (n,), "ones", 0.0),
            (f"{prefix}.num_batches_tracked", (), "count", 0.0)]


def units(config: dict):
    """(index, cin, cout, stride, residual kind) of each unit."""
    for i, (cin, cout, stride, residual) in enumerate(config["backbone"]):
        kind = ("none" if not residual else
                "conv" if (cin != cout or stride != 1) else "identity")
        yield i + 1, int(cin), int(cout), int(stride), kind


def leaves(config: dict) -> List[Leaf]:
    args = config["model_args"]
    v, m = args["num_point"], args["num_person"]
    c_in, ncls = config["in_channels"], args["num_class"]
    out: List[Leaf] = _bn("data_bn", m * v * c_in)
    feat = c_in
    for i, cin, cout, stride, kind in units(config):
        p = f"l{i}"
        out += [(f"{p}.gcn1.Linear_weight", (cin, cout), "normal",
                 math.sqrt(1.0 / cout)),
                (f"{p}.gcn1.Linear_bias", (1, 1, cout), "zeros", 0.0),
                (f"{p}.gcn1.Feature_Mask", (1, v, cin), "normal", 0.5),
                (f"{p}.gcn1.shift_in", (v * cin,), "shift_in", 0.0),
                (f"{p}.gcn1.shift_out", (v * cout,), "shift_out", 0.0)]
        out += _bn(f"{p}.gcn1.bn", v * cout)
        if cin != cout:
            out += [(f"{p}.gcn1.down.0.weight", (cout, cin, 1, 1), "normal",
                     math.sqrt(2.0 / cout)),
                    (f"{p}.gcn1.down.0.bias", (cout,), "zeros", 0.0)]
            out += _bn(f"{p}.gcn1.down.1", cout)
        out += _bn(f"{p}.tcn1.bn", cout) + _bn(f"{p}.tcn1.bn2", cout)
        for s in ("shift_in", "shift_out"):
            out += [(f"{p}.tcn1.{s}.xpos", (cout,), "uniform", 1e-8),
                    (f"{p}.tcn1.{s}.ypos", (cout,), "uniform", 1.0)]
        out += [(f"{p}.tcn1.temporal_linear.weight", (cout, cout, 1, 1),
                 "normal", math.sqrt(2.0 / cout)),
                (f"{p}.tcn1.temporal_linear.bias", (cout,), "uniform",
                 1.0 / math.sqrt(cout))]
        if kind == "conv":
            out += [(f"{p}.residual.conv.weight", (cout, cin, 1, 1),
                     "normal", math.sqrt(2.0 / cout)),
                    (f"{p}.residual.conv.bias", (cout,), "zeros", 0.0)]
            out += _bn(f"{p}.residual.bn", cout)
        feat = cout
    out += [("fc.weight", (ncls, feat), "normal", math.sqrt(2.0 / ncls)),
            ("fc.bias", (ncls,), "uniform", 1.0 / math.sqrt(feat))]
    return out


def flat_shift_index(v: int, c: int, direction: int) -> np.ndarray:
    """The source's flat (V*C) index of the spatial shift:
    out[i*C + j] = x[(i*C + j + direction*j*C) mod V*C]."""
    i = np.arange(v)[:, None]
    j = np.arange(c)[None, :]
    return ((i * c + j + direction * j * c) % (c * v)).reshape(-1)


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
    v = config["model_args"]["num_point"]
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
            c = shape[0] // v
            out[name] = torch.from_numpy(flat_shift_index(
                v, c, 1 if kind == "shift_in" else -1)).to(device)
    return out


def trainable(name: str) -> bool:
    """Whether a state-dict entry is a parameter (not a BN buffer or a
    shift index)."""
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
