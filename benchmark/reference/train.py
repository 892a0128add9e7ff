"""The source's training step, in plain PyTorch on the reference model
of the configuration's family.

SGD with momentum 0.9 and nesterov, per-parameter weight decay from the
configuration's table (the first pattern a name contains wins), the
mean softmax cross-entropy of a batch, BN by batch statistics.  A
parameter moves by the gradient its family's reference gives it
(Shift-GCN's positions by the temporal shift's fixed step).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import FP32, Precision, forward, no_tf32


def weight_decay(name: str, table) -> float:
    return next(float(wd) for pattern, wd in table if pattern in name)


def steps(state: Dict[str, torch.Tensor], batches: List[tuple], config: dict,
          lr: float, device, prec: Precision = FP32,
          dtype: torch.dtype = torch.float32) -> dict:
    """Run len(batches) SGD steps from ``state`` (the benchmark's
    weights) on (clips, labels) numpy batches.  Returns the per-step
    losses, each leaf's norm of the first gradient as the optimizer took
    it (the momentum buffer after one step: g + wd * p), each leaf's raw
    first gradient norm, each leaf's norm of the change after the last
    step, and the first step's logits and labels.  ``dtype`` float64 gives a witness of the float32 run's
    own rounding."""
    from benchmark.weights import trainable

    params = {k: v.detach().to(device, dtype).clone().requires_grad_(True)
              for k, v in state.items()
              if v.is_floating_point() and trainable(k)}
    buffers = {k: v.detach().to(device, dtype)
               for k, v in state.items()
               if v.is_floating_point() and not trainable(k)}
    start = {k: p.detach().clone() for k, p in params.items()}
    groups: Dict[float, list] = {}
    for name, p in params.items():
        groups.setdefault(weight_decay(name, config["weight_decay_table"]),
                          []).append(p)
    train = config["train"]
    opt = torch.optim.SGD(
        [{"params": ps, "weight_decay": wd} for wd, ps in groups.items()],
        lr=lr, momentum=config["momentum"], nesterov=train["nesterov"])
    losses, first, raw = [], {}, {}
    with no_tf32():
        for i, (clips, labels) in enumerate(batches):
            opt.zero_grad(set_to_none=True)
            w = {**params, **buffers}
            x = torch.from_numpy(np.ascontiguousarray(clips, np.float32)).to(
                device, dtype)
            y = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
            logits = forward(w, x, config, True, prec)
            loss = F.cross_entropy(logits, y)
            if i == 0:
                first_logits = logits.detach().cpu().numpy()
            loss.backward()
            for name, p in params.items():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if i == 0:
                raw = {k: float(p.grad.norm()) for k, p in params.items()}
            opt.step()
            losses.append(float(loss.detach()))
            if i == 0:
                first = {k: float(opt.state[p]["momentum_buffer"].norm())
                         for k, p in params.items()}
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "first_grad": first, "raw_grad": raw,
            "change": change, "logits": first_logits,
            "labels": np.asarray(batches[0][1], np.int64)}
