"""Loss, train step and eval step.

``train_step`` runs the model in training mode (batch-statistic BN, the
kernel ops through their autograd Functions), backpropagates the mean
cross-entropy and takes one SGD step at the given learning rate.
``eval_step`` runs it in eval mode (running BN statistics) and returns
the logits with the masked NLL sum, so padded samples of the last batch
drop out of the mean (reference: main.py:259, 493-515).

Under a mesh (``parallel/``) a rank passes its own rows (and frames) to
``train_step`` with the mesh: it back-propagates its data shard's loss
over the M model ranks that hold the same loss (time ranks under
sequence parallelism, channel ranks under tensor parallelism, edge or
node ranks under the edge partition), so that
the ranks' parts add up to the sum of the shards' losses
(``parallel/seqpar.py``); the gradients are reduced over the ranks
before the SGD step (``Mesh.reduce_gradients``: a tensor-parallel
slice over the data ranks, the rest over the world), and the loss and
accuracy returned are their means over the ranks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from shift_gcn_torch.train.optim import set_lr


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy (nn.CrossEntropyLoss), or its mean over
    the samples where ``mask`` is 1."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], lr: float,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step; returns (loss, acc) as device scalars."""
    model.train()
    set_lr(optimizer, lr)
    optimizer.zero_grad(set_to_none=True)
    logits = model(batch["data"])
    loss = cross_entropy(logits, batch["label"])
    (loss if mesh is None else loss / mesh.model).backward()
    if mesh is not None:
        mesh.reduce_gradients(model.named_parameters())
    optimizer.step()
    acc = (logits.argmax(-1) == batch["label"]).float().mean()
    if mesh is not None:
        loss, acc = mesh.mean_over_world(torch.stack([loss.detach(), acc]))
    return loss.detach(), acc.detach()


def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logits, masked NLL sum, mask sum) in eval mode, without grad."""
    model.eval()
    with torch.no_grad():
        logits = model(batch["data"])
        mask = batch.get("mask")
        nll = _nll(logits, batch["label"])
        if mask is None:
            mask = torch.ones_like(nll)
        return logits, (nll * mask).sum(), mask.sum()
