"""Four-stream training: the joint, bone, joint-motion and bone-motion
models trained in one run from the joint data alone.

A port of the reference package's ``train/fourstream.py``:

- the bone and motion streams are derived on the device from the joint
  batch (``derive_modalities_device``), the same arithmetic as the
  offline generators (``data/modalities.py``), so only the joint dataset
  is read;
- a train step runs the four streams one after another, each through
  ``state.train_step`` on its own model, optimizer and derived batch
  with the shared labels, as the reference's default ``mode="scan"``
  (``lax.map``) does: one stream's activations are live at a time, so a
  four-stream step needs a single-stream step's memory.  The reference's
  ``mode="vmap"`` is not ported: its trainer never selects it, and it is
  a batching choice of the compiler, not another result;
- an eval step returns every stream's logits and their ensemble, the
  ``ENSEMBLE_ALPHAS``-weighted sum of raw logits (reference
  ensemble_mediapipe.py:20-27).

Initialization: ``create_models`` draws the four models one after
another, in ``STREAMS`` order, from one ``torch.Generator`` seeded with
the run's seed, so the joint stream starts where a single-stream run at
that seed starts.  The reference package splits its key into four
instead; the parity tests carry weights across and depend on neither.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from shift_gcn_torch.ensemble import DEFAULT_ALPHA
from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
from shift_gcn_torch.train import state as state_lib

STREAMS = ("joint", "bone", "joint_motion", "bone_motion")
ENSEMBLE_ALPHAS = DEFAULT_ALPHA


def derive_modalities_device(joint: torch.Tensor,
                             parents) -> torch.Tensor:
    """(N, C, T, V, M) joint batch -> (4, N, C, T, V, M) stacked streams.

    Bone is the parent difference over the skeleton's spanning tree
    (roots are their own parent, so their bone is zero); motion is the
    forward frame difference with the last frame zeroed (reference:
    gen_bone_data_mediapipe.py:47-67, gen_motion_data.py:16-31).
    ``parents``: (V,) parent indices, best a tensor already on the
    batch's device (a host array is copied there on every call).
    """
    parents = torch.as_tensor(parents, device=joint.device)
    bone = joint - joint.index_select(3, parents)

    def motion(x: torch.Tensor) -> torch.Tensor:
        d = x[:, :, 1:] - x[:, :, :-1]
        return torch.cat([d, torch.zeros_like(x[:, :, :1])], dim=2)

    return torch.stack([joint, bone, motion(joint), motion(bone)])


def create_models(config: ModelConfig, seed: int, device="cuda",
                  build=Model) -> Dict[str, torch.nn.Module]:
    """The four stream models of ``build(config, device=...)`` (a model
    family's constructor, Shift-GCN's by default), initialized in STREAMS
    order from one generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {stream: build(config, device=device).init_weights(gen)
            for stream in STREAMS}


def train_step(models: Dict[str, Model],
               optimizers: Dict[str, torch.optim.Optimizer],
               batch: Dict[str, torch.Tensor], lr: float,
               parents, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of every stream on the joint batch ``batch["data"]``
    (this rank's rows under a data-parallel ``mesh``, whose reductions
    each stream's step runs); returns the (4,) losses and accuracies as
    device tensors."""
    data4 = derive_modalities_device(batch["data"], parents)
    losses, accs = [], []
    for i, stream in enumerate(STREAMS):
        loss, acc = state_lib.train_step(
            models[stream], optimizers[stream],
            {"data": data4[i], "label": batch["label"]}, lr, mesh=mesh)
        losses.append(loss)
        accs.append(acc)
    return torch.stack(losses), torch.stack(accs)


def eval_step(models: Dict[str, Model], batch: Dict[str, torch.Tensor],
              parents) -> Tuple[torch.Tensor, ...]:
    """(logits (4, N, K), ensemble (N, K), masked NLL sums (4,), mask
    sums (4,)) in eval mode."""
    data4 = derive_modalities_device(batch["data"], parents)
    outs = [state_lib.eval_step(models[stream], dict(batch, data=data4[i]))
            for i, stream in enumerate(STREAMS)]
    logits4, loss_sums, ns = (torch.stack(x) for x in zip(*outs))
    ensemble = sum(a * logits for a, logits in zip(ENSEMBLE_ALPHAS, logits4))
    return logits4, ensemble, loss_sums, ns
