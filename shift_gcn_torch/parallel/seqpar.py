"""Data, sequence and tensor parallelism of a model: its collectives
attached, and the train and eval steps over a mesh.

The counterpart of the reference package's ``parallel/seqpar.py`` and of
its data-parallel ``jit`` over a batch sharded on 'data'.  Each rank runs
the model on its rows of the batch and, under ``shard_time``, on its
frames of every clip (sequence parallelism: T over the mesh's 'model'
axis).  ``attach`` wires the collectives in:

- every BN normalizes by statistics averaged over all ranks (sync BN:
  E[x] and E[x^2] in fp32, the count times the world size for the
  running variance), as the reference's global-batch BN does;
- every temporal shift reduces its raw position gradient over the world
  before the constraint step; under ``shard_time`` it runs on the
  halo-extended block (``halo.py``);
- under ``shard_time`` the final temporal pooling is averaged over the
  time ranks (``comm.all_reduce_mean``), so every time rank of a data
  shard holds the shard's logits;
- on a tensor-parallel mesh (``Mesh.tensor_parallel``: M > 1 without
  ``shard_time``) the sharded parameters are cut to the rank's slices
  and their products gather their outputs (``parallel/tensor.py``), and
  every BN averages its statistics over the data ranks alone, with the
  count times D: the model ranks hold the same rows, and a world group
  would count each row M times in the unbiased running variance.

The objective all ranks share is the sum of the data shards' mean
losses, each counted once.  The M model ranks of a data shard hold the
same loss, so each back-propagates 1/M of it (``state.train_step``):
the classifier, which every time rank runs whole, gets 1/M of its
gradient on each, and the pooling's backward, the mean of the M
cotangents, hands each time rank 1/M of the shard's.  A pooling whose
backward summed the time ranks' cotangents of an unscaled loss would
multiply every gradient below it by M.  The mean-loss gradient is then
the sum of the ranks' gradients over D (``Mesh.reduce_gradients``); the
constraint's steps are reduced on their own (``reduce_position_grad``)
and are not summed again.  Under tensor parallelism the same holds with
each rank's gradients its parts of the data shard's: 1/M of the
replicated layers' above the last gather, and below a gather the part
that flows through its slice (``comm.gather_channels``); the sharded
slices, whole on their rank, are summed over the data ranks alone.

Shapes (``validate_time_sharding``, the reference's rule): T divisible
by the time ranks, every block's local T divisible by its stride, and at
least ``max_shift + 1`` frames per rank at every block.  T=300 does not
shard 2-way under the default backbone; the feeder's ``pad_to_frames:
304`` makes it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from shift_gcn_torch.ops.batchnorm import BatchNorm
from shift_gcn_torch.parallel import tensor
from shift_gcn_torch.parallel.mesh import Mesh
from shift_gcn_torch.train import state as state_lib


def validate_time_sharding(config, t: int, n_shards: int,
                           max_shift: int) -> None:
    """Raise where a T-sharded forward would differ from the unsharded
    one: T not divisible by the shards, a block whose local T is not
    divisible by its stride, or fewer than ``max_shift + 1`` local
    frames at a block (``max_shift`` from the model's lowering)."""
    if t % n_shards != 0:
        raise ValueError(
            f"shard_time: T={t} is not divisible by {n_shards} time shards")
    t_local = t // n_shards
    for i, spec in enumerate(config.blocks):
        if t_local < max_shift + 1:
            raise ValueError(
                f"shard_time: block l{i + 1} sees T_local={t_local} < "
                f"max_shift+1={max_shift + 1}; use fewer shards, a longer "
                "T, or lower lowering.max_shift")
        if t_local % spec.stride != 0:
            raise ValueError(
                f"shard_time: block l{i + 1} (stride {spec.stride}) sees "
                f"T_local={t_local}, which is not divisible: the local "
                "downsample would drop frames and diverge from the "
                "unsharded model; pad T so T/shards stays divisible by "
                "every stride product")
        t_local //= spec.stride


def attach(model: torch.nn.Module, mesh: Mesh,
           shard_time: bool = False) -> torch.nn.Module:
    """Wire ``mesh``'s collectives into ``model`` (see the module
    docstring), and on a tensor-parallel mesh cut its sharded parameters
    to this rank's slices (``tensor.shard_``: attach the initialized or
    loaded model, then load only sliced weights); returns the model.
    ``shard_time`` needs a model with temporal shifts (Shift-GCN) and
    k=1 residual convs."""
    from shift_gcn_torch.models import shift_gcn

    if shard_time and not isinstance(model, shift_gcn.Model):
        raise ValueError(
            f"shard_time is not supported by {type(model).__module__}: "
            "only the Shift-GCN family runs T-sharded")
    tp = mesh.tensor_parallel
    if tp and shard_time:
        raise ValueError("shard_time needs a mesh whose model ranks hold "
                         "T shards, not a tensor-parallel one")
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.group = mesh.data_group if tp else mesh.world_group
        if tp and isinstance(module, shift_gcn.ShiftGCN):
            module.mesh = mesh
        if isinstance(module, shift_gcn.ShiftTCN):
            module.mesh = mesh
            module.shard_time = shard_time
        if (shard_time and isinstance(module, shift_gcn.ResidualTCN)
                and module.conv.weight.shape[2] != 1):
            raise ValueError(
                "time-sharded apply supports only k=1 residual convs "
                "(k>1 would need its own halo exchange)")
    if isinstance(model, shift_gcn.Model):
        model.mesh = mesh if shard_time else None
    if tp:
        tensor.shard_(model, mesh)
    return model


def check_batch(model: torch.nn.Module, t: int, mesh: Mesh,
                shard_time: bool) -> None:
    """validate_time_sharding for the model's blocks and lowering."""
    if shard_time:
        validate_time_sharding(model.config, t, mesh.model,
                               model.lowering.max_shift)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], lr: float, mesh: Mesh,
               shard_time: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SGD step of the global ``batch`` (every rank passes the whole
    batch its feeder gave; it takes its rows and frames): the contract of
    the reference's ``make_time_sharded_train_step``.  Returns the world
    mean (loss, acc)."""
    check_batch(model, batch["data"].shape[2], mesh, shard_time)
    local = {"data": mesh.local(batch["data"], shard_time),
             "label": batch["label"][mesh.batch_rows(
                 batch["label"].shape[0])]}
    return state_lib.train_step(model, optimizer, local, lr, mesh=mesh)


def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
              mesh: Mesh, shard_time: bool = False
              ) -> Tuple[np.ndarray, float, float]:
    """(logits of the whole batch, masked NLL sum, mask sum) on every
    rank: the contract of ``make_time_sharded_eval_step``.  Each data
    rank scores its rows; the logits are gathered in data-rank order."""
    check_batch(model, batch["data"].shape[2], mesh, shard_time)
    rows = mesh.batch_rows(batch["data"].shape[0])
    local = {"data": mesh.local(batch["data"], shard_time),
             "label": batch["label"][rows]}
    if "mask" in batch:
        local["mask"] = batch["mask"][rows]
    logits, loss_sum, n = state_lib.eval_step(model, local)
    logits, sums = mesh.gather_rows([
        logits.float().cpu().numpy(),
        np.asarray([[float(loss_sum), float(n)]])])
    return logits, float(sums[:, 0].sum()), float(sums[:, 1].sum())
