"""Tensor parallelism: the output channels of the two pointwise products
sharded over the mesh's model ranks.

The counterpart of the reference package's ``param_spec`` and
``state_shardings`` (its ``parallel/mesh.py``) and of its trainer's
commit of the train state to them.  On a ``mesh_shape`` [D, M] with
M > 1 and no ``shard_time`` the rank at (d, m) holds, of every
parameter named in ``SHARDED_AXES``, output channels
[m C / M, (m + 1) C / M) as a tensor of its own, and the SGD momentum of
that slice:

- ``Linear_weight`` (C_in, C_out), the spatial product of K4: columns;
- ``temporal_linear.weight`` (C_out, C_in, 1, 1), the temporal 1x1:
  rows.

Everything else is replicated over the model ranks, as the reference's
``param_spec`` leaves it; a family without either parameter (ST-GCN,
ring-GNN) runs fully replicated over them.  ``seqpar.attach`` calls
``shard_`` on a built, initialized model.  The forward of each sharded
product computes the rank's slice of its output (K4 at its slice's first
global channel d0, its bias slice; the 1x1 on its rows) and gathers the
slices over the model ranks (``comm.gather_channels``); BN, the
residuals, ReLU and the temporal shifts run on the whole channels
between the gathers.  The backward of a gather hands each slice the
whole objective's cotangent, K5 and the 1x1 pass down this slice's part
of the input gradient, and ``Mesh.reduce_gradients`` sums the sharded
gradients over the data ranks and the rest over the world (a
replicated bias or gate gets its parts from each rank's slice there).

Checkpoints stay in the full reference layout: ``full_entry`` gathers a
rank's model and optimizer state over the model ranks (every rank calls
it: it is a collective), and ``local_state_dict`` /
``local_optimizer_state`` cut a full one down to a rank's slices.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional

import torch

# parameter name suffix -> its output-channel axis
SHARDED_AXES = (("Linear_weight", 1), ("temporal_linear.weight", 0))


def sharded_axis(name: str) -> Optional[int]:
    """The output-channel axis of a sharded parameter's (or its state_dict
    key's) ``name``, or None for a replicated one."""
    for suffix, axis in SHARDED_AXES:
        if name == suffix or name.endswith("." + suffix):
            return axis
    return None


def _uneven(widths: Iterable[int], model_ranks: int) -> List[int]:
    return sorted({w for w in widths if w % model_ranks})


def _refuse_uneven(uneven: List[int], model_ranks: int) -> None:
    # the reference's device_put refuses an uneven split too
    if uneven:
        raise ValueError(
            f"tensor parallelism over {model_ranks} model ranks needs "
            f"every sharded output width divisible by {model_ranks}: "
            f"{uneven} are not")


def check_config(family: str, model_args: Dict[str, Any],
                 model_ranks: int) -> None:
    """Raise unless the sharded layers of a model family's config split
    over the model ranks (a family without them takes any M)."""
    from shift_gcn_torch.models.registry import get_model

    found = get_model(family)
    if found.name == "shift_gcn":
        config = found.build_config(model_args)
        _refuse_uneven(_uneven((b.out_channels for b in config.blocks),
                               model_ranks), model_ranks)


def columns(mesh, local_width: int) -> slice:
    """This rank's channels of a sharded output, ``local_width`` a rank."""
    start = mesh.coords[1] * local_width
    return slice(start, start + local_width)


def _local(t: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    size = t.shape[axis] // mesh.model
    return t.narrow(axis, mesh.coords[1] * size, size).clone()


def shard_(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Cut every sharded parameter of ``model`` down to this rank's slice,
    in place (the same ``Parameter`` objects, so an optimizer built on
    the model keeps them); returns the model.  Initialize or load the
    full weights first."""
    params = [(name, p, sharded_axis(name))
              for name, p in model.named_parameters()]
    params = [(name, p, axis) for name, p, axis in params
              if axis is not None]
    _refuse_uneven(_uneven((p.shape[axis] for _, p, axis in params),
                           mesh.model), mesh.model)
    with torch.no_grad():
        for _, p, axis in params:
            p.data = _local(p.data, axis, mesh)
    return model


def local_state_dict(state_dict: Dict[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """A full state_dict with its sharded entries cut to this rank's
    slices."""
    return {k: _local(v, sharded_axis(k), mesh)
            if sharded_axis(k) is not None else v
            for k, v in state_dict.items()}


def _gather(t: torch.Tensor, axis: int, mesh) -> torch.Tensor:
    from shift_gcn_torch.parallel import comm

    return torch.cat(comm.all_gather(t.detach(), mesh.model_group),
                     axis).cpu()


def full_state_dict(model: torch.nn.Module, mesh
                    ) -> Dict[str, torch.Tensor]:
    """The model's state_dict on the CPU in the full reference layout,
    the sharded entries gathered over the model ranks (a collective)."""
    return {k: _gather(v, sharded_axis(k), mesh)
            if sharded_axis(k) is not None else v.detach().cpu()
            for k, v in model.state_dict().items()}


def _slot_names(model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> List[str]:
    """Parameter names in the optimizer's state_dict index order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups
            for p in group["params"]]


def _map_momentum(osd: Dict[str, Any], names: List[str], fn
                  ) -> Dict[str, Any]:
    out = copy.copy(osd)
    out["state"] = {}
    for index in sorted(osd["state"]):
        entry = dict(osd["state"][index])
        axis = sharded_axis(names[index])
        buf = entry.get("momentum_buffer")
        if axis is not None and buf is not None:
            entry["momentum_buffer"] = fn(buf, axis)
        out["state"][index] = entry
    return out


def full_entry(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               mesh) -> Dict[str, Any]:
    """The resume entry ``{model_state_dict, optimizer_state_dict}`` of a
    tensor-parallel rank in the full reference layout (a collective: every
    rank calls it)."""
    osd = optimizer.state_dict()
    return {"model_state_dict": full_state_dict(model, mesh),
            "optimizer_state_dict": _map_momentum(
                osd, _slot_names(model, optimizer),
                lambda buf, axis: _gather(buf, axis, mesh))}


def local_optimizer_state(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer,
                          osd: Dict[str, Any], mesh) -> Dict[str, Any]:
    """A full optimizer state_dict with the sharded parameters' momentum
    cut to this rank's slices, to load into ``optimizer``."""
    return _map_momentum(osd, _slot_names(model, optimizer),
                         lambda buf, axis: _local(buf, axis, mesh))
