"""Serving artifacts: the eval forward exported with ``torch.export``.

The reference package serves from StableHLO artifacts that need no model
code on the serving host.  A ``torch.export`` artifact (``.pt2``) names the
two forward kernels as registered operators (``shift_gcn_torch::
temporal_shift`` and ``shift_gcn_torch::shift_gcn``, ``ops/library.py``):
its graph holds one op node per kernel launch and no plain-version
decomposition of them, so running it on the card launches K1 and K4.  The
serving host therefore needs ``shift_gcn_torch.ops`` (the operators and
the kernel sources they build), which ``load_exported`` imports, but not
the model code or its config: that replaces the reference's "no model
code on the serving host" contract.

Two flavours:
- ``export_eval``: parameters and buffers are inputs, a dict by
  state_dict name before the clip batch, so one artifact serves any
  checkpoint of the architecture (weights hot-swap at call time);
- ``export_eval_baked``: the weights live inside the artifact, whose
  only input is the clip batch: one self-contained file.

An artifact records the device it was exported for (its clip input's
device); ``serve.score_clips`` refuses to run it on any other device
rather than moving it.  Weights that reach an artifact without passing
through ``Model.load_state_dict`` (``restore_weights_for_artifact``,
``serve.score_clips``) get its load-time shift range check all the same,
at the ``max_shift`` the caller gives (an artifact holds no lowering:
the model config's ``lowering.max_shift``, 8 by default).

CLI: ``python -m shift_gcn_torch.inference.export --checkpoint <.pt or run
dir> --out model.pt2 [--baked] [--device cuda]``.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils import _pytree as pytree

from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models.shift_gcn import (
    Model, ModelConfig, check_shift_range)
from shift_gcn_torch.ops.lowering import Lowering
from shift_gcn_torch.ops.temporal_shift import DEFAULT_MAX_SHIFT
from shift_gcn_torch.utils.checkpoint import (
    latest_checkpoint, load_reference_checkpoint)
from shift_gcn_torch.utils.device import resolve_device

Weights = Dict[str, torch.Tensor]


def default_config() -> ModelConfig:
    """The MediaPipe fall model."""
    return ModelConfig(num_class=2, num_point=33, num_person=1,
                       graph="mediapipe_pose")


class _WeightsAsInputs(nn.Module):
    """forward(weights, x): the eval forward of a ``Model`` of ``config``
    with ``weights`` (a full state_dict) in place of its own."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        # the structure only, on the meta device, and kept out of the
        # registered children so that the export lifts no weights of its own
        self._structure = [Model(config, device="meta")]

    def forward(self, weights: Weights, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self._structure[0], weights, (x,))


def _clips(config: ModelConfig, batch_size: int, seq_len: int,
           device: torch.device) -> torch.Tensor:
    return torch.zeros((batch_size, config.in_channels, seq_len,
                        config.num_point, config.num_person), device=device)


def _serialize(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _check_weights(weights: Weights, specs: Dict[str, torch.Tensor],
                   max_shift: int) -> None:
    """Raise unless ``weights`` has exactly the names of ``specs``, each of
    its shape, and every shift position inside the tap radius
    ``max_shift``."""
    missing = sorted(set(specs) - set(weights))
    unexpected = sorted(set(weights) - set(specs))
    if missing or unexpected:
        raise ValueError(f"weights do not fit the architecture: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    for name, spec in specs.items():
        if tuple(weights[name].shape) != tuple(spec.shape):
            raise ValueError(f"{name}: shape {tuple(weights[name].shape)} "
                             f"!= {tuple(spec.shape)}")
    check_shift_range(weights.items(), max_shift)


def export_eval(state_dict: Weights, config: ModelConfig, batch_size: int,
                seq_len: int = 300, device="cuda") -> bytes:
    """Serialize the eval forward with the parameters and buffers as
    inputs: ``module()(weights, x)``, ``weights`` a state_dict of the
    architecture.  ``state_dict`` gives the inputs' shapes and dtypes."""
    device = resolve_device(device)
    wrapper = _WeightsAsInputs(config)
    structure = wrapper._structure[0]
    _check_weights(state_dict, structure.state_dict(),
                   structure.lowering.max_shift)
    weights = {k: v.to(device) for k, v in state_dict.items()}
    program = torch.export.export(
        wrapper, (weights, _clips(config, batch_size, seq_len, device)),
        strict=False)
    return _serialize(program)


def export_eval_baked(state_dict: Weights, config: ModelConfig,
                      batch_size: int, seq_len: int = 300,
                      device="cuda") -> bytes:
    """Serialize the eval forward with the weights inside the artifact:
    ``module()(x)``."""
    device = resolve_device(device)
    model = Model(config, device=device)
    model.load_state_dict(state_dict, strict=True)
    program = torch.export.export(
        model, (_clips(config, batch_size, seq_len, device),), strict=False)
    return _serialize(program)


def load_exported(source: Union[str, bytes]):
    """Load an artifact from a ``.pt2`` path or its bytes; returns the
    ``torch.export.ExportedProgram`` (call ``.module()``).  This module
    imports ``shift_gcn_torch.ops``, which registers the kernels'
    operators the graph names."""
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    return torch.export.load(source)


def _user_inputs(artifact):
    """The artifact's call arguments as fake tensors: ``(weights, x)`` or
    ``(x,)``."""
    values = {node.name: node.meta["val"] for node in artifact.graph.nodes
              if node.op == "placeholder"}
    leaves = [values[name] for name in artifact.graph_signature.user_inputs]
    args, _ = pytree.tree_unflatten(leaves, artifact.call_spec.in_spec)
    return args


def artifact_is_baked(artifact) -> bool:
    """Baked artifacts take exactly one input (the clip batch)."""
    return len(artifact.graph_signature.user_inputs) == 1


def weight_specs(artifact) -> Dict[str, torch.Tensor]:
    """name -> fake tensor (shape, dtype, device) of each weight input of a
    params-as-inputs artifact, in the artifact's order."""
    args = _user_inputs(artifact)
    if len(args) != 2:
        raise ValueError("artifact does not take (weights, x) inputs: "
                         "baked artifacts need no weights")
    return dict(args[0])


def artifact_device(artifact) -> torch.device:
    """The device the artifact was exported for (its clip input's)."""
    return _user_inputs(artifact)[-1].device


def check_artifact_device(artifact, device: torch.device) -> None:
    """Raise unless ``device`` is the one the artifact was exported for;
    an artifact is never moved to another device."""
    want = artifact_device(artifact)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if want != device:
        raise ValueError(f"the artifact was exported for {want}; it does "
                         f"not run on {device} (export it again there)")


def _checkpoint_file(path: str) -> str:
    """A checkpoint file, or the newest ``<name>-<epoch>-<step>.pt`` of a
    run dir."""
    if os.path.isdir(path):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        return latest
    return path


def restore_eval_weights(checkpoint_path: str,
                         config: Optional[ModelConfig] = None) -> Weights:
    """The state_dict of the port's or the reference's ``.pt`` / ``.pkl``
    checkpoint (or of a run dir's newest), checked against ``config``
    (default: the MediaPipe fall model) by ``Model.load_state_dict``:
    names, shapes and the shift range."""
    state_dict, _ = load_reference_checkpoint(_checkpoint_file(
        checkpoint_path))
    model = Model(config or default_config(), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.state_dict()


def restore_weights_for_artifact(checkpoint_path: str, artifact,
                                 max_shift: int = DEFAULT_MAX_SHIFT
                                 ) -> Weights:
    """Weights for a params-as-inputs artifact, with the artifact's own
    inputs as the template: any architecture serves without its config.
    Raises on a name or shape that does not fit and on a shift position
    at the tap radius ``max_shift`` (the model's lowering's); returns them
    in the artifact's order, dtypes and device."""
    specs = weight_specs(artifact)
    state_dict, _ = load_reference_checkpoint(_checkpoint_file(
        checkpoint_path))
    _check_weights(state_dict, specs, max_shift)
    return {name: state_dict[name].to(dtype=spec.dtype, device=spec.device)
            for name, spec in specs.items()}


def export_checkpoint(
    checkpoint_path: str,
    out_path: str,
    *,
    config: Optional[ModelConfig] = None,
    batch_size: int = 64,
    seq_len: int = 300,
    baked: bool = False,
    device="cuda",
) -> str:
    """Load a checkpoint (or a run dir's newest) and write a ``.pt2``
    artifact for ``device``.  The default flavour takes the weights as
    inputs; ``baked=True`` writes the self-contained one."""
    config = config or default_config()
    state_dict = restore_eval_weights(checkpoint_path, config)
    exporter = export_eval_baked if baked else export_eval
    blob = exporter(state_dict, config, batch_size, seq_len, device=device)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="export a checkpoint to a torch.export serving "
        "artifact (.pt2)")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=300)
    parser.add_argument(
        "--baked", action="store_true", default=False,
        help="put the weights inside the artifact: one self-contained "
        "file whose only input is the clip batch")
    parser.add_argument("--no-baked", dest="baked", action="store_false",
                        help="(default) weights-as-inputs artifact")
    parser.add_argument("--num-class", type=int, default=2)
    parser.add_argument("--num-point", type=int, default=None,
                        help="joints (default: the graph's joint count)")
    parser.add_argument("--num-person", type=int, default=1)
    parser.add_argument("--graph", default="mediapipe_pose")
    parser.add_argument("--max-shift", type=int, default=DEFAULT_MAX_SHIFT,
                        help="the model's tap radius (lowering.max_shift)")
    parser.add_argument("--device", default="cuda",
                        help="the device the artifact runs on (default "
                        "cuda)")
    args = parser.parse_args(argv)
    config = ModelConfig(
        num_class=args.num_class,
        num_point=args.num_point or get_graph(args.graph).num_nodes,
        num_person=args.num_person, graph=args.graph,
        lowering=Lowering(max_shift=args.max_shift))
    out = export_checkpoint(
        args.checkpoint, args.out, config=config,
        batch_size=args.batch_size, seq_len=args.seq_len, baked=args.baked,
        device=args.device)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
