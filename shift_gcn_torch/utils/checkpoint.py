"""Checkpoints: weight carry-over into the port's ``Model`` and the
trainer's resume files.

Two sources:

- ``state_dict_from_arrays(params, bn_state)``: nested dicts of numpy
  arrays in the reference package's parameter layout (the structure of
  its ``init_params``: ``down.conv`` / ``down.bn``, no shift index
  buffers) -> the reference-named torch ``state_dict``.
- ``load_reference_checkpoint(path)``: a reference ``.pt`` / ``.pkl``
  checkpoint (a bare state_dict or the full resume dict).

The trainer writes ``save_checkpoint``: a ``torch.save`` of the reference
resume dict ``{model_state_dict, optimizer_state_dict, epoch, global_step,
best_acc}`` named ``<Experiment_name>-<epoch>-<global_step>.pt``
(reference: main.py:436-448), which ``load_reference_checkpoint`` reads
back; ``latest_checkpoint`` finds the newest one.  A four-stream run
writes ``save_fourstream_checkpoint`` under the same name: one
``{model_state_dict, optimizer_state_dict}`` dict under each stream's
name beside ``epoch``, ``global_step`` and ``best_acc``, read back by
``load_fourstream_checkpoint``.  ``stream_state_dicts_from_arrays``
splits the reference package's stacked four-stream parameter trees into
one state_dict per stream.  ``resume_entry`` and ``write_checkpoint``
are the two halves of a save, for a caller that builds the entries
itself (a tensor-parallel trainer gathers them first,
``parallel/tensor.py``, and the files keep the full layout).

Orbax checkpoints of the reference package's trainer are not read here:
reading them needs orbax and its array library.  Export one to a ``.pt``
first with the reference package's checkpoint CLI.
"""

from __future__ import annotations

import os
import pickle
import re
import secrets
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from shift_gcn_torch.ops.spatial_shift import flat_shift_index


def state_dict_from_arrays(
    params: Mapping[str, Any], bn_state: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """Flatten (params, bn_state) into a reference-named torch state_dict.

    Translations, so the result loads into ``Model`` (and the reference
    torch model) strictly:
      - gcn ``down.conv`` / ``down.bn`` -> Sequential ``down.0`` / ``down.1``;
      - BN ``num_batches_tracked`` becomes int64, as torch keeps it;
      - each Shift_gcn block's ``shift_in`` / ``shift_out`` index buffers
        are regenerated from its (V, C_in, C_out): they are fixed
        functions of shape and the parameter trees do not carry them.
    """
    flat: Dict[str, np.ndarray] = {}

    def walk(tree: Mapping[str, Any], prefix: str = "") -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params)
    walk(bn_state)

    out: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        parts = key.split(".")
        if "down" in parts:
            i = parts.index("down")
            if i + 1 < len(parts) and parts[i + 1] in ("conv", "bn"):
                parts[i + 1] = "0" if parts[i + 1] == "conv" else "1"
        if parts[-1] == "num_batches_tracked":
            value = value.astype(np.int64)
        out[".".join(parts)] = value

    for key in list(out):
        if key.endswith(".Linear_weight"):
            prefix = key[: -len("Linear_weight")]
            cin, cout = out[key].shape
            v = out[prefix + "Feature_Mask"].shape[1]
            out[prefix + "shift_in"] = flat_shift_index(v, cin, +1)
            out[prefix + "shift_out"] = flat_shift_index(v, cout, -1)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def stream_state_dicts_from_arrays(
    params4: Mapping[str, Any], bn_state4: Mapping[str, Any],
    streams: Sequence[str],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference package's four-stream (params, bn_state), every leaf
    stacked on axis 0 in ``streams`` order, as numpy -> {stream:
    state_dict} through ``state_dict_from_arrays``."""
    def take(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    return {stream: state_dict_from_arrays(take(params4, i),
                                           take(bn_state4, i))
            for i, stream in enumerate(streams)}


def _stream_entries(blob: Any) -> Dict[str, Dict[str, Any]]:
    """The per-stream resume dicts of a four-stream checkpoint ({} for any
    other file)."""
    if not isinstance(blob, dict):
        return {}
    return {k: v for k, v in blob.items()
            if isinstance(v, dict) and "model_state_dict" in v}


def load_reference_checkpoint(
    path: str,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Load a reference ``.pt`` / ``.pkl`` checkpoint.

    Returns (state_dict on the CPU, meta).  ``meta`` holds epoch /
    global_step / best_acc when the file is the full resume dict.  A
    ``DataParallel`` ``module.`` prefix is stripped.  ``.pkl`` files are
    unpickled: load only files from a trusted source.
    """
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            blob = pickle.load(f)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if _stream_entries(blob):
        raise ValueError(
            f"{path} is a four-stream checkpoint: read it with "
            "load_fourstream_checkpoint or "
            "EnsemblePredictor.from_fourstream_checkpoint")
    meta: Dict[str, Any] = {}
    if isinstance(blob, dict) and "model_state_dict" in blob:
        meta = {k: blob[k] for k in ("epoch", "global_step", "best_acc")
                if k in blob}
        blob = blob["model_state_dict"]
    state_dict = {
        k.split("module.")[-1]: torch.as_tensor(np.asarray(v))
        if not torch.is_tensor(v) else v.detach().cpu()
        for k, v in blob.items()
    }
    return state_dict, meta


_CHECKPOINT_NAME = re.compile(r"(?P<name>.+)-(?P<epoch>\d+)-(?P<step>\d+)\.pt")


def resume_entry(model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """{model_state_dict (on the CPU), optimizer_state_dict}."""
    return {"model_state_dict": {k: v.detach().cpu()
                                 for k, v in model.state_dict().items()},
            "optimizer_state_dict": optimizer.state_dict()}


def checkpoint_path(save_dir: str, experiment: str, epoch: int,
                    global_step: int) -> str:
    """Where the checkpoint of (epoch, global_step) is written."""
    return os.path.join(save_dir, f"{experiment}-{epoch}-{global_step}.pt")


def write_checkpoint(save_dir: str, experiment: str, epoch: int,
                     global_step: int, best_acc: float,
                     blob: Dict[str, Any]) -> str:
    """``torch.save`` of ``blob`` with epoch, global_step and best_acc
    beside its entries; returns the path.

    The file is written whole or not at all: ``torch.save`` writes a
    temporary file in ``save_dir`` (``.<name>.<random>.tmp``, which
    ``latest_checkpoint`` never matches), flushed and fsynced, and
    ``os.replace`` renames it onto the final name.  A process killed
    during a save leaves at most that temporary file, so ``resume:
    auto`` finds the previous checkpoint, as the reference package's
    Orbax saves (a temporary directory renamed on commit) do."""
    os.makedirs(save_dir, exist_ok=True)
    path = checkpoint_path(save_dir, experiment, epoch, global_step)
    tmp = os.path.join(save_dir, f".{os.path.basename(path)}."
                                 f"{secrets.token_hex(4)}.tmp")
    try:
        with open(tmp, "xb") as f:
            torch.save(dict(blob, epoch=epoch, global_step=global_step,
                            best_acc=best_acc), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def save_checkpoint(save_dir: str, experiment: str, epoch: int,
                    global_step: int, best_acc: float,
                    model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> str:
    """Write the reference resume dict; returns its path."""
    return write_checkpoint(save_dir, experiment, epoch, global_step,
                            best_acc, resume_entry(model, optimizer))


def save_fourstream_checkpoint(
        save_dir: str, experiment: str, epoch: int, global_step: int,
        best_acc: float, models: Mapping[str, torch.nn.Module],
        optimizers: Mapping[str, torch.optim.Optimizer]) -> str:
    """Write one resume dict per stream, under the stream's name, in one
    file; returns its path."""
    return write_checkpoint(
        save_dir, experiment, epoch, global_step, best_acc,
        {stream: resume_entry(model, optimizers[stream])
         for stream, model in models.items()})


def load_fourstream_checkpoint(
    path: str,
) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
    """A four-stream checkpoint -> ({stream: {model_state_dict,
    optimizer_state_dict}} on the CPU, meta).  Raises ValueError for any
    other file, a single-stream checkpoint included."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    streams = _stream_entries(blob)
    if not streams:
        raise ValueError(
            f"{path} is not a four-stream checkpoint (one model_state_dict "
            "per stream): a four-stream run takes a four-stream checkpoint")
    meta = {k: blob[k] for k in ("epoch", "global_step", "best_acc")
            if k in blob}
    return streams, meta


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The checkpoint of the highest (epoch, global_step) in save_dir,
    the reference's max-epoch auto-detect (inference_pipeline.py:28-38)."""
    if not os.path.isdir(save_dir):
        return None
    found = []
    for name in os.listdir(save_dir):
        m = _CHECKPOINT_NAME.fullmatch(name)
        if m:
            found.append((int(m["epoch"]), int(m["step"]), name))
    if not found:
        return None
    return os.path.join(save_dir, max(found)[2])
