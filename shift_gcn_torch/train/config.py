"""Experiment configuration: YAML + CLI with reference-compatible keys.

Priority: CLI > YAML > defaults, with unknown-key validation (``WRONG
ARG``) — the reference argparse/YAML merge (main.py:34-169, 566-579).
The key set is the reference package's, so every YAML it reads parses
here to the same values; only the default ``feeder`` and ``model``
strings name this package's modules.  ``model`` names a family of
``models/registry.py`` (the reference's names and aliases resolve).

The parallel modes run one process per GPU (``parallel/``): data
parallelism, ``mesh_shape: [D, 1]`` (or none: every rank on 'data'),
sequence parallelism, ``mesh_shape: [D, M]`` with ``shard_time``,
tensor parallelism, ``mesh_shape: [D, M]`` with M > 1 and no
``shard_time`` (``parallel/tensor.py``), and the edge partition,
``edge_partition`` over ``mesh_shape: [D, M]`` with M >= 2 and
``edge_strategy`` ``gather`` (ST-GCN) or ``ring`` (ring-GNN)
(``parallel/edge_partition.py``).  Layouts that cannot run raise in
``check_supported`` (called by ``load_config`` and the ``Trainer``;
``parallel.mesh.make_mesh`` holds D * M to the world size) with the
reference trainer's errors.  ``fourstream``, ``native_loader``,
``device_guard``, ``lowering`` (merged over ``model_args.lowering``,
``ops/lowering.py``), ``compute_dtype``, ``activation_dtype``,
``remat`` (per-unit recomputation in the backward), ``profile_dir`` /
``profile_steps`` (a ``torch.profiler`` trace of the first steps) and
``debug_nans`` are read by the Trainer.  Keys that only tune the
reference package's compiler or device (``sync_bn``: BN is always
synchronized over the ranks, as the reference's jit makes it global;
``donate_state``, ``use_pallas``, ``num_worker``) and the reference's
``device`` GPU ids change no result here and are read by nothing;
``optimizer``, ``nesterov`` and ``weight_decay`` are read by nothing
either: the SGD is always nesterov with momentum 0.9 and the
per-parameter weight-decay table (``train/optim.py``), as in the
reference package's trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, List, Optional

import yaml


@dataclasses.dataclass
class ExperimentConfig:
    # bookkeeping
    Experiment_name: str = "temp"
    work_dir: str = "./work_dir"
    model_saved_name: str = "./save_models"
    config: Optional[str] = None
    phase: str = "train"              # train | test
    save_score: bool = False
    seed: int = 1
    log_interval: int = 100
    save_interval: int = 2
    eval_interval: int = 5
    print_log: bool = True
    show_topk: List[int] = dataclasses.field(default_factory=lambda: [1, 5])

    # feeder
    feeder: str = "shift_gcn_torch.data.feeder.Feeder"
    num_worker: int = 2
    train_feeder_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    test_feeder_args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # model
    model: str = "shift_gcn_torch.models.shift_gcn"
    model_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    weights: Optional[str] = None
    ignore_weights: List[str] = dataclasses.field(default_factory=list)

    # optim
    base_lr: float = 0.01
    step: List[int] = dataclasses.field(default_factory=lambda: [20, 40, 60])
    device: List[int] = dataclasses.field(default_factory=lambda: [0])
    optimizer: str = "SGD"
    nesterov: bool = False
    batch_size: int = 256
    test_batch_size: int = 256
    start_epoch: int = 0
    num_epoch: int = 80
    weight_decay: float = 0.0005
    resume: Optional[str] = None
    only_train_part: bool = True
    only_train_epoch: int = 0
    warm_up_epoch: int = 0
    overwrite: bool = False

    # additions of the reference package
    compute_dtype: Optional[str] = None     # 1x1-conv matmul-input dtype
    activation_dtype: Optional[str] = None  # e.g. bfloat16 backbone
                                            # activations (BN stats fp32)
    transfer_dtype: str = "auto"            # batch dtype on its way to the
                                            # device: 'auto' (bfloat16 when
                                            # activation_dtype is bfloat16,
                                            # else float32), 'bfloat16' or
                                            # 'float32'; cast back to fp32
                                            # on the device
    mesh_shape: Optional[List[int]] = None  # [D, M]: data x time ranks
    shard_time: bool = False                # T over the M 'model' ranks
    edge_partition: bool = False            # edges over the M 'model'
                                            # ranks
    edge_strategy: str = "gather"           # 'gather' or 'ring'
    sync_bn: bool = True
    donate_state: bool = True
    remat: bool = False
    use_pallas: bool = False
    native_loader: bool = False             # gather through the native
                                            # loader; raises if it cannot
                                            # be built
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    debug_nans: bool = False
    fourstream: bool = False                # train the four modality
                                            # streams in one run
    lowering: Dict[str, Any] = dataclasses.field(
        default_factory=dict)               # lowering knobs; the Trainer
                                            # writes the resolved dict
    device_guard: bool = True

    def resolved_work_dir(self) -> str:
        return os.path.join(self.work_dir, self.Experiment_name)

    def resolved_save_dir(self) -> str:
        return os.path.join(self.model_saved_name, self.Experiment_name)


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise ValueError for a parallel layout that cannot run:
    ``shard_time`` without M >= 2 time ranks or with ``fourstream``,
    tensor parallelism over M ranks that do not divide an output width
    of the model, or an edge partition the reference trainer refuses
    (``check_edge_partition``).  (``parallel.mesh.make_mesh`` holds
    D * M to the world size.)"""
    # --mesh_shape with no value clears the mesh
    mesh = [int(a) for a in cfg.mesh_shape or []] or None
    if mesh is not None:
        if len(mesh) != 2 or min(mesh) < 1:
            raise ValueError(f"mesh_shape {mesh!r}: expected [data, model] "
                             "with both >= 1")
        # under the edge partition the model ranks hold edges, not channels
        if mesh[1] > 1 and not cfg.shard_time and not cfg.edge_partition:
            from shift_gcn_torch.parallel import tensor

            try:
                tensor.check_config(cfg.model, cfg.model_args, mesh[1])
            except ValueError as err:
                raise ValueError(f"config key 'mesh_shape' ({mesh!r}): "
                                 f"{err}") from None
    if cfg.shard_time:
        if mesh is None or mesh[1] < 2:
            raise ValueError(
                "config key 'shard_time' needs mesh_shape [data, model] "
                "with model >= 2 (the 'model' ranks hold the T shards)")
        if cfg.fourstream:
            raise ValueError("config key 'shard_time' is not supported with "
                             "fourstream, as in the reference trainer")
    if cfg.edge_partition:
        check_edge_partition(cfg, mesh)


def check_edge_partition(cfg: ExperimentConfig, mesh) -> None:
    """The reference trainer's refusals of ``edge_partition``
    (trainer.py:220-284): with ``fourstream`` or ``shard_time``, without
    M >= 2 model ranks to carry the edge shards, ``ring`` for a family
    without node shards, ``gather`` for one without an edge path, and an
    unknown ``edge_strategy``."""
    from shift_gcn_torch.models.registry import get_model

    for key in ("fourstream", "shard_time"):
        if getattr(cfg, key):
            raise ValueError(
                f"edge_partition is not supported with {key} (docs/"
                "DESIGN.md, composition boundaries)")
    if mesh is None or mesh[1] < 2:
        raise ValueError(
            "edge_partition needs mesh_shape [data, model] with model >= 2 "
            "(the 'model' axis carries the edge shards)")
    strategies = get_model(cfg.model).edge_strategies
    if cfg.edge_strategy == "ring":
        if "ring" not in strategies:
            raise ValueError(
                f"edge_strategy='ring' is not supported by model family "
                f"{cfg.model!r} (it takes no node shards).  Ring "
                "node-sharding is for graphs too large to replicate: use "
                "the ring_gnn family (configs/synthetic_ring.yaml); "
                "skeleton graphs (V<=33) train with edge_strategy='gather' "
                "(docs/DESIGN.md)")
    elif cfg.edge_strategy == "gather":
        if "gather" not in strategies:
            raise ValueError(
                f"edge_partition is not supported by model family "
                f"{cfg.model!r} (it has no path over partitioned edges; "
                "the stgcn family has)")
    else:
        raise ValueError(f"unknown edge_strategy={cfg.edge_strategy!r} "
                         "(expected 'gather' or 'ring')")


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("yes", "true", "t", "y", "1")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def load_config(argv: Optional[List[str]] = None) -> ExperimentConfig:
    """Parse CLI + YAML into an ExperimentConfig (CLI wins over YAML);
    raises on unknown keys and on keys the port cannot honor."""
    parser = argparse.ArgumentParser(
        description="shift_gcn_torch trainer")
    parser.add_argument("--config", default=None)
    known, overrides = parser.parse_known_args(argv)

    cfg = ExperimentConfig()
    valid_keys = {f.name for f in dataclasses.fields(ExperimentConfig)}
    list_keys = {f.name for f in dataclasses.fields(ExperimentConfig)
                 if "List" in str(f.type)}

    if known.config:
        with open(known.config) as f:
            yaml_args = yaml.safe_load(f) or {}
        for k, v in yaml_args.items():
            if k not in valid_keys:
                raise KeyError(f"WRONG ARG in {known.config}: {k}")
            setattr(cfg, k, v)
        cfg.config = known.config

    # CLI overrides: --key value (underscores or dashes)
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected CLI token: {tok}")
        key = tok[2:].replace("-", "_")
        if key not in valid_keys:
            raise KeyError(f"WRONG ARG: {key}")
        current = getattr(cfg, key)
        # a list key unset in the YAML (mesh_shape) takes a list too
        if isinstance(current, list) or (current is None
                                         and key in list_keys):
            vals = []
            i += 1
            while i < len(overrides) and not overrides[i].startswith("--"):
                vals.append(overrides[i])
                i += 1
            elem = current[0] if current else 0
            setattr(cfg, key, [_coerce(v, elem) for v in vals])
            continue
        if isinstance(current, dict):
            i += 1
            setattr(cfg, key, yaml.safe_load(overrides[i]))
            i += 1
            continue
        i += 1
        value = overrides[i]
        i += 1
        if current is None:
            setattr(cfg, key, value)
        else:
            setattr(cfg, key, _coerce(value, current))
    check_supported(cfg)
    return cfg


def save_config(cfg: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
