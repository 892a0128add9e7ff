"""Experiment configuration: YAML + CLI with reference-compatible keys.

Priority: CLI > YAML > defaults, with unknown-key validation (``WRONG
ARG``) — the reference argparse/YAML merge (main.py:34-169, 566-579).
The key set is the reference package's, so every YAML it reads parses
here to the same values; only the default ``feeder`` and ``model``
strings name this package's modules.

Keys this port cannot honor yet raise in ``check_supported`` (called by
``load_config`` and the ``Trainer``), naming the key and its ROADMAP
item.  ``fourstream``, ``native_loader`` and ``device_guard`` are read by
the Trainer.  Keys that only tune the reference package's compiler or
device (``sync_bn``, ``donate_state``, ``remat``, ``use_pallas``,
``profile_dir``, ``profile_steps``, ``debug_nans``, ``num_worker``,
``edge_strategy``) and the reference's ``device`` GPU ids change no
result here and are read by nothing; ``optimizer``,
``nesterov`` and ``weight_decay`` are read by nothing either: the SGD is
always nesterov with momentum 0.9 and the per-parameter weight-decay
table (``train/optim.py``), as in the reference package's trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, List, Optional

import yaml

# model strings that name the Shift-GCN family (the reference's dotted path
# and the short family name)
SHIFT_GCN_MODELS = ("shift_gcn_torch.models.shift_gcn", "shift_gcn",
                    "model.shift_gcn.Model")


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
    compute_dtype: Optional[str] = None     # matmul-input dtype (refused)
    activation_dtype: Optional[str] = None  # e.g. bfloat16 backbone
                                            # activations (BN stats fp32)
    transfer_dtype: str = "auto"            # batch dtype on its way to the
                                            # device: 'auto' (bfloat16 when
                                            # activation_dtype is bfloat16,
                                            # else float32), 'bfloat16' or
                                            # 'float32'; cast back to fp32
                                            # on the device
    mesh_shape: Optional[List[int]] = None  # (refused)
    shard_time: bool = False                # (refused)
    edge_partition: bool = False            # (refused)
    edge_strategy: str = "gather"
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
        default_factory=dict)               # (refused when non-empty)
    device_guard: bool = True

    def resolved_work_dir(self) -> str:
        return os.path.join(self.work_dir, self.Experiment_name)

    def resolved_save_dir(self) -> str:
        return os.path.join(self.model_saved_name, self.Experiment_name)


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise ValueError naming the first key this port cannot honor yet
    and the ROADMAP item that will."""
    refused = (
        ("mesh_shape", cfg.mesh_shape, "A13 (parallel modes)"),
        ("shard_time", cfg.shard_time, "A13 (parallel modes)"),
        ("edge_partition", cfg.edge_partition, "A13 (parallel modes)"),
        ("lowering", cfg.lowering or cfg.model_args.get("lowering"),
         "A11 (lowering knobs)"),
        ("compute_dtype", cfg.compute_dtype, "A11 (lowering knobs)"),
        ("model", cfg.model not in SHIFT_GCN_MODELS,
         "A12 (other families)"),
    )
    for key, value, item in refused:
        if value:
            raise ValueError(
                f"config key {key!r} ({getattr(cfg, key)!r}) is not "
                f"supported by shift_gcn_torch yet: ROADMAP {item}")


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
        if isinstance(current, list):
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
