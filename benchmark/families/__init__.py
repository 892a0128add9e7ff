"""Model families: what the benchmark knows of one architecture.

A configuration names its family by a top-level ``"family"`` key; without
one it is ``shift_gcn``.  The family is ``families/<family>.py``, found
by that name, and gives:

- ``MODEL``: the name in the port's model registry of the model that the
  Trainer builds (the train driver sets ``ExperimentConfig.model`` to it);
- ``leaves(config)``: the model's state-dict entries as ``(name, shape,
  kind, scale)``, which ``weights.make`` draws from the seed;
- ``forward(weights, x, config, training, prec)``: the plain reference,
  plain PyTorch in float32 (TF32 off), importing nothing of the port or
  of JAX;
- ``forward_macs(config)``: one clip's forward multiply-adds, for MFU;
- ``ops(config, clips, itemsize, training)``: ``(op, bytes, flops)`` of
  the port-kernel ops that the roofline counts, empty where the family
  runs none (``metrics/kernel_names/*.json`` matches ops to kernels);
- optionally ``fill(kind, shape, config)``: a leaf of a kind that
  ``weights.make`` does not draw itself, as a numpy array.

A new architecture is a new file here and configurations that name it.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
DEFAULT = "shift_gcn"


def name(config: dict) -> str:
    return config.get("family", DEFAULT)


def known(directory: Path = HERE) -> List[str]:
    return sorted(p.stem for p in Path(directory).glob("*.py")
                  if not p.stem.startswith("_"))


def check(config: dict, directory: Path = HERE) -> str:
    """The configuration's family, or KeyError naming it and the known
    ones where ``directory`` holds no such file."""
    family = name(config)
    if family not in known(directory):
        raise KeyError(f"model family {family!r} has no file "
                       f"benchmark/families/{family}.py; known families: "
                       f"{known(directory)}")
    return family


def of(config: dict):
    """The module of the configuration's family."""
    return importlib.import_module(f"{__name__}.{check(config)}")
