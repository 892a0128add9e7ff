"""Train a Shift-GCN model with the port.

    python -m shift_gcn_torch.cli.train --config <yaml> [--key value ...]
        [--torch-device cpu]

``--key value`` overrides any config key (CLI > YAML > defaults).  The
run goes to the GPU; ``--torch-device cpu`` runs the kernels' plain
PyTorch versions on the CPU instead.  (The config key ``device`` keeps
its reference meaning, a list of GPU ids, and is not read.)
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from shift_gcn_torch.train.config import load_config
from shift_gcn_torch.train.trainer import Trainer


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to train on (default cuda)")
    known, rest = ap.parse_known_args(argv)
    return Trainer(load_config(rest), device=known.torch_device).start()


if __name__ == "__main__":
    main()
